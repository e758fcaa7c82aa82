"""Synthetic data generators for hermetic pipeline tests."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.genome import Genome

BASES = np.array(list("ACGT"))


def random_genome(rng, sizes: Dict[str, int]) -> Dict[str, str]:
    """Random DNA per chromosome."""
    return {c: "".join(rng.choice(BASES, size=l)) for c, l in sizes.items()}


def write_genome_size(path: str, sizes: Dict[str, int]) -> str:
    g = Genome(sizes, ())
    g.write(path)
    return path


def random_contacts(rng, genome: Genome, n: int, intra_frac: float = 0.8):
    """(c1, p1, c2, p2) arrays of plausible contacts (positions in bp)."""
    labels = genome.labels
    c1 = rng.integers(0, len(labels), n).astype(np.int32)
    intra = rng.random(n) < intra_frac
    c2 = np.where(intra, c1, rng.integers(0, len(labels), n)).astype(np.int32)
    sizes = np.array([genome.sizes[c] for c in labels])
    p1 = (rng.random(n) * (sizes[c1] - 1)).astype(np.int64) + 1
    # intra contacts decay with distance
    span = (rng.exponential(0.05, n) * sizes[c1]).astype(np.int64)
    p2_intra = np.clip(p1 + np.where(rng.random(n) < 0.5, -span, span),
                       1, sizes[c1] - 1)
    p2_rand = (rng.random(n) * (sizes[c2] - 1)).astype(np.int64) + 1
    p2 = np.where(intra, p2_intra, p2_rand)
    return c1, p1, c2, p2


def write_valid_bed(path: str, genome: Genome, c1, p1, c2, p2, rng) -> str:
    """23ish-column valid bed with the fields matrix-building consumes."""
    labels = genome.labels
    with open(path, "w") as f:
        for i in range(len(c1)):
            name = f"read{i}"
            cols = [
                name, labels[c1[i]], "0", str(int(p1[i])), "100", "-10",
                str(int(p1[i])), "0",
                labels[c2[i]], "16", str(int(p2[i])), "100", "-12",
                str(int(p2[i])), "0",
            ]
            f.write("\t".join(cols) + "\n")
    return path


def diploid_dataset(rng, out_dir: str,
                    chrom_sizes: Dict[str, int] | None = None,
                    n_pairs: int = 400, n_snps: int = 60,
                    read_len: int = 40, enzyme: str = "MboI",
                    junction_frac: float = 0.15) -> Dict[str, str]:
    """A complete hermetic diploid dataset: reference FASTA, phased-SNP TXT,
    and paired FASTQs sampled from the *maternal* genome (so SNP-spanning
    reads only exact-match the maternal haplotype), with a fraction of
    junction-containing chimeric reads to exercise the rescue path."""
    from ..pipeline.enzyme import enzyme_handle, junction_info

    os.makedirs(out_dir, exist_ok=True)
    chrom_sizes = chrom_sizes or {"1": 30_000, "2": 20_000}
    ref = random_genome(rng, chrom_sizes)

    # SNPs: maternal allele == reference base, paternal differs.
    snp_lines = []
    for _ in range(n_snps):
        c = str(rng.choice(list(chrom_sizes)))
        pos = int(rng.integers(read_len + 1, chrom_sizes[c] - read_len))
        base = ref[c][pos - 1]
        alt = str(rng.choice([b for b in "ACGT" if b != base]))
        snp_lines.append(f"{c}\t{pos}\t{base}\t{base}\t{alt}")
    snp_file = os.path.join(out_dir, "snps.txt")
    with open(snp_file, "w") as f:
        f.write("\n".join(snp_lines) + "\n")

    fasta = os.path.join(out_dir, "genome.fa")
    with open(fasta, "w") as f:
        for c in sorted(ref):
            f.write(f">chr{c}\n")
            s = ref[c]
            for i in range(0, len(s), 60):
                f.write(s[i : i + 60] + "\n")

    site, cutsite = enzyme_handle(enzyme)
    jplus, _, _ = junction_info(site, cutsite)
    comp = str.maketrans("ACGT", "TGCA")

    r1_path = os.path.join(out_dir, "cell_R1_1.fastq")
    r2_path = os.path.join(out_dir, "cell_R1_2.fastq")
    with open(r1_path, "w") as f1, open(r2_path, "w") as f2:
        for i in range(n_pairs):
            c = str(rng.choice(list(chrom_sizes)))
            L = chrom_sizes[c]
            p1 = int(rng.integers(0, L - read_len))
            p2 = int(rng.integers(0, L - read_len))
            s1 = ref[c][p1 : p1 + read_len]
            s2 = ref[c][p2 : p2 + read_len].translate(comp)[::-1]
            if rng.random() < junction_frac:
                # chimeric R1: 18 bp + junction + 18 bp from elsewhere
                p3 = int(rng.integers(0, L - read_len))
                s1 = (ref[c][p1 : p1 + 18] + jplus
                      + ref[c][p3 : p3 + 18])
                s1 = s1[:read_len] if len(s1) > read_len else s1
            q1 = "I" * len(s1)
            q2 = "I" * len(s2)
            f1.write(f"@pair{i}\n{s1}\n+\n{q1}\n")
            f2.write(f"@pair{i}\n{s2}\n+\n{q2}\n")
    return {"fasta": fasta, "snps": snp_file, "fq1": r1_path, "fq2": r2_path,
            "sizes": chrom_sizes}


def write_allelic_beds(dirpath: str, prefix: str, genome: Genome, rng,
                       n: int = 3000) -> Dict[str, str]:
    """Write the five allelic bed classes with plausible tags."""
    os.makedirs(dirpath, exist_ok=True)
    labels = genome.labels
    out = {}
    for kind, frac, tagged in (
        ("Bi_Allelic", 1.0, False), ("M_M", 0.5, True), ("P_P", 0.5, True),
        ("M_P", 0.05, False), ("P_M", 0.05, False),
    ):
        m = max(10, int(n * frac))
        c1, p1, c2, p2 = random_contacts(rng, genome, m)
        path = os.path.join(dirpath, f"{prefix}Valid_{kind}.bed")
        with open(path, "w") as f:
            for i in range(m):
                cols = [labels[c1[i]], str(int(p1[i])),
                        labels[c2[i]], str(int(p2[i]))]
                if tagged:
                    cols.append(rng.choice(["Both", "Both", "R1", "R2"]))
                f.write("\t".join(cols) + "\n")
        out[kind] = path
    return out


# ------------------------------------------------ bulk generation (numpy)
# hg19 / GRCh37 chromosome lengths, chr1..22 + X (the reference's default
# chroms ['#', 'X'], scripts/hichap:423-427)
HG19 = {**{str(i + 1): n for i, n in enumerate((
    249250621, 243199373, 198022430, 191154276, 180915260, 171115067,
    159138663, 146364022, 141213431, 135534747, 135006516, 133851895,
    115169878, 107349540, 102531392, 90354753, 81195210, 78077248,
    59128983, 63025520, 48129895, 51304566))}, "X": 155270560}


def power_law_pairs(rng, sizes: np.ndarray, n: int, intra_frac: float = 0.75,
                    dmin: float = 1e3, dmax: float = 5e6):
    """(c1, p1, c2, p2) for ``n`` contacts over chromosomes of ``sizes``
    (bp), chosen in proportion to length: ``intra_frac`` intra-chromosomal
    with log-uniform (power-law) distances in [dmin, dmax], the rest
    inter-chromosomal and uniform."""
    sizes = np.asarray(sizes, np.int64)
    w = sizes / sizes.sum()
    c1 = rng.choice(len(sizes), n, p=w).astype(np.int32)
    p1 = (rng.random(n) * (sizes[c1] - 1)).astype(np.int64) + 1
    intra = rng.random(n) < intra_frac
    c2 = np.where(intra, c1, rng.choice(len(sizes), n, p=w)).astype(np.int32)
    d = np.exp(rng.uniform(np.log(dmin), np.log(dmax), n)).astype(np.int64)
    p2_intra = np.clip(p1 + np.where(rng.random(n) < 0.5, d, -d),
                       1, sizes[c1] - 1)
    p2_inter = (rng.random(n) * (sizes[c2] - 1)).astype(np.int64) + 1
    return c1, p1, c2, np.where(intra, p2_intra, p2_inter)


def _int_field(a):
    """Decimal text of an int array as (chars [n, W] uint8, keep mask)."""
    a = np.asarray(a, np.int64)
    v = np.abs(a)
    W = len(str(int(v.max()))) if v.size else 1
    digits = (v[:, None] // 10 ** np.arange(W - 1, -1, -1)) % 10
    nd = 1 + (v[:, None] >= 10 ** np.arange(1, W)).sum(1)
    keep = np.arange(W)[None, :] >= (W - nd)[:, None]
    chars = (digits + ord("0")).astype(np.uint8)
    if (a < 0).any():
        chars = np.concatenate([np.full((a.size, 1), ord("-"), np.uint8),
                                chars], 1)
        keep = np.concatenate([(a < 0)[:, None], keep], 1)
    return chars, keep


def _label_field(idx, table: Sequence[str]):
    """Text of ``table[idx]`` per row as (chars, keep mask)."""
    enc = [t.encode() for t in table]
    L = max(len(t) for t in enc)
    chars = np.zeros((len(enc), L), np.uint8)
    keep = np.zeros((len(enc), L), bool)
    for i, t in enumerate(enc):
        chars[i, :len(t)] = np.frombuffer(t, np.uint8)
        keep[i, :len(t)] = True
    idx = np.asarray(idx)
    return chars[idx], keep[idx]


def tsv_bytes(n: int, fields) -> bytes:
    """Tab-separated text of ``n`` rows without a per-row Python loop.

    Each field is a ``bytes`` constant, an int array, or a
    ``(index array, labels)`` pair."""
    parts = []
    for k, f in enumerate(fields):
        if isinstance(f, bytes):
            c = np.broadcast_to(np.frombuffer(f, np.uint8), (n, len(f)))
            parts.append((c, np.ones(c.shape, bool)))
        elif isinstance(f, tuple):
            parts.append(_label_field(*f))
        else:
            parts.append(_int_field(f))
        sep = b"\n" if k == len(fields) - 1 else b"\t"
        parts.append((np.full((n, 1), sep[0], np.uint8), np.ones((n, 1), bool)))
    chars = np.concatenate([p[0] for p in parts], 1)
    keep = np.concatenate([p[1] for p in parts], 1)
    return chars[keep].tobytes()


def write_valid_bed_bulk(path: str, labels: Sequence[str], c1, p1, c2, p2,
                         chunk: int = 1 << 20) -> str:
    """15-column valid bed (the filtering stage's output layout) written in
    chunks of vectorized text."""
    with open(path, "wb") as f:
        for s in range(0, len(c1), chunk):
            sl = slice(s, s + chunk)
            m = len(c1[sl])
            f.write(tsv_bytes(m, [
                b"r", (c1[sl], labels), b"0", p1[sl], b"100", b"-10",
                p1[sl], b"0", (c2[sl], labels), b"16", p2[sl], b"100",
                b"-12", p2[sl], b"0"]))
    return path


def write_allelic_bed_bulk(path: str, labels: Sequence[str], c1, p1, c2, p2,
                           tags=None, chunk: int = 1 << 20) -> str:
    """Allelic bed ``chrom1 pos1 chrom2 pos2 [tag]``; ``tags`` index into
    ("Both", "R1", "R2")."""
    with open(path, "wb") as f:
        for s in range(0, len(c1), chunk):
            sl = slice(s, s + chunk)
            fields = [(c1[sl], labels), p1[sl], (c2[sl], labels), p2[sl]]
            if tags is not None:
                fields.append((tags[sl], ("Both", "R1", "R2")))
            f.write(tsv_bytes(len(c1[sl]), fields))
    return path


def escalation_case(rng, n, B, ww, maxww, pw, npix, dense_reads=False):
    """Synthetic packed-band inputs for the loop escalation ladder
    (ops/loops_packed): ``(args, static kwargs)``.  The default value mix
    is bimodal — strong rows resolve early, weak rows late or never — so
    the <10% stopping rule actually truncates the ladder."""
    import jax.numpy as jnp

    from ..ops.loops_packed import pack_coo, pack_margins

    e_lo, _e_hi, x_pad = pack_margins(maxww)
    Xp = n + 2 * x_pad + 7  # deliberately unaligned
    nnz = 4 * n
    rows = rng.integers(0, n, nnz)
    offs = rng.integers(0, B, nnz)
    cols = np.minimum(rows + offs, n - 1)
    if dense_reads:
        vals = rng.poisson(30.0, nnz).astype(np.float32)
    else:
        strong = rows % 5 == 0
        vals = rng.poisson(np.where(strong, 9.0, 1.2), nnz).astype(
            np.float32)
    r, c = jnp.asarray(rows), jnp.asarray(cols)
    D_raw = pack_coo(r, c, jnp.asarray(vals), B, Xp, e_lo, x_pad)
    D_bal = pack_coo(r, c, jnp.asarray(vals * 0.37), B, Xp, e_lo, x_pad)
    D_exp = pack_coo(r, c, jnp.asarray(vals * 0.11 + 0.2), B, Xp, e_lo,
                     x_pad)
    e_pix = rng.integers(ww, B - 1, npix).astype(np.int32)
    x_pix = rng.integers(0, n - B, npix).astype(np.int32)
    valid = np.ones(npix, bool)
    valid[::9] = False
    args = (D_raw, D_bal, D_exp, jnp.asarray(e_pix), jnp.asarray(x_pix),
            jnp.asarray(valid))
    return args, dict(ww=ww, maxww=maxww, pw=pw, B=B, e_lo=e_lo,
                      x_pad=x_pad)
