"""Alignment integration: merge chunk alignments → 23-column bed records.

Spec: HiCHap/bamProcess.py ``Bam_Extract`` (1558-1672) /
``Bam_Extract_Non_Allelic`` (792-861).  Per chunk, the four alignment files
(R1/R2 × global/rescue) merge name-sorted; groups resolve through the case
tree (pipeline/pairs.py); stats (total/unmapped/multi) accumulate exactly
like the reference's reports (bamProcess.py:855-861, 1658-1671).
"""

from __future__ import annotations

import multiprocessing
import os
import re
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple


def _mp_ctx():
    """spawn: fork after jax's threads have started is unsafe; the workers
    run host-side code only (``host_only_worker`` keeps them off the
    accelerator)."""
    return multiprocessing.get_context("spawn")

from ..io.fasta import load_snps
from ..io.sam import read_sam_sorted_by_name
from ..utils.logging import get_logger
from .pairs import MULTI, UNMAPPED, PairResolver, iter_groups, load_fragments

log = get_logger(__name__)


def get_chunks(path: str,
               suffixes=(".sam", ".sam.gz", ".bam")) -> Tuple[List[str], int, str]:
    """Chunk-file discovery (mapping.py:14-36)."""
    reg = re.compile(r"(?<=_chunk)\d+")
    chunks, num = [], -1
    for f in sorted(os.listdir(path)):
        m = reg.search(f)
        if not m or not f.endswith(suffixes):
            continue
        num = max(num, int(m.group(0)))
        chunks.append(f)
    if not chunks:
        raise FileNotFoundError(f"no chunk alignments under {path}")
    cell = chunks[-1].split("_chunk")[0]
    return chunks, num + 1, cell


# per-process caches: each spawn worker runs MANY chunk jobs, and the
# fragment table (~millions of lines) / SNP npz are identical across
# them — the reference loads once in its forked parent
_FRAG_CACHE: Dict[str, object] = {}
_SNP_CACHE: Dict[str, object] = {}


def _cached_fragments(path: str):
    if path not in _FRAG_CACHE:
        _FRAG_CACHE[path] = load_fragments(path)
    return _FRAG_CACHE[path]


def _cached_snps(path: str):
    if path not in _SNP_CACHE:
        _SNP_CACHE[path] = load_snps(path)
    return _SNP_CACHE[path]


def integrate_chunk(aln_files: Sequence[str], out_bed: str, frag_path: str,
                    snp_path: Optional[str], allelic: str, level: int,
                    read_len: int = 150) -> Tuple[int, int, int]:
    """One chunk × one haplotype: resolve pairs, write bed, return stats."""
    frags = _cached_fragments(frag_path)
    snps = _cached_snps(snp_path) if snp_path else None
    resolver = PairResolver(frags, snps, allelic, level, read_len)
    total = unmapped = multi = 0
    with open(out_bed, "w") as out:
        for group in iter_groups(read_sam_sorted_by_name(list(aln_files))):
            total += 1
            res = resolver.resolve(group)
            if res == UNMAPPED or res == "":
                unmapped += 1
            elif res == MULTI:
                multi += 1
            elif isinstance(res, tuple):
                for row in res:
                    out.write("\t".join(row) + "\n")
            else:
                out.write("\t".join(res) + "\n")
    return total, unmapped, multi


def _chunk_files(aln_dir: str, re_dir: str, chunks, rechunks, i: int,
                 tag: str = "") -> List[str]:
    """The four alignment files of chunk i: R1/R2 × global/rescue.  The
    ``_chunk{i}_{mate}`` substring is unambiguous (an underscore follows the
    index)."""
    out = []
    for files, base in ((chunks, aln_dir), (rechunks, re_dir)):
        for mate in ("1", "2"):
            pat = f"_chunk{i}_{mate}"
            cand = [f for f in files if pat in f and (not tag or tag in f)]
            if not cand:
                raise FileNotFoundError(
                    f"missing {pat} ({tag or 'non-allelic'}) under {base}")
            out.append(os.path.join(base, cand[0]))
    return out


def bam_extract(aln_dir: str, re_dir: str, out_dir: str,
                frag_paths: Sequence[str], snp_path: Optional[str],
                threads: int = 1, level: int = 1,
                allelic: bool = True, read_len: int = 150) -> Dict[str, int]:
    """Integrate all chunks.  Allelic mode resolves every chunk against both
    parental genomes (Maternal/Paternal tagged alignment files, separate
    fragment tables); non-allelic uses one genome."""
    os.makedirs(out_dir, exist_ok=True)
    chunks, n_chunks, cell = get_chunks(aln_dir)
    rechunks, _, _ = get_chunks(re_dir)

    jobs = []
    if allelic:
        assert len(frag_paths) == 2, "allelic mode needs M and P fragments"
        for i in range(n_chunks):
            for tag, frag in zip(("Maternal", "Paternal"), frag_paths):
                files = _chunk_files(aln_dir, re_dir, chunks, rechunks, i, tag)
                out_bed = os.path.join(
                    out_dir, f"{cell}_chunk{i}_{tag}.bed")
                jobs.append((files, out_bed, frag, snp_path, tag))
    else:
        for i in range(n_chunks):
            files = _chunk_files(aln_dir, re_dir, chunks, rechunks, i)
            out_bed = os.path.join(out_dir, f"{cell}_chunk{i}.bed")
            jobs.append((files, out_bed, frag_paths[0], None, ""))

    by_tag: Dict[str, List[int]] = {}
    if threads > 1:
        from ..utils.device import host_only_worker

        with ProcessPoolExecutor(threads, mp_context=_mp_ctx(),
                                 initializer=host_only_worker) as ex:
            futs = [(tg, ex.submit(integrate_chunk, f, o, fr, sp, tg, level,
                                   read_len)) for f, o, fr, sp, tg in jobs]
            results = [(tg, fu.result()) for tg, fu in futs]
    else:
        results = [(tg, integrate_chunk(f, o, fr, sp, tg, level, read_len))
                   for f, o, fr, sp, tg in jobs]
    for tg, (t, u, m) in results:
        acc = by_tag.setdefault(tg, [0, 0, 0])
        acc[0] += t; acc[1] += u; acc[2] += m

    def _block(stats):
        return {
            "Total_pairs": stats[0],
            "Unmapped_pairs": stats[1],
            "Multiple_pairs": stats[2],
            "Unique_pairs": stats[0] - stats[1] - stats[2],
        }

    if allelic:
        # per-genome blocks like the reference's separate Maternal /
        # Paternal Mapping Statics (bamProcess.py:1658-1671) — a merged
        # total double-counted every pair (each resolves against BOTH
        # parental genomes)
        report: Dict[str, Dict[str, int]] = {
            tg: _block(st) for tg, st in sorted(by_tag.items())}
        log.log(21, "bamProcess stats: %s", report)
        return report
    report = _block(by_tag.get("", [0, 0, 0]))
    log.log(21, "bamProcess stats: %s", report)
    return report
