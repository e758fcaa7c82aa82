"""Ligation-junction read rescue.

Spec: HiCHap/fastqPlus.py:67-234.  Unmapped reads are scanned for the
ligation-junction sequence:

  * 0 sites  → dropped (cannot be rescued);
  * 1 site   → split into the two flanks; flanks shorter than MIN_LEN=10 are
    dropped; when both survive the sub-reads are named ``<name>1`` and
    ``<name>2`` (yielding the 4/5/6-read groups the pair resolver handles);
  * ≥2 sites → "confused", dropped.

For non-palindromic junctions the minus-strand junction is searched only
when the plus search found nothing (fastqPlus.py:110-113).
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Optional, Tuple

from ..io.sam import AlnRecord, read_alignments
from ..utils.logging import get_logger
from .enzyme import enzyme_handle, junction_info

log = get_logger(__name__)

MIN_LEN = 10


def split_read(name: str, seq: str, qual: str,
               junc: Tuple[str, str, bool]) -> str:
    """FASTQ text for the rescued sub-read(s); '' when not rescuable."""
    jplus, jminus, palindromic = junc
    if not jplus:
        # e.g. NlaIII (site CATG, cut (4, -4)): the reference's junction
        # formula yields an empty string, and re.finditer('') matches at
        # every offset — every read would silently classify "confused"
        # and the whole Rescue stage would be a no-op
        raise ValueError(
            "empty junction sequence for this enzyme: its cut geometry "
            "leaves no ligation junction to rescue on — skip the Rescue "
            "stage for this enzyme")
    jlen = len(jplus)
    sites = [m.start() for m in re.finditer(jplus, seq)]
    if not palindromic and not sites:
        sites = [m.start() for m in re.finditer(jminus, seq)]
    if len(sites) != 1:
        return ""
    s = sites[0]
    part1, q1 = seq[:s], qual[:s]
    part2, q2 = seq[s + jlen:], qual[s + jlen:]
    if len(part1) < MIN_LEN and len(part2) < MIN_LEN:
        return ""
    if len(part1) < MIN_LEN:
        return f"@{name}\n{part2}\n+\n{q2}\n"
    if len(part2) < MIN_LEN:
        return f"@{name}\n{part1}\n+\n{q1}\n"
    return (f"@{name}1\n{part1}\n+\n{q1}\n"
            f"@{name}2\n{part2}\n+\n{q2}\n")


def rescue_sam(aln_path: str, out_fastq: str,
               junc: Tuple[str, str, bool]) -> int:
    """Extract unmapped reads from one alignment file and write the rescue
    FASTQ.  Returns the number of reads written."""
    n = 0
    with open(out_fastq, "w") as out:
        for rec in read_alignments(aln_path):
            if rec.is_unmapped:
                txt = split_read(rec.query_name, rec.seq, rec.qual, junc)
                if txt:
                    out.write(txt)
                    # 4 lines per FASTQ record ('@' also appears as the
                    # Phred-31 quality character, which inflated counts)
                    n += txt.count("\n") // 4
    return n


def cutting_reads_to_remapping(aln_dir: str, out_dir: str, enzyme: str,
                               allel_mark: str = "NonAllelic",
                               threads: int = 1,
                               suffixes: Tuple[str, ...] = (".sam", ".sam.gz", ".bam"),
                               ) -> List[str]:
    """Rescue every chunk alignment under ``aln_dir``
    (fastqPlus.py:156-234); returns the written FASTQ paths."""
    os.makedirs(out_dir, exist_ok=True)
    site, cutsite = enzyme_handle(enzyme)
    junc = junction_info(site, cutsite)
    if not junc[0]:
        raise ValueError(
            f"enzyme {enzyme!r} leaves no ligation junction (empty junction "
            "sequence) — the Rescue stage cannot apply; run without it")
    if junc[2]:
        log.log(21, "junction sequence is %s", junc[0])
    else:
        log.log(21, "junction plus %s / minus %s", junc[0], junc[1])

    if allel_mark == "NonAllelic":
        files = [f for f in os.listdir(aln_dir) if "chunk" in f
                 and f.endswith(suffixes)]
    else:
        files = [f for f in os.listdir(aln_dir) if allel_mark in f
                 and f.endswith(suffixes)]
    jobs = []
    for f in sorted(files):
        out_name = f
        for suf in suffixes:
            out_name = out_name.removesuffix(suf)
        out_fq = os.path.join(out_dir, out_name + "_unmapped.fq")
        jobs.append((os.path.join(aln_dir, f), out_fq))
    if threads > 1 and len(jobs) > 1:
        # per-chunk process pool like the reference's
        # Cutting_Reads_To_ReMapping (fastqPlus.py:156-234)
        import multiprocessing as mp

        from ..utils.device import host_only_worker

        with mp.get_context("spawn").Pool(
                min(threads, len(jobs)), initializer=host_only_worker) as pool:
            counts = pool.starmap(
                rescue_sam, [(a, o, junc) for a, o in jobs])
    else:
        counts = [rescue_sam(a, o, junc) for a, o in jobs]
    for (a, _o), n in zip(jobs, counts):
        log.log(21, "rescued %d sub-reads from %s", n, os.path.basename(a))
    return [o for _a, o in jobs]
