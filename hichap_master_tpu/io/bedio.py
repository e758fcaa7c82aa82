"""Columnar bed-record ingestion.

The reference streams bed lines one at a time through Python string splits
(HiCHap/matrixBuilding.py:567-603).  Here files parse into columnar numpy
arrays (native scanner, plain Python fallback), ready for chunked
binning.

Formats (produced by the filtering layer, see HiCHap/filtering.py:16-47):
  * traditional valid bed — 15 or 23 tab-separated columns; matrix building
    consumes chrom1 (col 1), fragment-mid1 (col 6), chrom2 (col 8),
    fragment-mid2 (col 13) (matrixBuilding.py:575-586);
  * allelic bed — ``chrom1  fragmid1  chrom2  fragmid2  [tag]`` where tag is
    ``Both`` / ``R1`` / ``R2`` for M_M and P_P beds and absent for
    Bi_Allelic / M_P / P_M beds (filtering.py:1127-1234).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.genome import Genome, strip_chr

TAG_BOTH, TAG_R1, TAG_R2 = 0, 1, 2
_TAG_MAP = {"Both": TAG_BOTH, "R1": TAG_R1, "R2": TAG_R2}


def _chrom_index(raw: Sequence[str], label_to_idx: Dict[str, int]) -> np.ndarray:
    """Chromosome labels → registry indices (-1 = unknown), matching the
    reference's tolerance of both ``chr1`` and ``1`` spellings.  The lookup
    runs per distinct label (a few dozen), not per row."""
    if not len(raw):
        return np.zeros(0, np.int32)
    uniq, inv = np.unique(np.asarray(raw, dtype=str), return_inverse=True)
    table = np.asarray(
        [label_to_idx.get(c[3:] if c.startswith("chr") else c, -1)
         for c in uniq.tolist()], np.int32)
    return table[inv.reshape(-1)]


def label_index(genome: Genome) -> Dict[str, int]:
    return {c: i for i, c in enumerate(genome.labels)}


def _split_rows(lines, min_fields: int) -> List[List[str]]:
    """Tab-split non-blank lines; a row short of ``min_fields`` raises
    (the fallback parsers reject malformed rows the native scanner
    drops)."""
    rows = [ln.rstrip("\r\n").split("\t") for ln in lines if ln.strip()]
    if rows and min(map(len, rows)) < min_fields:
        raise ValueError(f"bed row with fewer than {min_fields} columns")
    return rows


def _parse_valid_lines(lines: List[str], idx):
    """Parse one block of valid-bed lines (15 or 23 columns; only columns
    1/6/8/13 are consumed, matrixBuilding.py:575-586)."""
    rows = _split_rows(lines, 14)
    c1 = _chrom_index([r[1] for r in rows], idx)
    c2 = _chrom_index([r[8] for r in rows], idx)
    p1 = np.array([r[6] for r in rows], np.int64)
    p2 = np.array([r[13] for r in rows], np.int64)
    keep = (c1 >= 0) & (c2 >= 0)
    return c1[keep], p1[keep], c2[keep], p2[keep]


def read_valid_bed(paths: Sequence[str], genome: Genome):
    """Concatenate valid-bed files → (c1, p1, c2, p2) filtered to the genome."""
    cols = [[], [], [], []]
    for part in iter_valid_bed(paths, genome):
        for acc, a in zip(cols, part):
            acc.append(a)
    if not cols[0]:
        z = np.zeros(0, np.int32)
        return z, z.astype(np.int64), z.copy(), z.astype(np.int64)
    return tuple(np.concatenate(c) for c in cols)


def read_allelic_bed(paths: Sequence[str], genome: Genome, with_tag: bool):
    """Concatenate allelic-bed files → (c1, p1, c2, p2[, tag]).

    ``genome`` here is the *base* (non-haplotype) registry; labels in the
    files are plain chromosome names.  Thin wrapper over the streaming
    reader — prefer ``iter_allelic_bed`` for production-scale inputs (the
    matrix builder streams; this holds everything at once).
    """
    cols = [[], [], [], [], []]
    width = 5 if with_tag else 4
    for part in iter_allelic_bed(paths, genome, with_tag):
        for acc, a in zip(cols, part):
            acc.append(a)
    if not cols[0]:
        z32 = np.zeros(0, np.int32)
        z64 = np.zeros(0, np.int64)
        out = (z32, z64, z32.copy(), z64.copy())
        return out + (np.zeros(0, np.int8),) if with_tag else out
    return tuple(np.concatenate(c) for c in cols[:width])


def _iter_line_blocks(path: str, read_bytes: int):
    """Complete-line byte blocks of ``path``: read ``read_bytes`` then
    extend to the next newline, so native scanners never see a torn row
    (shared framing for the valid and allelic readers)."""
    with open(path, "rb") as fb:
        while True:
            buf = fb.read(read_bytes)
            if not buf:
                break
            tail = fb.readline()
            if tail:
                buf += tail
            yield buf


def iter_valid_bed(paths: Sequence[str], genome: Genome,
                   read_bytes: int = 1 << 25):
    """Stream (c1, p1, c2, p2) column chunks from valid-bed files without
    loading them into memory (production inputs are tens of GB).

    Blocks parse through the native one-pass scanner
    (``hicio_parse_valid_chunk``) when the C library is available —
    parsing is the host ingestion share — with a plain Python parser as
    fallback (``HICHAP_NATIVE_BED=0`` forces it; the parity test runs both).

    Malformed rows (short, non-numeric or >18-digit positions): the
    native scanner DROPS them — robust continuation on a truncated
    upstream write — while the fallback raises on them.
    Well-formed inputs parse identically (pinned by the parity tests);
    the divergence is only in failure handling."""
    idx = label_index(genome)
    use_native = os.environ.get("HICHAP_NATIVE_BED", "1") != "0"
    for path in paths:
        if os.path.getsize(path) == 0:
            continue
        if use_native:
            from .native import get_lib, parse_valid_chunk

            if get_lib() is not None:  # decide BEFORE yielding any chunk
                for buf in _iter_line_blocks(path, read_bytes):
                    yield parse_valid_chunk(buf, genome.labels)
                continue
        with open(path) as f:
            while True:
                lines = f.readlines(read_bytes)
                if not lines:
                    break
                yield _parse_valid_lines(lines, idx)


# Streaming chunk size (rows) for the allelic readers.  Host memory per
# in-flight chunk is ~40 B/row of columnar arrays plus the parse buffer,
# so the default 2^20 rows bounds the reader at tens of MB no
# matter how large the bed is (the reference streams the same way,
# matrixBuilding.py:1081-1094).  HICHAP_ALLELIC_CHUNK overrides (tests
# force it to single digits to prove chunk-boundary independence).
def _allelic_chunk_rows() -> int:
    return int(os.environ.get("HICHAP_ALLELIC_CHUNK", str(1 << 20)))


def iter_allelic_bed(paths: Sequence[str], genome: Genome, with_tag: bool,
                     chunk_rows: int | None = None):
    """Stream (c1, p1, c2, p2[, tag]) chunks from allelic-bed files with
    bounded host memory.  Blocks parse through the native one-pass
    scanner (``hicio_parse_allelic_chunk``) when the C library is
    available, with a plain Python parser as fallback
    (``HICHAP_NATIVE_BED=0`` forces it; the parity test runs both)."""
    idx = label_index(genome)
    rows_per = chunk_rows or _allelic_chunk_rows()
    if os.environ.get("HICHAP_NATIVE_BED", "1") != "0":
        from .native import get_lib, parse_allelic_chunk

        if get_lib() is not None:  # decide BEFORE yielding any chunk
            read_bytes = max(min(rows_per * 40, 1 << 26), 1 << 16)
            for path in paths:
                if os.path.getsize(path) == 0:
                    continue
                for buf in _iter_line_blocks(path, read_bytes):
                    out = parse_allelic_chunk(buf, genome.labels, with_tag)
                    # honor the chunk_rows contract exactly (tests force
                    # single-digit rows to prove boundary independence)
                    for s in range(0, len(out[0]), rows_per):
                        yield tuple(a[s:s + rows_per] for a in out)
            return
    # with_tag: tag-less (4-column) rows read as tag -1, the native
    # scanner's optional-tag rule
    import itertools

    for path in paths:
        if os.path.getsize(path) == 0:
            continue
        with open(path) as fh:
            while True:
                lines = list(itertools.islice(fh, rows_per))
                if not lines:
                    break
                rows = _split_rows(lines, 4)
                c1 = _chrom_index([r[0] for r in rows], idx)
                c2 = _chrom_index([r[2] for r in rows], idx)
                keep = (c1 >= 0) & (c2 >= 0)
                out = (c1[keep], np.array([r[1] for r in rows], np.int64)[keep],
                       c2[keep], np.array([r[3] for r in rows], np.int64)[keep])
                if with_tag:
                    tag = np.array([_TAG_MAP.get(r[4], -1) if len(r) > 4
                                    else -1 for r in rows], np.int8)
                    yield out + (tag[keep],)
                else:
                    yield out


def discover_allelic_beds(bed_path: str) -> Dict[str, List[str]]:
    """Locate the five allelic bed classes (matrixBuilding.py:1061-1075)."""
    kinds = ["Bi_Allelic", "M_M", "P_P", "M_P", "P_M"]
    out: Dict[str, List[str]] = {k: [] for k in kinds}
    for f in sorted(os.listdir(bed_path)):
        for k in kinds:
            if f.endswith(f"{k}.bed"):
                out[k].append(os.path.join(bed_path, f))
    missing = [k for k, v in out.items() if not v]
    if missing:
        raise FileNotFoundError(
            f"Missing allelic bed class(es) {missing} in {bed_path}"
        )
    return out


def bed_prefix(files: Sequence[str]) -> str:
    """Cell prefix, e.g. ``GM12878_R1_`` from ``GM12878_R1_Valid_M_M.bed``
    (matrixBuilding.py:1065)."""
    base = os.path.basename(sorted(files)[0])
    return base.split("Valid")[0]
