"""Hi-C noise filtering and maternal/paternal allelic assignment.

Spec: HiCHap/filtering.py.

``hic_filtering`` (cFiltering parity, filtering.py:126-432): sort all chunk
bed records by (chr1, strand1, pos1, chr2, strand2, pos2), drop consecutive
duplicates, classify self-circle / dangling-end / unknown-mechanism pairs on
the same fragment and extra-dangling-ends (≤500 bp, facing) across
fragments, write ``*_Valid.bed`` + a stats block.  Sorting and
classification are vectorized numpy (lexsort + boolean algebra) instead of
the reference's external merge sort; duplicates compare the six key fields
directly rather than the reference's collision-prone ASCII-sum pair ID
(filtering.py:146-158; see DIVERGENCES.md).

``allelic_filtering`` (aFiltering parity, filtering.py:437-1291): name-sort
the maternal and paternal valid beds, merge-join on pair name, and assign
each pair to Bi_Allelic / M_M / P_P / M_P / P_M with the reference's
per-mate rules (same position ±5 → SNP-count dominance; different position
→ AS-score gap ≥ MAX_DIFF_SCORE plus SNP dominance), candidate-mate
fallback included, emitting the 16-entry statistics dictionary.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger(__name__)

MAX_DIFF_SCORE = 18  # filtering.py:447


# --------------------------------------------------------- HiC filtering
def _classify_block(lines: List[str], prev_key, stats: Dict[str, int],
                    out) -> tuple:
    """Vectorized dedup + SC/DE/UM/ED classification of one sorted block
    (filtering.py:273-354 semantics).  ``prev_key`` is the 6-field key of
    the previous block's last record (dedup across block boundaries);
    returns this block's last key.

    Columns come from one tab split per line; only the key, strand and
    fragment columns are converted (the whole-line ``int`` loop this
    replaces was ~70% of the measured 20M-record stage wall)."""
    rows = [ln.split("\t", 14)[:14] for ln in lines]
    if min(map(len, rows)) < 14:
        raise ValueError("valid bed row with fewer than 14 columns")
    cols = list(zip(*rows))
    c1 = np.array(cols[1], dtype=object)
    s1 = np.array(cols[2], np.int32)
    p1 = np.array(cols[3], np.int64)
    c2 = np.array(cols[8], dtype=object)
    s2 = np.array(cols[9], np.int32)
    p2 = np.array(cols[10], np.int64)
    f1 = np.array(cols[6], np.int64)
    f2 = np.array(cols[13], np.int64)

    n = len(lines)
    stats["Total"] += n
    first = np.ones(n, bool)
    if n > 1:
        same = ((c1[1:] == c1[:-1]) & (s1[1:] == s1[:-1]) & (p1[1:] == p1[:-1])
                & (c2[1:] == c2[:-1]) & (s2[1:] == s2[:-1])
                & (p2[1:] == p2[:-1]))
        first[1:] = ~same
    if prev_key is not None:
        first[0] = (str(c1[0]), int(s1[0]), int(p1[0]),
                    str(c2[0]), int(s2[0]), int(p2[0])) != prev_key
    stats["Duplicates"] += int((~first).sum())

    same_chrom = c1 == c2
    same_frag = same_chrom & (f1 == f2)
    fwd_rev = (s1 == 0) & (s2 == 16)
    rev_fwd = (s1 == 16) & (s2 == 0)
    lt = p1 < p2

    de = same_frag & ((lt & fwd_rev) | (~lt & rev_fwd))
    sc = same_frag & ((lt & rev_fwd) | (~lt & fwd_rev))
    um = same_frag & ~de & ~sc
    ed = (same_chrom & ~same_frag & (np.abs(p1 - p2) <= 500)
          & ((lt & fwd_rev) | (~lt & rev_fwd)))

    stats["SelfCircle"] += int((sc & first).sum())
    stats["DanglingEnds"] += int((de & first).sum())
    stats["UnknownMechanism"] += int((um & first).sum())
    stats["ExtraDanglingEnds"] += int((ed & first).sum())
    valid = first & ~sc & ~de & ~um & ~ed
    stats["Valid"] += int(valid.sum())
    out.writelines(ln for ln, v in zip(lines, valid) if v)
    return (str(c1[-1]), int(s1[-1]), int(p1[-1]),
            str(c2[-1]), int(s2[-1]), int(p2[-1]))


def hic_filtering(bed_dir: str, out_dir: str, allelic: str = "NonAllelic",
                  clean: bool = True,
                  block_lines: Optional[int] = None) -> Dict[str, int]:
    """Duplicate removal + SC/DE/UM/ED classification → ``*_Valid.bed``.

    Bounded-memory streaming: each chunk bed is externally sorted by the
    (chr1, strand1, pos1, chr2, strand2, pos2) key (native hicio sort,
    which spills to disk past its threshold), the sorted runs are k-way
    merged, and classification streams the merged order in blocks of
    ``block_lines`` records with the dedup key carried across block
    boundaries — the reference's external-sort design
    (filtering.py:77-121, 223-267) without its per-line Python loop.
    """
    from ..io.native import merge_sorted, sort_file

    block_lines = block_lines or int(
        os.environ.get("HICHAP_FILTER_BLOCK", 1_000_000))
    os.makedirs(out_dir, exist_ok=True)
    if allelic != "NonAllelic":
        files = [f for f in sorted(os.listdir(bed_dir))
                 if allelic in f and "chunk" in f and f.endswith(".bed")]
    else:
        files = [f for f in sorted(os.listdir(bed_dir))
                 if "chunk" in f and f.endswith(".bed")]
    if not files:
        raise FileNotFoundError(f"no chunk beds under {bed_dir}")
    prefix = files[0].split("chunk")[0]

    stats = dict(Total=0, Duplicates=0, Valid=0, SelfCircle=0,
                 DanglingEnds=0, UnknownMechanism=0, ExtraDanglingEnds=0)
    if allelic != "NonAllelic":
        out_bed = os.path.join(out_dir, f"{prefix}{allelic}_Valid.bed")
    else:
        out_bed = os.path.join(out_dir, f"{prefix}Valid.bed")

    sorted_paths = []
    for f in files:
        dst = os.path.join(out_dir, f + ".ksorted")
        sort_file(os.path.join(bed_dir, f), dst, "hic_key")
        sorted_paths.append(dst)
    merged = os.path.join(out_dir, f"{prefix}{allelic}.ksorted.merged")
    if len(sorted_paths) == 1:
        os.replace(sorted_paths[0], merged)
    else:
        merge_sorted(sorted_paths, merged, "hic_key")
        for p in sorted_paths:
            os.remove(p)

    import itertools

    prev_key = None
    with open(merged) as src, open(out_bed, "w") as out:
        while True:
            lines = list(itertools.islice(src, block_lines))
            if not lines:
                break
            prev_key = _classify_block(lines, prev_key, stats, out)
    os.remove(merged)

    log.log(21, "HiC filtering (%s): %s", allelic, stats)
    if clean:
        for f in files:
            os.remove(os.path.join(bed_dir, f))
    return stats


# ------------------------------------------------------ allelic assignment
def _sub_search(m_c, m_pos, m_score, m_snps, p_c, p_pos, p_score, p_snps):
    """Per-mate allelic decision (filtering.py:552-592)."""
    if m_c == p_c and abs(m_pos - p_pos) <= 5:
        if m_snps > 2 * p_snps:
            return "M"
        if 2 * m_snps < p_snps:
            return "P"
        return "N"
    if (m_score - p_score) >= MAX_DIFF_SCORE and m_snps >= 2 * p_snps:
        return "M"
    if (p_score - m_score) >= MAX_DIFF_SCORE and p_snps >= 2 * m_snps:
        return "P"
    return "N"


def _candidate_ok(info: List[str]) -> bool:
    """Candidate usability (filtering.py:507-546): candidate must share
    chromosome + fragment with the mate it extends."""
    cand = info[-1]
    if cand == "R1":
        return info[1] == info[15] and int(info[6]) == int(info[20])
    return info[8] == info[15] and int(info[13]) == int(info[20])


class _Mate:
    __slots__ = ("c", "pos", "frag", "score", "snps")

    def __init__(self, info, base):
        self.c = info[base]
        self.pos = int(info[base + 2])
        self.frag = int(info[base + 5])
        self.score = int(info[base + 4])
        self.snps = int(info[base + 6])


def _both_mapping(m_info: List[str], p_info: List[str]):
    """Pair present in both parental beds (filtering.py:599-881).
    Returns (mark1+mark2, bed columns)."""
    mm = [_Mate(m_info, 1), _Mate(m_info, 8)]
    pp = [_Mate(p_info, 1), _Mate(p_info, 8)]

    def search(i):
        return _sub_search(mm[i].c, mm[i].pos, mm[i].score, mm[i].snps,
                           pp[i].c, pp[i].pos, pp[i].score, pp[i].snps)

    def line(i, mark):
        src = mm[i] if mark in ("N", "M") else pp[i]
        return [src.c, src.frag]

    marks = [search(0), search(1)]
    lines = [line(0, marks[0]), line(1, marks[1])]

    def retry_with_candidate(i, info, mates):
        """Swap in the candidate columns for mate i and re-search
        (filtering.py:684-722 pattern)."""
        mates[i] = _Mate(info, 15)
        mk = search(i)
        if mk == "M":
            lines[i] = [mm[i].c, mm[i].frag]
            marks[i] = "M"
        elif mk == "P":
            lines[i] = [pp[i].c, pp[i].frag]
            marks[i] = "P"

    m_cand = len(m_info) > 15
    p_cand = len(p_info) > 15
    if m_cand and not p_cand:
        which = m_info[-1]
        if _candidate_ok(m_info):
            i = 0 if which == "R1" else 1
            if marks[i] == "N":
                retry_with_candidate(i, m_info, mm)
    elif p_cand and not m_cand:
        which = p_info[-1]
        if _candidate_ok(p_info):
            i = 0 if which == "R1" else 1
            if marks[i] == "N":
                retry_with_candidate(i, p_info, pp)
    elif m_cand and p_cand:
        which = m_info[-1]
        i = 0 if which == "R1" else 1
        if marks[i] == "N":
            if _candidate_ok(m_info):
                mm[i] = _Mate(m_info, 15)
            if _candidate_ok(p_info):
                pp[i] = _Mate(p_info, 15)
            mk = search(i)
            if mk == "M":
                lines[i] = [mm[i].c, mm[i].frag]
                marks[i] = "M"
            elif mk == "P":
                lines[i] = [pp[i].c, pp[i].frag]
                marks[i] = "P"

    return marks[0] + marks[1], lines[0] + lines[1]


def _specific_mapping(info: List[str]):
    """Pair mapped to only one parental genome (filtering.py:888-983)."""
    snp1 = int(info[7])
    snp2 = int(info[14])
    lines = [info[1], info[6], info[8], info[13]]
    has_cand = len(info) > 15

    if snp1 != 0 and snp2 != 0:
        return "Both", lines + ["Both"]
    if snp1 != 0 and snp2 == 0:
        if has_cand and info[-1] == "R2" and _candidate_ok(info) \
                and int(info[21]) != 0:
            return "Both", [info[1], info[6], info[15], info[20], "Both"]
        return "R1", lines + ["R1"]
    if snp1 == 0 and snp2 != 0:
        if has_cand and info[-1] == "R1" and _candidate_ok(info) \
                and int(info[21]) != 0:
            return "Both", [info[15], info[20], info[8], info[13], "Both"]
        return "R2", lines + ["R2"]
    # neither normal mate has SNPs: candidate rescue (filtering.py:960-977)
    if has_cand and _candidate_ok(info) and int(info[21]) != 0:
        if info[-1] == "R1":
            return "R1", [info[15], info[20], info[8], info[13], "R1"]
        return "R2", [info[1], info[6], info[15], info[20], "R2"]
    return "N", lines


# columns the assignment actually reads (cols 2, 4, 9, 11, 16, 18 — strands,
# mapq-like fields and the candidate's pos/score twins — are never consulted
# by aFiltering's decision tree, filtering.py:507-983)
_AF_OBJ_COLS = (0, 1, 8, 15, 22)
_AF_INT_COLS = (3, 5, 6, 7, 10, 12, 13, 14)      # always present
_AF_FLOAT_COLS = (17, 19, 20, 21)                 # NaN on 15-column rows
_AF_USECOLS = tuple(sorted(_AF_OBJ_COLS + _AF_INT_COLS + _AF_FLOAT_COLS))


def _load_frame_fallback(source):
    """Ragged-tolerant parse + encode (fallback when the native library is
    unavailable or the file violates the strict 15/23 layout): rows up to
    23 wide, missing tails empty, then encoded to the same typed columns
    the native path produces.  ``source`` is a path or a text stream."""
    if hasattr(source, "read"):
        lines = source.read().splitlines()
    else:
        with open(source) as fh:
            lines = fh.read().splitlines()
    rows = [ln.split("\t")[:23] for ln in lines if ln.strip()]
    if rows and min(map(len, rows)) < 15:
        raise ValueError("allelic bed row with fewer than 15 columns")
    rows = [r + [""] * (23 - len(r)) for r in rows]
    d = (list(zip(*rows)) if rows else [()] * 23)
    n = len(rows)
    names = np.array(d[0]).astype("S") if n else np.empty(0, "S1")
    c15v = np.array(d[15], dtype=object)
    m15 = c15v != ""
    labels = sorted(set(d[1]) | set(d[8]) | set(c15v[m15].tolist()))
    lab = np.array(labels, dtype=object)
    c15 = np.full(n, -1, np.int32)
    if m15.any():
        c15[m15] = np.searchsorted(lab, c15v[m15])
    tag = np.zeros(n, np.uint8)
    t22 = np.array(d[22], dtype=object)
    tag[t22 == "R1"] = 1
    tag[t22 == "R2"] = 2
    cols = {0: names, 15: c15, 22: tag}
    for c in (1, 8):
        cols[c] = np.searchsorted(lab, np.array(d[c], dtype=object)).astype(
            np.int32) if n else np.empty(0, np.int32)
    for c in _AF_INT_COLS:
        cols[c] = np.array(d[c], np.int64)
    has = tag > 0
    for c in _AF_FLOAT_COLS:
        v = np.zeros(n, np.int64)
        v[has] = np.array(d[c], dtype=object)[has].astype(np.int64)
        cols[c] = v
    return cols, labels


def _load_frame(path: str):
    """Valid bed as typed columns: ``(cols, labels)`` where cols maps the
    aFiltering column numbers to numpy arrays — read names as fixed-width
    ``S`` bytes (argsort/searchsorted run as memcmp loops; byte order ==
    str order for ASCII names), chroms as int32 codes into ``labels``,
    numerics as int64, the candidate tag as uint8 0/1/2 (none/R1/R2).
    Codes map back through the label table only at write time, so integer
    columns round-trip to the same bytes (all upstream writers emit plain
    ints) — pinned by the vectorized-vs-rowwise parity test.

    The native hicio columnizer does the parse in one C++ pass (a
    typed parse in Python spends its wall building str objects; a
    pyarrow fast path was tried and REJECTED — its arrow->object conversion cost more than the parse
    saved).  Rows load in INPUT order — the columnar path
    joins through an argsort permutation, so no column is ever
    reordered."""
    from ..io.native import load_allelic_bed

    got = load_allelic_bed(path)
    if got is not None:
        return got
    return _load_frame_fallback(path)


def _sorted_member(a: np.ndarray, b: np.ndarray):
    """(membership mask of a in sorted-unique b, insertion indices)."""
    if b.size == 0:
        return np.zeros(a.size, bool), np.zeros(a.size, np.int64)
    ins = np.searchsorted(b, a)
    safe = np.minimum(ins, b.size - 1)
    return (ins < b.size) & (b[safe] == a), ins


def _candidate_ok_vec(df, idx):
    """Vectorized ``_candidate_ok`` over candidate-bearing rows ``idx``:
    the candidate must share chromosome + fragment with the mate its tag
    names (filtering.py:507-546)."""
    tag = df[22][idx]
    cc = df[15][idx]
    cf = df[20][idx]
    ok1 = (df[1][idx] == cc) & (df[6][idx] == cf)
    ok2 = (df[8][idx] == cc) & (df[13][idx] == cf)
    return np.where(tag == 1, ok1, ok2)


def _write_class(out, cols, tag=None, ids=None) -> None:
    """Bulk-append an output class: tab-joined columns (+optional trailing
    tag, optional leading pair-id)."""
    fields = []
    if ids is not None:
        if ids.dtype.kind == "S":  # fixed-width names -> text
            ids = ids.astype("U")
        fields.append(ids)
    fields.extend(cols)
    if not len(fields[0]):
        return
    text = [np.asarray(a).astype(str) for a in fields]
    if tag is not None:
        text.append(np.full(len(cols[0]), tag))
    out.write("".join("\t".join(r) + "\n" for r in zip(*text)))


def _both_marks_arrays(m_df, mi, p_df, pi):
    """Vectorized ``_both_mapping`` over candidate-free pairs addressed by
    row indices (marks [n] of 2-char codes + the 4 output columns)."""
    n = mi.size
    out_marks = np.empty(n, dtype="U2")
    lines = [None] * 4
    for mate, (c_i, pos_i, score_i, frag_i, snp_i) in enumerate(
            ((1, 3, 5, 6, 7), (8, 10, 12, 13, 14))):
        mc = m_df[c_i][mi]
        pc = p_df[c_i][pi]
        mpos = m_df[pos_i][mi]
        ppos = p_df[pos_i][pi]
        msc = m_df[score_i][mi]
        psc = p_df[score_i][pi]
        msnp = m_df[snp_i][mi]
        psnp = p_df[snp_i][pi]
        same = (mc == pc) & (np.abs(mpos - ppos) <= 5)
        mark = np.full(n, "N", dtype="U1")
        mark[same & (msnp > 2 * psnp)] = "M"
        mark[same & (2 * msnp < psnp)] = "P"
        diff = ~same
        mark[diff & ((msc - psc) >= MAX_DIFF_SCORE) & (msnp >= 2 * psnp)] = "M"
        mark[diff & ((psc - msc) >= MAX_DIFF_SCORE) & (psnp >= 2 * msnp)] = "P"
        use_p = mark == "P"
        lines[2 * mate] = np.where(use_p, pc, mc)
        lines[2 * mate + 1] = np.where(use_p, p_df[frag_i][pi],
                                       m_df[frag_i][mi])
        if mate == 0:
            out_marks = mark.astype("U2")
        else:
            # pin dtype to exactly U2: np.char.add widens to U3, which
            # would break the per-mate-character view in the retry pass
            out_marks = np.char.add(out_marks, mark).astype("U2")
    return out_marks, lines


# emit_both's mark → (destination file, trailing tag, stats key) table
_BOTH_ROUTES = (("NN", "Bi_Allelic", None, "Bi_Allelic"),
                ("NM", "M_M", "R2", "Single_M"),
                ("MN", "M_M", "R1", "Single_M"),
                ("MM", "M_M", "Both", "Both_M"),
                ("NP", "P_P", "R2", "Single_P"),
                ("PN", "P_P", "R1", "Single_P"),
                ("PP", "P_P", "Both", "Both_P"),
                ("MP", "M_P", None, "Regroup"),
                ("PM", "P_M", None, "Regroup"))


def _assign_columnar(m_df, p_df, m_names, m_sorted, p_sorted, m_order,
                     p_order, lab, outs, S, save_id) -> int:
    """Columnar merge-join assignment: every row/pair — candidate-bearing
    included — is classified with numpy column ops and written in one bulk
    append per class.  The candidate retry (filtering.py:684-722) and
    rescue (filtering.py:960-977) only ever flip a mate's MARK, never the
    emitted chromosome/fragment columns: ``_candidate_ok`` requires the
    candidate to share both with the mate it replaces, so the substituted
    values are equal to the originals by construction.  That makes the
    whole decision tree expressible as boolean-mask updates over the base
    marks.  (History: the original list-of-split-lines flow measured 582 s
    at 10M pairs on the 1-core host; the half-columnar version that still
    row-looped candidate rows, 187-253 s; this one ~65 s.)"""
    # the join runs in name-sorted coordinates, then maps through the
    # argsort permutations to absolute row indices — no column reorder
    in_p, ins = _sorted_member(m_sorted, p_sorted)
    m_pos = np.flatnonzero(in_p)
    m_idx = m_order[m_pos]
    p_idx = p_order[ins[m_pos]]
    in_m, _ = _sorted_member(p_sorted, m_sorted)
    count = len(m_sorted) + len(p_sorted) - m_idx.size

    m_cand = m_df[22] > 0
    p_cand = p_df[22] > 0

    # ---- single-genome (specific) rows -----------------------------------
    for side, df, cand, spec in (
            ("M", m_df, m_cand, m_order[np.flatnonzero(~in_p)]),
            ("P", p_df, p_cand, p_order[np.flatnonzero(~in_m)])):
        key = "M_M" if side == "M" else "P_P"
        S[f"Speci_{side}"] += spec.size
        if spec.size:
            snp1 = df[7][spec]
            snp2 = df[14][spec]
            marks = np.full(spec.size, "N", dtype="U4")
            marks[(snp1 != 0) & (snp2 != 0)] = "Both"
            marks[(snp1 != 0) & (snp2 == 0)] = "R1"
            marks[(snp1 == 0) & (snp2 != 0)] = "R2"
            has_c = cand[spec]
            if has_c.any():
                ci = spec[has_c]
                # candidate usable + carries SNPs -> upgrades the mark
                # (_specific_mapping branches, filtering.py:888-983)
                up = _candidate_ok_vec(df, ci) & (
                    df[21][ci] != 0)
                tag = df[22][ci]
                mk = marks[has_c]
                mk[up & (mk == "R1") & (tag == 2)] = "Both"
                mk[up & (mk == "R2") & (tag == 1)] = "Both"
                rescue = up & (mk == "N")
                mk[rescue & (tag == 1)] = "R1"
                mk[rescue & (tag == 2)] = "R2"
                marks[has_c] = mk
            cols = [df[i][spec] for i in (1, 6, 8, 13)]
            ids = df[0][spec] if save_id else None
            for kind, dest in (("Both", key), ("R1", key), ("R2", key),
                               ("N", "Bi_Allelic")):
                sel = marks == kind
                if not sel.any():
                    continue
                arrs = [a[sel] for a in cols]
                arrs[0] = lab[arrs[0]]  # chrom codes -> labels
                arrs[2] = lab[arrs[2]]
                _write_class(outs[dest], arrs,
                             tag=None if kind == "N" else kind,
                             ids=None if ids is None else ids[sel])
            n_both = int((marks == "Both").sum())
            n_single = int(((marks == "R1") | (marks == "R2")).sum())
            S[f"Both_{side}"] += n_both
            S[f"Speci_{side}_both"] += n_both
            S[f"Single_{side}"] += n_single
            S[f"Speci_{side}_single"] += n_single
            S["Bi_Allelic"] += int((marks == "N").sum())

    # ---- both-genome pairs ------------------------------------------------
    if m_idx.size:
        marks, lines = _both_marks_arrays(m_df, m_idx, p_df, p_idx)
        anyc = m_cand[m_idx] | p_cand[p_idx]
        if anyc.any():
            _both_candidate_retry(m_df, p_df, m_idx, p_idx,
                                  np.flatnonzero(anyc), marks, lines)
        ids = m_names[m_idx] if save_id else None
        for code, dest, tag, skey in _BOTH_ROUTES:
            sel = marks == code
            if not sel.any():
                continue
            arrs = [a[sel] for a in lines]
            arrs[0] = lab[arrs[0]]  # chrom codes -> labels
            arrs[2] = lab[arrs[2]]
            _write_class(outs[dest], arrs, tag=tag,
                         ids=None if ids is None else ids[sel])
            S[skey] += int(sel.sum())
    return count


def _both_candidate_retry(m_df, p_df, m_idx, p_idx, sel, marks,
                          lines) -> None:
    """Vectorized candidate retry for both-genome pairs
    (filtering.py:599-881): where the tagged mate's base mark is "N",
    re-run ``_sub_search`` with the usable candidate's score/SNP columns
    substituted for its side, and flip that mate's mark in place.

    Replicates the reference's branch structure exactly, including its
    quirks: with candidates on BOTH rows the mate index comes from the
    maternal tag alone and each side substitutes per its own tag's
    ``_candidate_ok`` (so a paternal R2 candidate can be substituted into
    the R1 slot); one-sided candidates require their own ``_candidate_ok``
    before any retry.  Marks flip N->M (lines already point at the
    maternal columns) or N->P (lines switch to the paternal columns —
    equal to what the per-row path emits because ``_candidate_ok`` pins
    candidate chrom/frag to the originals)."""
    mi, pi = m_idx[sel], p_idx[sel]
    cm = m_df[22][mi] > 0
    cp = p_df[22][pi] > 0
    ok_m = np.zeros(sel.size, bool)
    ok_p = np.zeros(sel.size, bool)
    if cm.any():
        ok_m[cm] = _candidate_ok_vec(m_df, mi[cm])
    if cp.any():
        ok_p[cp] = _candidate_ok_vec(p_df, pi[cp])
    case_a = cm & ~cp
    case_b = cp & ~cm
    case_c = cm & cp
    m_tag = m_df[22][mi]
    p_tag = p_df[22][pi]
    # mate index: the maternal tag except in the paternal-only case
    ii = np.where(case_b, p_tag == 2, m_tag == 2).astype(np.int64)

    mkview = marks.view("U1").reshape(-1, 2)
    cur = mkview[sel, ii]
    attempt = ((case_a & ok_m) | (case_b & ok_p) | case_c) & (cur == "N")
    rows = np.flatnonzero(attempt)
    if not rows.size:
        return
    mir, pir, iir = mi[rows], pi[rows], ii[rows]
    sub_m = ((case_a | case_c) & ok_m)[rows]
    sub_p = ((case_b | case_c) & ok_p)[rows]

    def side_vals(df, ridx, sub, mate):
        # per-mate (c, pos, score, snps), candidate columns swapped in
        # where ``sub`` (the _Mate(info, 15) substitution)
        vals = []
        for a_col, b_col, c_col in ((1, 8, 15), (3, 10, 17), (5, 12, 19),
                                    (7, 14, 21)):
            a = df[a_col][ridx]
            b = df[b_col][ridx]
            v = np.where(mate == 1, b, a)
            cv = df[c_col][ridx]
            v = np.where(sub, cv, v)
            vals.append(v)
        return vals

    mc, mpos, msc, msnp = side_vals(m_df, mir, sub_m, iir)
    pc, ppos, psc, psnp = side_vals(p_df, pir, sub_p, iir)
    same = (mc == pc) & (np.abs(mpos - ppos) <= 5)
    mk = np.full(rows.size, "N", dtype="U1")
    mk[same & (msnp > 2 * psnp)] = "M"
    mk[same & (2 * msnp < psnp)] = "P"
    diff = ~same
    mk[diff & ((msc - psc) >= MAX_DIFF_SCORE) & (msnp >= 2 * psnp)] = "M"
    mk[diff & ((psc - msc) >= MAX_DIFF_SCORE) & (psnp >= 2 * msnp)] = "P"
    flip = mk != "N"
    if not flip.any():
        return
    fr = rows[flip]
    mkview[sel[fr], ii[fr]] = mk[flip]
    # N->P flips re-point the mate's output columns at the paternal row
    # (N->M keeps the maternal columns the base pass already selected).
    # Where the paternal side was candidate-substituted, the per-row path
    # emits the CANDIDATE's chrom/frag (pp[i] is _Mate(p_info, 15)) — for
    # same-tag substitutions that equals the mate's own columns, but in
    # the both-candidates case the slot comes from the MATERNAL tag while
    # ok_p follows the paternal tag, so a cross-tag candidate carries the
    # OTHER paternal mate's coordinates into this slot (filtering.py:
    # 684-722 behavior, pinned by the vectorized-parity test).
    is_p = mk == "P"
    pf = rows[is_p]
    sub_pf = sub_p[is_p]
    for mate, (c_col, f_col) in enumerate(((1, 6), (8, 13))):
        mmask = ii[pf] == mate
        msel = pf[mmask]
        if msel.size:
            g = sel[msel]
            gp = p_idx[g]
            subm = sub_pf[mmask]
            lines[2 * mate][g] = np.where(
                subm, p_df[15][gp], p_df[c_col][gp])
            lines[2 * mate + 1][g] = np.where(
                subm, p_df[20][gp], p_df[f_col][gp])


def allelic_filtering(maternal_bed: str, paternal_bed: str, out_dir: str,
                      save_id: bool = False,
                      vectorized: bool = True) -> Dict[str, float]:
    """Merge-join the two name-sorted valid beds → the five allelic beds
    (filtering.py:989-1291).

    With ``vectorized`` (default), candidate-free pairs — the vast majority
    — are assigned with numpy column ops; candidate-bearing rows take the
    row-wise reference-faithful path.  Output file contents and statistics
    are identical to the row-wise implementation (row order within a file
    may differ; downstream binning is order-independent)."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.split(maternal_bed)[-1].split("Maternal")[0] + "Valid"

    def load_sorted(path):
        # native external-memory whole-line sort (reference sorts whole
        # lines, filtering.py:474); Python fallback inside sort_file
        from ..io.native import sort_file

        tmp = path + ".name_sorted"
        sort_file(path, tmp, "name")
        rows = [line.split() for line in open(tmp)]
        os.remove(tmp)
        return rows

    outs = {k: open(os.path.join(out_dir, f"{prefix}_{k}.bed"), "w")
            for k in ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")}

    S = dict(Bi_Allelic=0, Both_M=0, Both_P=0, Single_M=0, Single_P=0,
             Regroup=0, Speci_M=0, Speci_P=0, Speci_M_single=0,
             Speci_M_both=0, Speci_P_single=0, Speci_P_both=0)

    def emit_specific(info, side):
        mark, lines = _specific_mapping(info)
        if save_id:
            lines = [info[0]] + lines  # aFiltering(save_ID) parity
        key = "M_M" if side == "M" else "P_P"
        S[f"Speci_{side}"] += 1
        if mark == "Both":
            S[f"Both_{side}"] += 1
            S[f"Speci_{side}_both"] += 1
            outs[key].write("\t".join(map(str, lines)) + "\n")
        elif mark in ("R1", "R2"):
            S[f"Single_{side}"] += 1
            S[f"Speci_{side}_single"] += 1
            outs[key].write("\t".join(map(str, lines)) + "\n")
        else:
            S["Bi_Allelic"] += 1
            outs["Bi_Allelic"].write("\t".join(map(str, lines)) + "\n")

    def emit_both(mark, lines, name):
        if save_id:
            lines = [name] + lines
        row = "\t".join(map(str, lines))
        if mark == "NN":
            S["Bi_Allelic"] += 1
            outs["Bi_Allelic"].write(row + "\n")
        elif mark in ("NM", "MN"):
            S["Single_M"] += 1
            outs["M_M"].write(row + ("\tR2\n" if mark == "NM" else "\tR1\n"))
        elif mark == "MM":
            S["Both_M"] += 1
            outs["M_M"].write(row + "\tBoth\n")
        elif mark in ("NP", "PN"):
            S["Single_P"] += 1
            outs["P_P"].write(row + ("\tR2\n" if mark == "NP" else "\tR1\n"))
        elif mark == "PP":
            S["Both_P"] += 1
            outs["P_P"].write(row + "\tBoth\n")
        elif mark == "MP":
            S["Regroup"] += 1
            outs["M_P"].write(row + "\n")
        elif mark == "PM":
            S["Regroup"] += 1
            outs["P_M"].write(row + "\n")

    uniq = False
    if vectorized:
        m_df, m_labels = _load_frame(maternal_bed)
        p_df, p_labels = _load_frame(paternal_bed)
        # unify the two per-file chromosome code tables so cross-frame
        # equality is plain int compare (code -1 = "no candidate chrom"
        # maps through the appended sentinel slot)
        labels = sorted(set(m_labels) | set(p_labels))
        lab = np.array(labels + [""], dtype=object)
        pos = {x: i for i, x in enumerate(labels)}
        for d, dl in ((m_df, m_labels), (p_df, p_labels)):
            remap = np.array([pos[x] for x in dl] + [-1], np.int32)
            for c in (1, 8, 15):
                d[c] = remap[d[c]]
        # fixed-width names: argsort/searchsorted/compare run as memcmp
        # loops instead of per-element PyObject calls; ASCII read names
        # order identically under bytes and str comparison
        m_names = m_df[0]
        p_names = p_df[0]
        m_order = np.argsort(m_names, kind="stable")
        p_order = np.argsort(p_names, kind="stable")
        m_sorted = m_names[m_order]
        p_sorted = p_names[p_order]
        # the columnar fast path needs UNIQUE names on both sides
        uniq = (bool((m_sorted[1:] > m_sorted[:-1]).all())
                and bool((p_sorted[1:] > p_sorted[:-1]).all()))

    if vectorized and uniq:
        count = _assign_columnar(m_df, p_df, m_names, m_sorted, p_sorted,
                                 m_order, p_order, lab, outs, S, save_id)
    else:
        m_rows = load_sorted(maternal_bed)
        p_rows = load_sorted(paternal_bed)
        i = j = 0
        count = 0
        while i < len(m_rows) or j < len(p_rows):
            count += 1
            if i >= len(m_rows):
                emit_specific(p_rows[j], "P")
                j += 1
            elif j >= len(p_rows):
                emit_specific(m_rows[i], "M")
                i += 1
            else:
                mn, pn = m_rows[i][0], p_rows[j][0]
                if mn < pn:
                    emit_specific(m_rows[i], "M")
                    i += 1
                elif mn > pn:
                    emit_specific(p_rows[j], "P")
                    j += 1
                else:
                    mark, lines = _both_mapping(m_rows[i], p_rows[j])
                    emit_both(mark, lines, m_rows[i][0])
                    i += 1
                    j += 1
    for f in outs.values():
        f.close()

    total = count
    allelic_n = S["Both_M"] + S["Both_P"] + S["Single_M"] + S["Single_P"]
    report = {
        "Total_valid_pairs": total,
        "Bi_Allelic_pairs": S["Bi_Allelic"],
        "Maternal_Allelic_pairs": S["Both_M"] + S["Single_M"],
        "Paternal_Allelic_pairs": S["Both_P"] + S["Single_P"],
        "Maternal_both_sides_pairs": S["Both_M"],
        "Paternal_both_sides_pairs": S["Both_P"],
        "Maternal_single_side_pairs": S["Single_M"],
        "Paternal_single_side_pairs": S["Single_P"],
        "Speci_Maternal_Mapping_pairs": S["Speci_M"],
        "Speci_Paternal_Mapping_pairs": S["Speci_P"],
        "Speci_Maternal_both_sides_pairs": S["Speci_M_both"],
        "Speci_Paternal_both_sides_pairs": S["Speci_P_both"],
        "Speci_Maternal_single_sides_pairs": S["Speci_M_single"],
        "Speci_Paternal_single_sides_pairs": S["Speci_P_single"],
        "Recombination_pairs": S["Regroup"],
        "Allelic_Ratio": allelic_n / total if total else 0.0,
    }
    log.log(21, "allelic filtering: %s", report)
    return report
