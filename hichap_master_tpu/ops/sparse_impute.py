"""Inter-chromosomal imputation disk vote on the block-sparse layout.

The dense vote (ops/imputation.py; HiCHap/matrixBuilding.py:1302-1493) sums
the un-imputed genome-wide matrix ``U`` over a disk neighborhood around each
candidate target bin.  Past the dense cap (hg19 at 10 kb is ~304k bins, ~607k
diploid) ``U`` exists only as sparse COO, so the disk sum becomes a *range
query over sorted pixels*: every disk row is a contiguous column interval
(circle geometry), so

    D(r, c) = sum_k  CUM[ub(r + di_k, c + hi_k + 1)] - CUM[lb(r + di_k, c + lo_k)]

where CUM is the prefix sum of pixel values in (row, col) lexicographic
order and lb/ub are binary searches.  That turns a |disk| = pi * L pixel
gather (~3,100 at 10 kb) into ~2 * (2 * sqrt(L) + 2) ~ 130 searches per
candidate — and every search is a data-parallel gather chain, so the whole
vote runs as one jitted device dispatch per chunk.

Two layout choices:
  * the search is a hand-rolled **lexicographic binary search over
    (row, col) int32 pairs** (``lex_searchsorted``) instead of a single
    int64-key ``searchsorted`` — S^2 key space overflows int32 and JAX
    default (x64-off) arrays are int32;
  * the prefix array stores the int64 cumulative counts **wrapped to
    int32** — any single disk-window sum is far below 2^31, so the wrapped
    difference is exact even when the genome-wide total overflows.

Round 5 added the production variant, ``sparse_impute_vote_rowptr``: a
row-pointer table restricts each disk-row search to that row's slice of
the column array, cutting the per-query random memory traffic from
log2(nnz) steps x 2 gathers (srows + scols) to log2(max row nnz) steps
x 1 gather — measured 3.0x at the diploid 10 kb production scale
(scripts/probe_vote_ab.py, exact output parity).  The lex variant
remains as the parity oracle (tests/test_sparse_impute.py pins both
against the dense-kernel oracle).

Vote semantics match ``ops.imputation.impute_inter_chunk`` exactly
(HiCHap/matrixBuilding.py:1302-1493 with the D1/D2 fixes, DIVERGENCES.md):
same-haplotype candidate wins when its disk count is >= ``min_count`` and
its share of the two-candidate total exceeds ``ratio``; otherwise the cross
candidate gets the same test; otherwise the contact is dropped.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .imputation import disk_offsets


def disk_row_intervals(L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The imputation disk as per-row contiguous column intervals.

    Returns (di, dj_lo, dj_hi): for each distinct row offset di the disk
    covers exactly the columns [c + dj_lo, c + dj_hi] (circle rows are
    intervals; the off-center reference quirk is inherited from
    ``disk_offsets``)."""
    di, dj = disk_offsets(L)
    if di.size == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy()
    rows = np.unique(di)
    lo = np.asarray([dj[di == r].min() for r in rows], np.int32)
    hi = np.asarray([dj[di == r].max() for r in rows], np.int32)
    # contiguity invariant (guards the range-query reformulation)
    counts = np.asarray([(di == r).sum() for r in rows])
    assert (counts == hi - lo + 1).all(), "disk rows must be intervals"
    return rows.astype(np.int32), lo, hi


class SparseU:
    """Sorted-COO snapshot of the symmetric un-imputed genome-wide matrix,
    ready for device range queries."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 S: int):
        """``rows <= cols`` upper-triangle COO of integer counts."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.int64)
        off = rows != cols
        r = np.concatenate([rows, cols[off]])
        c = np.concatenate([cols, rows[off]])
        v = np.concatenate([vals, vals[off]])
        # (row, col) sort via the native radix on the composite key —
        # np.lexsort over 2x nnz symmetric pixels was a measured
        # multi-ten-second share of the diploid vote setup
        from ..io.native import radix_sort_kv

        keys = r * np.int64(S) + c
        payload = v.astype(np.float64)  # counts < 2^53: exact
        if radix_sort_kv(keys, payload):
            r, c = keys // S, keys % S
            v = payload.astype(np.int64)
        else:
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
        cum = np.concatenate([[0], np.cumsum(v)])
        self.S = S
        self.nnz = int(r.size)
        self.srows = jnp.asarray(r.astype(np.int32))
        self.scols = jnp.asarray(c.astype(np.int32))
        # int64 prefix wrapped to int32: window-sum differences stay exact
        self.cum32 = jnp.asarray((cum & 0xFFFFFFFF).astype(np.uint32)
                                 .view(np.int32))
        self.iters = int(np.ceil(np.log2(max(self.nnz, 2)))) + 1
        # row pointers: restrict each disk-row search to that row's slice
        # of the column array — log2(max row nnz) single-gather steps
        # instead of log2(nnz) double-gather (srows+scols) steps, ~4x less
        # random memory traffic per query in the pass-3 vote
        row_ptr = np.searchsorted(r, np.arange(S + 1, dtype=np.int64))
        self.row_ptr = jnp.asarray(row_ptr.astype(np.int32))
        max_row = int((row_ptr[1:] - row_ptr[:-1]).max()) if S else 0
        # quantized up to a multiple of 2: ``iters`` is a static jit arg,
        # so per-dataset exact values would compile a fresh kernel per
        # distinct max-row-nnz; extra steps are no-ops once the search
        # converges (ladder principle, core/contacts.pad_to_shape), but
        # each step is a gather — keep the overshoot ≤1 step
        need = int(np.ceil(np.log2(max(max_row, 2)))) + 1
        self.row_iters = -(-need // 2) * 2


@functools.partial(jax.jit, static_argnames=("iters",))
def lex_searchsorted(srows: jnp.ndarray, scols: jnp.ndarray,
                     qr: jnp.ndarray, qc: jnp.ndarray,
                     iters: int) -> jnp.ndarray:
    """Left insertion points of (qr, qc) into the lexicographically sorted
    (srows, scols) pair list — int32 throughout (no int64 keys with
    x64 off)."""
    nnz = srows.shape[0]
    lo = jnp.zeros(qr.shape, jnp.int32)
    hi = jnp.full(qr.shape, nnz, jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        mid = lo + ((hi - lo) >> 1)  # (lo+hi) wraps int32 past 2^30 nnz
        midc = jnp.minimum(mid, nnz - 1)
        r = srows[midc]
        c = scols[midc]
        less = ((r < qr) | ((r == qr) & (c < qc))) & (mid < hi)
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo


@functools.partial(jax.jit, static_argnames=("iters",))
def sparse_disk_sums(srows, scols, cum32, r, c, di, dj_lo, dj_hi,
                     iters: int) -> jnp.ndarray:
    """[Q] disk sums of the sparse symmetric matrix around (r[q], c[q])."""
    qr = r[:, None] + di[None, :]
    lo = lex_searchsorted(srows, scols, qr, c[:, None] + dj_lo[None, :], iters)
    hi = lex_searchsorted(srows, scols, qr,
                          c[:, None] + dj_hi[None, :] + 1, iters)
    # wrapped-int32 prefix differences are the exact window sums
    return jnp.sum(cum32[hi] - cum32[lo], axis=1)


def _bounded_searchsorted(scols: jnp.ndarray, lo0: jnp.ndarray,
                          hi0: jnp.ndarray, qc: jnp.ndarray,
                          iters: int) -> jnp.ndarray:
    """Left insertion points of qc into scols restricted to [lo0, hi0)
    per query (the row slices from a row-pointer table).  One gather per
    step, and ``iters`` only needs to cover the LARGEST ROW's nnz."""
    nnz = scols.shape[0]

    def body(_, lohi):
        lo, hi = lohi
        mid = lo + ((hi - lo) >> 1)
        c = scols[jnp.minimum(mid, nnz - 1)]
        less = (c < qc) & (mid < hi)
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo0, hi0))
    return lo


@functools.partial(jax.jit, static_argnames=("iters",))
def sparse_disk_sums_rowptr(scols, cum32, row_ptr, r, c, di, dj_lo, dj_hi,
                            iters: int) -> jnp.ndarray:
    """[Q] disk sums via row-pointer-bounded searches (semantics identical
    to ``sparse_disk_sums``; requires every disk row r+di in [0, S) —
    guaranteed by the caller's in-bounds clamp)."""
    qr = r[:, None] + di[None, :]
    rlo = row_ptr[qr]
    rhi = row_ptr[qr + 1]
    lo = _bounded_searchsorted(scols, rlo, rhi,
                               c[:, None] + dj_lo[None, :], iters)
    hi = _bounded_searchsorted(scols, rlo, rhi,
                               c[:, None] + dj_hi[None, :] + 1, iters)
    return jnp.sum(cum32[hi] - cum32[lo], axis=1)


@functools.partial(jax.jit, static_argnames=("iters", "L"))
def sparse_impute_vote_rowptr(scols, cum32, row_ptr, row_known, col_same,
                              col_cross, valid, di, dj_lo, dj_hi,
                              S: jnp.ndarray, L: int, min_count: float,
                              ratio: float, iters: int):
    """``sparse_impute_vote`` with the row-pointer-bounded search (the
    production pass-3 path since round 5; the lex variant remains as the
    parity oracle)."""
    inb = (
        valid
        & (row_known >= L) & (row_known + L + 1 <= S)
        & (col_same >= L) & (col_same + L + 1 <= S)
        & (col_cross >= L) & (col_cross + L + 1 <= S)
    )
    r = jnp.where(inb, row_known, L)
    cs = jnp.where(inb, col_same, L)
    cc = jnp.where(inb, col_cross, L)

    same = sparse_disk_sums_rowptr(scols, cum32, row_ptr, r, cs, di, dj_lo,
                                   dj_hi, iters).astype(jnp.float32)
    cross = sparse_disk_sums_rowptr(scols, cum32, row_ptr, r, cc, di, dj_lo,
                                    dj_hi, iters).astype(jnp.float32)
    tot = same + cross
    share_same = jnp.where(tot > 0, same / tot, 0.0)
    share_cross = jnp.where(tot > 0, cross / tot, 0.0)

    pick_same = inb & (same >= min_count) & (share_same > ratio)
    pick_cross = (inb & ~pick_same & (cross >= min_count)
                  & (share_cross > ratio))
    tgt = jnp.where(pick_same, col_same, col_cross)
    return pick_same | pick_cross, tgt


@functools.partial(jax.jit, static_argnames=("iters", "L"))
def sparse_impute_vote(srows, scols, cum32, row_known, col_same, col_cross,
                       valid, di, dj_lo, dj_hi, S: jnp.ndarray, L: int,
                       min_count: float, ratio: float, iters: int):
    """One chunk of the inter-chromosome vote on sparse U.

    Returns (hit [Q] bool, tgt [Q] int32): for hits, increment the imputed
    accumulator at (row_known, tgt).  Boundary rule identical to the dense
    kernel: contacts whose L-window would leave [0, S) are dropped."""
    inb = (
        valid
        & (row_known >= L) & (row_known + L + 1 <= S)
        & (col_same >= L) & (col_same + L + 1 <= S)
        & (col_cross >= L) & (col_cross + L + 1 <= S)
    )
    r = jnp.where(inb, row_known, L)
    cs = jnp.where(inb, col_same, L)
    cc = jnp.where(inb, col_cross, L)

    same = sparse_disk_sums(srows, scols, cum32, r, cs, di, dj_lo, dj_hi,
                            iters).astype(jnp.float32)
    cross = sparse_disk_sums(srows, scols, cum32, r, cc, di, dj_lo, dj_hi,
                             iters).astype(jnp.float32)
    tot = same + cross
    share_same = jnp.where(tot > 0, same / tot, 0.0)
    share_cross = jnp.where(tot > 0, cross / tot, 0.0)

    pick_same = inb & (same >= min_count) & (share_same > ratio)
    pick_cross = (inb & ~pick_same & (cross >= min_count)
                  & (share_cross > ratio))
    tgt = jnp.where(pick_same, col_same, col_cross)
    return pick_same | pick_cross, tgt
