"""Hybrid genome-wide layout: dense tiles + scattered-COO remainder.

The pure tile layout (ops/sparse.py) is built for Hi-C's banded intra
mass — occupied tiles grow linearly with genome length.  REAL genome-wide
data also carries scattered inter-chromosomal pixels (tens of millions of
mostly count-1 entries spread over the whole [S, S] plane at 10 kb); tiling
those would touch nearly every off-band tile coordinate (~2.7M tiles,
~180 GB for hg19) — the layout the reference never needs because it caps
genome-wide matrices at coarse resolutions and shells balancing out to
``cooler balance`` (HiCHap/matrixBuilding.py:699-714, README.md:312-318).

Here the matrix splits by tile occupancy:

  * tiles with >= ``min_tile_occ`` pixels stay dense [K, T, T] (batched
    matvec, ops/sparse.block_sym_matvec);
  * the remainder lives as a row-sorted directed COO whose per-iteration
    marginal is computed WITHOUT any scatter: gather b at the column ids,
    multiply by the values, take a compensated (two-float) prefix sum, and
    difference it at the precomputed per-row segment boundaries — the same
    prefix-range-query idea as ops/sparse_impute, but over floats, so the
    scan carries a (hi, lo) error term to keep ~2^-48 relative precision
    where a plain f32 cumsum over 10^8 elements would lose the row sums to
    cancellation.  No scatter-add runs, so the marginal is deterministic,
    and every step is a dense gather/scan XLA fuses well.

``hybrid_ice_balance`` then mirrors ``sparse_ice_balance`` (cooler-default
filters: ignore-diags, MAD-max, min-nnz) with the marginal summed from both
parts, so balancing true genome-wide 10 kb matrices with full trans content
runs on one device at O(nnz) memory.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .masked import masked_mean, masked_median, masked_var
from .sparse import BlockMatrix, block_sym_matvec, blocks_from_coo


@dataclasses.dataclass
class HybridGW:
    """Tiled part + row-sorted scattered remainder of a symmetric matrix.

    The scattered arrays are DIRECTED (both orientations of each off-
    diagonal pixel, diagonal once) so one row-marginal pass covers the
    symmetric contribution.  ``bounds[i]:bounds[i+1]`` indexes row i's
    pixels in the sorted arrays; ``P`` is the padded pixel count."""

    bm: BlockMatrix
    sc_cols: np.ndarray   # [P] int32 (padded with 0)
    sc_vals: np.ndarray   # [P] f32 or uint16 (padded with 0)
    bounds: np.ndarray    # [N+1] int32 into the sorted pixel arrays
    sc_nnz: np.ndarray    # [N] f32, scattered nonzero count per row
    n: int
    # the diagonal-exclusion rule the scattered part was BUILT with; the
    # balance must use the same value (tiles apply it on device)
    ignore_diags: int = 1

    @property
    def P(self) -> int:
        return int(self.sc_cols.size)


# flat-occupancy grid cap: above this many (n/T)^2 tile cells the
# [R*R] bincount/lut arrays exceed ~1 GB and counting switches to
# np.unique (tests monkeypatch it low to pin both paths identical)
_GRID_CELL_CAP = 1 << 27


def hybrid_from_coo(rows, cols, vals, n: int, T: int = 128,
                    min_tile_occ: int = 256, ignore_diags: int = 1,
                    dtype=np.float32, assume_unique: bool = False) -> HybridGW:
    """Split upper-triangle COO by tile occupancy (host-side, one pass).

    ``ignore_diags`` pixels (|i-j| < d) are dropped from the scattered part
    here (the tiled part zeroes them inside ``hybrid_ice_balance`` /
    ``sparse_ice_balance`` as usual) — both parts then agree with the
    cooler-default ignore rule.

    When ``vals`` are integer counts fitting uint16 (the raw-matrix case),
    tiles and scattered values are STORED uint16 and cast to f32 on device
    — halving the host->device wire (589 MB of f32 tiles at hg19 10 kb)
    without changing any result (cooler pixels are unique, so no u16
    accumulation overflow is possible).

    ``assume_unique`` declares each (row, col) appears at most once (always
    true for pixels read back from a cooler or a compacted ``SparseGW``):
    tile filling becomes a fancy-index ASSIGNMENT instead of an
    accumulation.  Combined with shift-based tile ids and a bincount
    occupancy over the [R*R] tile grid (np.unique sorts 30M int64 twice;
    the grid is only ~5.6M cells at hg19 10 kb), the host build drops
    133 s -> ~5 s at 30M pixels on the 1-core host."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if (assume_unique  # duplicates ACCUMULATE: a u16 sum could wrap
            and np.issubdtype(vals.dtype, np.integer)
            and (vals.size == 0 or vals.max(initial=0) <= 0xFFFF)
            and (vals.size == 0 or vals.min(initial=0) >= 0)):
        dtype = np.uint16
    vals = vals.astype(dtype)
    if rows.size and (rows > cols).any():
        raise ValueError("hybrid_from_coo expects upper-triangle pixels")
    R = (n + T - 1) // T
    if T & (T - 1) == 0:  # numpy does no strength reduction on int64 //
        sh = T.bit_length() - 1
        bid = (rows >> sh) * R + (cols >> sh)
    else:
        bid = (rows // T) * R + cols // T
    # tile occupancy: the flat [R*R] grid (one bincount, no sort) wins at
    # 10 kb (R^2 ≈ 5.6M cells) but is O((n/T)^2) memory — at 1 kb it
    # would be two ~4.7 GB arrays, so past the cap count via np.unique
    # (O(nnz log nnz), still far cheaper than the tiles themselves there)
    grid_ok = R * R <= _GRID_CELL_CAP
    if grid_ok:
        occ = np.bincount(bid, minlength=R * R)
        dense_sel = occ[bid] >= min_tile_occ
    else:
        uniq_all, inv, counts = np.unique(bid, return_inverse=True,
                                          return_counts=True)
        dense_sel = counts[inv] >= min_tile_occ

    if assume_unique:
        if grid_ok:
            uniq = np.flatnonzero(occ >= max(min_tile_occ, 1))
            K = uniq.size
            lut = np.zeros(R * R, np.int64)
            lut[uniq] = np.arange(K)
            slot = lut[bid[dense_sel]]
        else:
            uniq = uniq_all[counts >= max(min_tile_occ, 1)]
            K = uniq.size
            slot = np.searchsorted(uniq, bid[dense_sel])
        tiles = np.zeros((max(K, 1), T, T), dtype)
        rs, cs = rows[dense_sel], cols[dense_sel]
        tiles.reshape(-1)[slot * (T * T)
                          + (rs % T) * T + (cs % T)] = vals[dense_sel]
        brow = (uniq // R).astype(np.int32)
        bcol = (uniq % R).astype(np.int32)
        diag = brow == bcol
        if diag.any():
            ut = np.triu(tiles[diag], 1)
            tiles[diag] = tiles[diag] + np.swapaxes(ut, -1, -2)
        if K == 0:
            brow = np.zeros(1, np.int32)
            bcol = np.zeros(1, np.int32)
        bm = BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=n, T=T, R=R)
    else:
        bm = blocks_from_coo(rows[dense_sel], cols[dense_sel],
                             vals[dense_sel], n, T, dtype)

    r, c, v = rows[~dense_sel], cols[~dense_sel], vals[~dense_sel]
    live = (np.abs(r - c) >= ignore_diags) & (v != 0)
    r, c, v = r[live], c[live], v[live]
    off = r != c
    dr = np.concatenate([r, c[off]])
    dc = np.concatenate([c, r[off]])
    dv = np.concatenate([v, v[off]])
    order = np.argsort(dr, kind="stable")
    dr, dc, dv = dr[order], dc[order], dv[order]
    bounds = np.searchsorted(dr, np.arange(n + 1)).astype(np.int32)
    sc_nnz = (bounds[1:] - bounds[:-1]).astype(np.float32)
    # pad to a size-scaled granularity (1/8 octave, capped at 2^20): shape
    # churn (and thus recompiles) stays rare while padding waste is bounded
    # at ~12% — the earlier power-of-two rule DOUBLED the scattered work at
    # the hg19 e2e scale (33.6M pixels padded to 67.1M)
    g = max(1024, min(1 << 20, 1 << max(int(dr.size).bit_length() - 3, 0)))
    P = max(g, -(-int(dr.size) // g) * g)
    sc_cols = np.zeros(P, np.int32)
    sc_vals = np.zeros(P, dtype)
    sc_cols[: dc.size] = dc
    sc_vals[: dv.size] = dv
    return HybridGW(bm=bm, sc_cols=sc_cols, sc_vals=sc_vals, bounds=bounds,
                    sc_nnz=sc_nnz, n=n, ignore_diags=ignore_diags)


# ------------------------------------------------ compensated prefix sums
# _two_sum/_df_combine live in ops.sparse (shared with its scan reduction);
# re-exported here because this module's docstrings/tests reference them as
# the double-float machinery of the scattered-COO marginal.
from .sparse import _df_combine, _two_sum  # noqa: E402,F401


def _comp_prefix(x: jnp.ndarray):
    """Inclusive compensated (hi, lo) prefix of a 1-D array via a two-level
    blocked associative scan: the large scan stays power-of-two and the
    program small."""
    n = x.shape[0]
    Q = min(1 << max(n - 1, 1).bit_length(), 8192)
    n2 = -(-n // Q) * Q
    if n2 != n:
        x = jnp.concatenate([x, jnp.zeros(n2 - n, x.dtype)])
    blk = x.reshape(n2 // Q, Q)
    ih, il = jax.lax.associative_scan(_df_combine,
                                      (blk, jnp.zeros_like(blk)), axis=1)
    th, tl = ih[:, -1], il[:, -1]
    ph, pl = jax.lax.associative_scan(_df_combine, (th, tl))
    ph = jnp.concatenate([jnp.zeros((1,), ph.dtype), ph[:-1]])
    pl = jnp.concatenate([jnp.zeros((1,), pl.dtype), pl[:-1]])
    oh, ol = _df_combine((ph[:, None], pl[:, None]), (ih, il))
    return oh.reshape(-1)[:n], ol.reshape(-1)[:n]


def _segment_sums(products: jnp.ndarray, bounds: jnp.ndarray) -> jnp.ndarray:
    """[N] per-row sums of ``products`` (row-sorted) via prefix evaluation
    at the segment boundaries — no scatter, and no scan over the pixels.

    The flat array is viewed as [nC, 128] chunks; chunk totals come from
    one tree reduce, a compensated (hi, lo) prefix runs over the ~P/128
    chunk totals only, and the prefix value at an arbitrary boundary index
    is (exclusive chunk prefix) + (masked tree sum of that boundary's
    gathered chunk row).  An associative scan over all P elements moves
    ~log2(P) full copies of the array per call; this form is three O(P)
    passes (reduce, product, two N x 128 row gathers).  Compensation across chunks bounds the
    error by the CHUNK-LOCAL magnitude (~128 elements), not the 10^8-element
    global prefix magnitude, which is what makes boundary differencing safe
    in f32."""
    P = products.shape[0]
    C = 128
    P2 = -(-P // C) * C
    if P2 != P:  # zero padding after the last bound contributes nothing
        products = jnp.concatenate(
            [products, jnp.zeros(P2 - P, products.dtype)])
        P = P2
    blk = products.reshape(P // C, C)
    ch, cl = _comp_prefix(blk.sum(axis=1))
    ph = jnp.concatenate([jnp.zeros((1,), ch.dtype), ch[:-1]])
    pl = jnp.concatenate([jnp.zeros((1,), cl.dtype), cl[:-1]])
    lane = jnp.arange(C, dtype=jnp.int32)

    # inclusive prefix at flat index i (i in [0, P)), as an (hi, lo) pair
    def at(i):
        b, q = i // C, i % C
        part = jnp.where(lane[None, :] <= q[:, None], blk[b], 0.0).sum(axis=1)
        return _df_combine((ph[b], pl[b]), (part, jnp.zeros_like(part)))

    lo32 = bounds.astype(jnp.int32)
    start = lo32[:-1]
    end = lo32[1:]
    eh, el = at(jnp.maximum(end - 1, 0))
    sh, sl = at(jnp.maximum(start - 1, 0))
    empty = end <= start
    sh = jnp.where(start == 0, 0.0, sh)
    sl = jnp.where(start == 0, 0.0, sl)
    eh = jnp.where(end == 0, 0.0, eh)
    el = jnp.where(end == 0, 0.0, el)
    out = (eh - sh) + (el - sl)
    return jnp.where(empty, 0.0, out)


def _scattered_marginal(sc_cols, sc_vals, bounds, b) -> jnp.ndarray:
    """[N] marginal contribution of the scattered pixels: sum_p v_p*b[c_p]
    per row.  Padding pixels carry v=0 and contribute nothing."""
    return _segment_sums(sc_vals * b[sc_cols], bounds)


@functools.partial(
    jax.jit,
    static_argnames=("R", "T", "ignore_diags", "mad_max", "min_nnz",
                     "min_count", "tol", "max_iters", "reduce"),
)
def hybrid_ice_balance(tiles, brow, bcol, sc_cols, sc_vals, bounds, sc_nnz,
                       n, *, R: int, T: int, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0, tol: float = 1e-5,
                       max_iters: int = 200, reduce: str = "onehot"):
    """ICE over the hybrid layout — ``sparse_ice_balance`` semantics with
    the marginal = tile matvec + scattered prefix-sum contribution.
    ``bounds``/``sc_nnz`` must be padded to R*T(+1) (1.0-free: zeros).

    Design note: a lazy variant that froze the scattered (gather-bound)
    term between refreshes via a nested traced-trip fori_loop was slower
    for the same fixed point (the dynamic inner loop defeats XLA's
    pipelining), so the loop below stays flat and exact."""
    # integer (uint16) storage rides the wire at half width and is cast to
    # f32 here, on device, before any arithmetic
    if not jnp.issubdtype(tiles.dtype, jnp.floating):
        tiles = tiles.astype(jnp.float32)
    if not jnp.issubdtype(sc_vals.dtype, jnp.floating):
        sc_vals = sc_vals.astype(tiles.dtype)
    dtype = tiles.dtype
    N = R * T

    if ignore_diags > 0:
        li = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
        lj = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
        gdiff = ((bcol - brow).astype(jnp.int32)[:, None, None] * T
                 + (lj - li)[None])
        tiles = jnp.where(jnp.abs(gdiff) < ignore_diags, 0.0, tiles)

    valid = jnp.arange(N) < n
    ones = jnp.where(valid, jnp.ones((), dtype), 0.0)

    def marginal(t, b):
        return (block_sym_matvec(t, brow, bcol, b, R=R, T=T, reduce=reduce)
                + _scattered_marginal(sc_cols, sc_vals, bounds, b))

    marg0 = marginal(tiles, ones) * ones
    nnz = (block_sym_matvec((tiles != 0).astype(dtype), brow, bcol, ones,
                            R=R, T=T, reduce=reduce) + sc_nnz)
    keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)

    if mad_max > 0:
        sel = keep & (marg0 > 0)
        logm = jnp.where(sel, jnp.log(jnp.maximum(marg0, 1e-300)), 0.0)
        med = masked_median(logm, sel)
        dev = masked_median(jnp.abs(logm - med), sel)
        cutoff = jnp.exp(med - mad_max * dev)
        keep = keep & (marg0 >= cutoff)

    b0 = jnp.where(keep, jnp.ones((), dtype), 0.0)

    def body(state):
        it, b, _, _ = state
        marg = marginal(tiles, b) * b
        nz = marg != 0
        mean_nz = masked_mean(marg, nz)
        var = masked_var(marg, nz)
        margn = marg / jnp.where(mean_nz != 0, mean_nz, 1.0)
        margn = jnp.where(margn == 0, 1.0, margn)
        return it + 1, b / margn, var, mean_nz

    def cond(state):
        it, _, var, _ = state
        return (var >= tol) & (it < max_iters)

    init = (jnp.zeros((), jnp.int32), b0, jnp.asarray(jnp.inf, dtype),
            jnp.ones((), dtype))
    iters, b, var, scale = jax.lax.while_loop(cond, body, init)

    w = b / jnp.sqrt(jnp.where(scale > 0, scale, 1.0))
    w = jnp.where(keep & (b != 0), w, jnp.nan)
    return w, {"scale": scale, "var": var, "iters": iters,
               "converged": var < tol}


def ice_balance_hybrid(h: HybridGW, **kw):
    """Convenience wrapper; returns (weights[:n], stats).

    ``ignore_diags`` must match the value the layout was BUILT with: the
    scattered part applies it at build time, the tiles on device — a
    mismatch would silently mix two diagonal-exclusion rules."""
    want = kw.get("ignore_diags", h.ignore_diags)
    if want != h.ignore_diags:
        raise ValueError(
            f"hybrid layout built with ignore_diags={h.ignore_diags}; "
            f"rebuild it to balance with ignore_diags={want}")
    kw.setdefault("ignore_diags", h.ignore_diags)
    # HICHAP_ICE_REDUCE may resolve to a strategy only the NON-hybrid
    # sparse path tests ("scatter"); clamp the hybrid default to its two parity-
    # tested reductions so an opt-in aimed at the other path cannot
    # silently reroute the production hybrid balance (review find).
    from .sparse import _resolve_reduce
    _r = _resolve_reduce()
    kw.setdefault("reduce", _r if _r in ("onehot", "scan") else "onehot")
    bm = h.bm
    N = bm.R * bm.T
    bounds = np.full(N + 1, h.bounds[-1], np.int32)
    bounds[: h.bounds.size] = h.bounds
    sc_nnz = np.zeros(N, np.float32)
    sc_nnz[: h.sc_nnz.size] = h.sc_nnz
    w, stats = hybrid_ice_balance(
        jnp.asarray(bm.tiles), jnp.asarray(bm.brow), jnp.asarray(bm.bcol),
        jnp.asarray(h.sc_cols), jnp.asarray(h.sc_vals),
        jnp.asarray(bounds), jnp.asarray(sc_nnz), jnp.asarray(h.n),
        R=bm.R, T=bm.T, **kw)
    return w[: h.n], stats
