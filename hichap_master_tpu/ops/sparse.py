"""Block-sparse (tiled-COO) genome-wide contact matrices.

Why this exists: the genome-wide contact matrix at 10 kb is ~304k bins for
hg19; dense float32 would be ~370 GB — far beyond one accelerator's memory
(80 GB on an H100) and beyond four of them.  The reference sidesteps
the problem by restricting genome-wide matrices to coarse resolutions
(wholeRes >= 500 kb, README.md:312-318) and shelling the balancing out to
``cooler balance``, which streams pixels from HDF5 on the host
(HiCHap/matrixBuilding.py:699-714).  Here the genome-wide matrix stays
**resident in device memory as dense T x T tiles at occupied block
coordinates** — Hi-C contact mass concentrates near the diagonal, so the
occupied-tile count grows linearly (band width x genome length), not
quadratically.

Layout
------
``tiles [K, T, T]`` dense tile values, ``brow/bcol [K]`` block coordinates
with ``brow <= bcol``.  Diagonal tiles (brow == bcol) are stored *full*
(mirrored inside the tile); off-diagonal tiles store the upper block only
and contribute their transpose implicitly.  The matvec is then

    y[brow] += tile @ x[bcol]          (all tiles)
    y[bcol] += tile^T @ x[brow]        (off-diagonal tiles)

— batched [K,T,T]x[K,T] contractions followed by a block-row reduction.
The reduction runs as a one-hot [R,K] @ [K,T] matmul by default: a matmul
contraction over the tile axis is exactly what GSPMD partitions into a
``psum`` when the tile axis is sharded over a device mesh, so the same code
path runs on one device or several.  Which reduction is fastest on the
H100 is not measured yet.

The asymmetric variant (``U``/``L`` tile pairs) carries the
single-triangle-imputed genome-wide haplotype matrix through the reference's
row-scale -> triangle-fold -> VC(2/3) correction
(HiCHap/matrixBuilding.py:857-901) without ever materializing the dense
matrix; see ``sparse_genomewide_correction``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .masked import masked_mean, masked_median, masked_var


@dataclasses.dataclass
class BlockMatrix:
    """Symmetric block-sparse matrix (see module docstring for the layout)."""

    tiles: np.ndarray | jnp.ndarray  # [K, T, T]
    brow: np.ndarray | jnp.ndarray   # [K] int32, brow <= bcol
    bcol: np.ndarray | jnp.ndarray   # [K] int32
    n: int                           # true bin count (R*T >= n)
    T: int                           # tile size
    R: int                           # block rows

    @property
    def K(self) -> int:
        return int(self.tiles.shape[0])

    def nbytes(self) -> int:
        return int(np.prod(self.tiles.shape)) * self.tiles.dtype.itemsize

    def dense_nbytes(self) -> int:
        return self.n * self.n * self.tiles.dtype.itemsize


def _block_shape(n: int, T: int) -> int:
    return (n + T - 1) // T


def blocks_from_coo(rows, cols, vals, n: int, T: int = 128,
                    dtype=np.float32) -> BlockMatrix:
    """Build symmetric block storage from upper-triangle COO (rows <= cols).

    Host-side; tile occupancy comes from the data.  Diagonal tiles are
    mirrored to full symmetric form.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, dtype)
    if rows.size and (rows > cols).any():
        raise ValueError("blocks_from_coo expects upper-triangle pixels")
    R = _block_shape(n, T)

    br = rows // T
    bc = cols // T
    bid = br * R + bc
    uniq, inv = np.unique(bid, return_inverse=True)
    K = uniq.size
    tiles = np.zeros((max(K, 1), T, T), dtype)
    li = (rows % T).astype(np.int64)
    lj = (cols % T).astype(np.int64)
    np.add.at(tiles, (inv, li, lj), vals)
    brow = (uniq // R).astype(np.int32)
    bcol = (uniq % R).astype(np.int32)
    # mirror diagonal tiles to full symmetric form
    diag = brow == bcol
    if diag.any():
        ut = np.triu(tiles[diag], 1)
        tiles[diag] = tiles[diag] + np.swapaxes(ut, -1, -2)
    if K == 0:
        brow = np.zeros(1, np.int32)
        bcol = np.zeros(1, np.int32)
    return BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=n, T=T, R=R)


def blocks_from_dense(M: np.ndarray, T: int = 128,
                      keep_empty: bool = False) -> BlockMatrix:
    """Test helper: tile a dense symmetric matrix (drops all-zero tiles
    unless ``keep_empty``)."""
    n = M.shape[0]
    iu = np.triu_indices(n)
    v = M[iu]
    nz = v != 0 if not keep_empty else np.ones(v.size, bool)
    return blocks_from_coo(iu[0][nz], iu[1][nz], v[nz], n, T, M.dtype)


def blocks_to_dense(bm: BlockMatrix) -> np.ndarray:
    """Test helper: materialize the full symmetric matrix."""
    N = bm.R * bm.T
    M = np.zeros((N, N), np.asarray(bm.tiles).dtype)
    tiles = np.asarray(bm.tiles)
    brow = np.asarray(bm.brow)
    bcol = np.asarray(bm.bcol)
    for k in range(tiles.shape[0]):
        r0, c0 = brow[k] * bm.T, bcol[k] * bm.T
        M[r0:r0 + bm.T, c0:c0 + bm.T] += tiles[k]
        if brow[k] != bcol[k]:
            M[c0:c0 + bm.T, r0:r0 + bm.T] += tiles[k].T
    return M[:bm.n, :bm.n]


def pad_blocks(bm: BlockMatrix, multiple: int) -> BlockMatrix:
    """Pad the tile axis with zero tiles (at block (0,0) — they contribute
    nothing) so K divides a device count."""
    K = bm.K
    Kp = ((K + multiple - 1) // multiple) * multiple
    if Kp == K:
        return bm
    tiles = np.zeros((Kp,) + tuple(bm.tiles.shape[1:]),
                     np.asarray(bm.tiles).dtype)
    tiles[:K] = np.asarray(bm.tiles)
    brow = np.zeros(Kp, np.int32)
    bcol = np.zeros(Kp, np.int32)
    brow[:K] = np.asarray(bm.brow)
    bcol[:K] = np.asarray(bm.bcol)
    return BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=bm.n, T=bm.T,
                       R=bm.R)


# --------------------------------------------------------------- device ops
def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _df_combine(x, y):
    """Double-float addition (associative to ~2^-48): carries the rounding
    error of the running prefix so boundary differencing of long f32
    prefixes stays exact to ~1e-7 relative.  Canonical home of the
    compensated machinery — ops.sparse_hybrid imports it for the
    scattered-COO marginal."""
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    hi = s + e
    return hi, e - (hi - s)


def _segsum_scan(data: jnp.ndarray, seg: jnp.ndarray, R: int) -> jnp.ndarray:
    """[K, T] contributions with arbitrary segment ids -> [R, T] via
    sort + compensated inclusive prefix + boundary differencing.

    Traffic-motivated alternative to the one-hot matmul: at hg19 10 kb
    (K ~ 9.5k tiles, R ~ 2.4k block rows) each one-hot reduction reads a
    ~90 MB [R, K] f32 operand per marginal at full f32 precision; this
    form moves only a few [K, T] copies (~5 MB each) through
    a gather, a log-depth scan, and two [R+1, T] row gathers.  The sort
    aux (argsort + searchsorted) depends only on the loop-invariant block
    coordinates, so XLA's while-loop LICM hoists it out of the balancing
    loop.  Compensation matters: segment sums come from differences of a
    prefix whose magnitude is the whole-genome marginal mass (~1e8+ at
    production coverage) — a plain f32 prefix loses them to cancellation
    (same measured failure the hybrid scattered-COO path designs around).
    """
    K, T = data.shape
    perm = jnp.argsort(seg)
    bounds = jnp.searchsorted(
        seg[perm], jnp.arange(R + 1, dtype=seg.dtype)).astype(jnp.int32)
    d = data[perm]
    hi, lo = jax.lax.associative_scan(
        _df_combine, (d, jnp.zeros_like(d)), axis=0)
    z = jnp.zeros((1, T), data.dtype)
    ph = jnp.concatenate([z, hi])
    pl = jnp.concatenate([z, lo])
    return (ph[bounds[1:]] - ph[bounds[:-1]]) + (
        pl[bounds[1:]] - pl[bounds[:-1]])


def _segsum(data: jnp.ndarray, seg: jnp.ndarray, R: int,
            reduce: str) -> jnp.ndarray:
    """[K, T] contributions -> [R, T] block rows."""
    if reduce == "onehot":
        oh = (seg[None, :] == jnp.arange(R, dtype=seg.dtype)[:, None])
        return jnp.dot(oh.astype(data.dtype), data,
                       precision=jax.lax.Precision.HIGHEST)
    if reduce == "scan":
        return _segsum_scan(data, seg, R)
    return jax.ops.segment_sum(data, seg, num_segments=R)


def _resolve_reduce() -> str:
    """Single-device default reduction strategy (env-overridable for A/B
    measurement runs without code edits)."""
    import os

    env = os.environ.get("HICHAP_ICE_REDUCE", "")
    if env in ("onehot", "scan", "scatter"):
        return env
    return "onehot"


@functools.partial(jax.jit, static_argnames=("R", "T", "reduce"))
def block_sym_matvec(tiles: jnp.ndarray, brow: jnp.ndarray,
                     bcol: jnp.ndarray, b: jnp.ndarray, *,
                     R: int, T: int, reduce: str = "onehot") -> jnp.ndarray:
    """y = M @ b for the symmetric block layout; b and y are [R*T].

    bfloat16 tiles (the ``fast`` balancing mode) contract with bf16 inputs
    and float32 accumulation — halves the per-iteration memory traffic the
    matvec is bound by; f32 tiles use HIGHEST precision (the ICE
    convergence test sits near the noise floor of a bf16 or TF32
    product)."""
    xb = b.reshape(R, T)
    if tiles.dtype == jnp.bfloat16:
        xb16 = xb.astype(jnp.bfloat16)
        cr = jnp.einsum("kij,kj->ki", tiles, xb16[bcol],
                        preferred_element_type=jnp.float32)
        cc = jnp.einsum("kij,ki->kj", tiles, xb16[brow],
                        preferred_element_type=jnp.float32)
    else:
        hp = jax.lax.Precision.HIGHEST
        cr = jnp.einsum("kij,kj->ki", tiles, xb[bcol], precision=hp)
        cc = jnp.einsum("kij,ki->kj", tiles, xb[brow], precision=hp)
    off = (brow != bcol).astype(cr.dtype)
    y = _segsum(cr, brow, R, reduce) + _segsum(cc * off[:, None], bcol, R,
                                               reduce)
    return y.reshape(R * T)


def sparse_ice_balance(tiles: jnp.ndarray, brow: jnp.ndarray,
                       bcol: jnp.ndarray, n: jnp.ndarray, *,
                       R: int, T: int, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0, tol: float = 1e-5,
                       max_iters: int = 200, reduce: str | None = None,
                       fast: bool = False):
    """ICE balancing of a block-sparse symmetric matrix.

    Same semantics as ``ops.balance.ice_balance`` (cooler-default filters:
    ignore-diags 1, MAD-max 5, min-nnz 10) but the per-iteration marginal is
    a block matvec whose memory traffic is proportional to the *occupied tiles*,
    not n² — this is what makes genome-wide 10 kb balancing representable.
    Returns (weights [R*T], stats); weights NaN at filtered bins.

    reduce : block-row reduction strategy. ``None`` (default) resolves to
    ``HICHAP_ICE_REDUCE`` if set (``onehot`` / ``scan`` / ``scatter``),
    else ``"onehot"`` — XLA fuses both triangle contractions into one tile
    stream followed by a one-hot matmul reduction.  ``"scan"`` replaces
    the ~90 MB one-hot operand per reduction with a compensated prefix
    over permuted [K, T] contributions (see ``_segsum_scan``); the
    sharded multi-device path (parallel/sharding.sharded_sparse_ice) pins
    ``"onehot"`` because GSPMD partitions that matmul contraction into a
    clean psum over the tile axis.

    fast : iterate with bfloat16-stored tiles, float32 accumulation (same
    trade as ``ops.balance.ice_balance(fast=True)``: ~2x less memory traffic
    against ~1e-3 relative weight deviation — filters and convergence
    state stay float32).
    """
    # env resolution happens OUT here, before the jit boundary: the jitted
    # core's cache keys on the RESOLVED strategy, so flipping
    # HICHAP_ICE_REDUCE between calls takes effect (a review find — with
    # resolution inside the traced body, reduce=None was the cache key and
    # the first call's strategy stuck for the process lifetime)
    if reduce is None:
        reduce = _resolve_reduce()
    return _sparse_ice_balance_jit(
        tiles, brow, bcol, n, R=R, T=T, ignore_diags=ignore_diags,
        mad_max=mad_max, min_nnz=min_nnz, min_count=min_count, tol=tol,
        max_iters=max_iters, reduce=reduce, fast=fast)


@functools.partial(
    jax.jit,
    static_argnames=("R", "T", "ignore_diags", "mad_max", "min_nnz",
                     "min_count", "tol", "max_iters", "reduce", "fast"),
)
def _sparse_ice_balance_jit(tiles, brow, bcol, n, *, R, T, ignore_diags,
                            mad_max, min_nnz, min_count, tol, max_iters,
                            reduce, fast):
    dtype = tiles.dtype
    N = R * T

    # zero the ignored diagonals inside each tile (|global i - j| < d)
    if ignore_diags > 0:
        li = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
        lj = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
        # int32 is ample: |global diff| <= R*T, and R*T is a bin count
        gdiff = ((bcol - brow).astype(jnp.int32)[:, None, None] * T
                 + (lj - li)[None])
        tiles = jnp.where(jnp.abs(gdiff) < ignore_diags, 0.0, tiles)

    valid = jnp.arange(N) < n

    mv = functools.partial(block_sym_matvec, tiles, brow, bcol,
                           R=R, T=T, reduce=reduce)
    ones = jnp.where(valid, jnp.ones((), dtype), 0.0)
    marg0 = mv(ones) * ones
    # nnz per row: matvec of the 0/1 structure
    nnz = block_sym_matvec((tiles != 0).astype(dtype), brow, bcol, ones,
                           R=R, T=T, reduce=reduce)
    keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)

    if mad_max > 0:
        sel = keep & (marg0 > 0)
        logm = jnp.where(sel, jnp.log(jnp.maximum(marg0, 1e-300)), 0.0)
        med = masked_median(logm, sel)
        dev = masked_median(jnp.abs(logm - med), sel)
        cutoff = jnp.exp(med - mad_max * dev)
        keep = keep & (marg0 >= cutoff)

    b0 = jnp.where(keep, jnp.ones((), dtype), 0.0)

    mv_it = mv
    if fast:
        tiles16 = tiles.astype(jnp.bfloat16)
        mv_it = functools.partial(block_sym_matvec, tiles16, brow, bcol,
                                  R=R, T=T, reduce=reduce)

    def body(state):
        it, b, _, _ = state
        marg = mv_it(b) * b
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
    stats = {"scale": scale, "var": var, "iters": iters,
             "converged": var < tol}
    return w, stats


def ice_balance_blocks(bm: BlockMatrix, **kw):
    """Convenience wrapper taking a BlockMatrix; returns (weights[:n], stats)."""
    w, stats = sparse_ice_balance(
        jnp.asarray(bm.tiles), jnp.asarray(bm.brow), jnp.asarray(bm.bcol),
        jnp.asarray(bm.n), R=bm.R, T=bm.T, **kw)
    return w[:bm.n], stats


# ------------------------------------------------- asymmetric (imputation)
@dataclasses.dataclass
class AsymBlocks:
    """Asymmetric genome-wide matrix as (upper, transposed-lower) tile pairs.

    ``U[k][i,j] = H[brow*T+i, bcol*T+j]`` for upper-triangle pixels and
    ``L[k][i,j] = H[bcol*T+j, brow*T+i]`` for lower-triangle pixels — both in
    upper-block orientation on a shared coordinate list, so the reference's
    triangle fold ``upper = triu(H) + tril(H,-1)^T``
    (HiCHap/matrixBuilding.py:945-979 low-res regime) is exactly ``U + L``.
    """

    U: np.ndarray | jnp.ndarray      # [K, T, T]
    L: np.ndarray | jnp.ndarray      # [K, T, T]
    brow: np.ndarray | jnp.ndarray   # [K]
    bcol: np.ndarray | jnp.ndarray   # [K]
    n: int
    T: int
    R: int

    @property
    def K(self) -> int:
        return int(self.U.shape[0])


def asym_blocks_from_coo(rows, cols, vals, n: int, T: int = 128,
                         dtype=np.float32) -> AsymBlocks:
    """Build asymmetric block storage from general COO (any triangle)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, dtype)
    R = _block_shape(n, T)

    lower = rows > cols
    # canonical block coordinates: unordered pair, upper orientation
    r_c = np.where(lower, cols, rows)
    c_c = np.where(lower, rows, cols)
    br = r_c // T
    bc = c_c // T
    bid = br * R + bc
    uniq, inv = np.unique(bid, return_inverse=True)
    K = max(uniq.size, 1)
    U = np.zeros((K, T, T), dtype)
    L = np.zeros((K, T, T), dtype)
    li = (r_c % T).astype(np.int64)
    lj = (c_c % T).astype(np.int64)
    if rows.size:
        up = ~lower
        np.add.at(U, (inv[up], li[up], lj[up]), vals[up])
        np.add.at(L, (inv[lower], li[lower], lj[lower]), vals[lower])
    brow = (uniq // R).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    bcol = (uniq % R).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    return AsymBlocks(U=U, L=L, brow=brow, bcol=bcol, n=n, T=T, R=R)


def asym_blocks_to_dense(ab: AsymBlocks) -> np.ndarray:
    """Test helper: the original asymmetric matrix."""
    N = ab.R * ab.T
    M = np.zeros((N, N), np.asarray(ab.U).dtype)
    U, L = np.asarray(ab.U), np.asarray(ab.L)
    for k in range(U.shape[0]):
        r0, c0 = int(ab.brow[k]) * ab.T, int(ab.bcol[k]) * ab.T
        M[r0:r0 + ab.T, c0:c0 + ab.T] += U[k]
        M[c0:c0 + ab.T, r0:r0 + ab.T] += L[k].T
    return M[:ab.n, :ab.n]


@functools.partial(jax.jit, static_argnames=("R", "T", "vc_alpha", "reduce"))
def sparse_genomewide_correction(U: jnp.ndarray, L: jnp.ndarray,
                                 brow: jnp.ndarray, bcol: jnp.ndarray,
                                 alpha_full: jnp.ndarray, *,
                                 R: int, T: int, vc_alpha: float = 2.0 / 3.0,
                                 reduce: str = "onehot"):
    """Genome-wide two-step correction on the block-sparse layout.

    Mirrors ``ops.correct.genomewide_correction``
    (HiCHap/matrixBuilding.py:857-901): rows scaled by 1/alpha, triangles
    folded by summation, VC(2/3), rescaled to the raw total.  ``alpha_full``
    is the concatenated per-bin alpha padded to R*T with 1.0.  Returns the
    corrected *symmetric* tile tensor (same coordinates; diagonal tiles
    mirrored full) — convert with ``BlockMatrix(tiles, brow, bcol, ...)``.
    """
    dtype = U.dtype
    ab = alpha_full.reshape(R, T)
    # row scale: U rows live on the brow side, L rows on the bcol side
    Us = U / ab[brow][:, :, None]
    Ls = L / ab[bcol][:, None, :]

    # triangle fold (upper = triu + tril^T): U + L, then mirror diag tiles
    S = Us + Ls
    isdiag = (brow == bcol)[:, None, None]
    S = jnp.where(isdiag, S + jnp.swapaxes(jnp.triu(S, 1), -1, -2), S)

    # VC(2/3) over the folded symmetric matrix
    ones = jnp.ones(R * T, dtype)
    s1 = block_sym_matvec(S, brow, bcol, ones, R=R, T=T, reduce=reduce)
    f = jnp.where(s1 == 0, 1.0, s1 ** vc_alpha).reshape(R, T)
    cor = S / (f[brow][:, :, None] * f[bcol][:, None, :])

    # rescale so the corrected total matches the raw total
    raw_total = jnp.sum(U) + jnp.sum(L)
    cor_total = jnp.sum(
        block_sym_matvec(cor, brow, bcol, ones, R=R, T=T, reduce=reduce))
    rf = raw_total / jnp.maximum(cor_total, jnp.finfo(dtype).tiny)
    return rf * cor


def genomewide_correction_blocks(ab: AsymBlocks, alpha: np.ndarray,
                                 vc_alpha: float = 2.0 / 3.0,
                                 reduce: str = "onehot") -> BlockMatrix:
    """Convenience wrapper: asymmetric blocks + per-bin alpha[:n] ->
    corrected symmetric BlockMatrix."""
    N = ab.R * ab.T
    af = np.ones(N, np.asarray(ab.U).dtype)
    af[:ab.n] = np.asarray(alpha, af.dtype)[:ab.n]
    tiles = sparse_genomewide_correction(
        jnp.asarray(ab.U), jnp.asarray(ab.L), jnp.asarray(ab.brow),
        jnp.asarray(ab.bcol), jnp.asarray(af), R=ab.R, T=ab.T,
        vc_alpha=vc_alpha, reduce=reduce)
    return BlockMatrix(tiles=tiles, brow=ab.brow, bcol=ab.bcol, n=ab.n,
                       T=ab.T, R=ab.R)


def genomewide_correction_coo(rows, cols, vals, alpha: np.ndarray, n: int,
                              vc_alpha: float = 2.0 / 3.0
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Genome-wide two-step correction straight on directed COO — the
    closed form of ``sparse_genomewide_correction`` (and of
    ``ops.correct.genomewide_correction``; HiCHap/matrixBuilding.py:
    857-901) with O(nnz) memory and no tiles:

        folded[i<=j] = v(i,j)/alpha[i] + v(j,i)/alpha[j]
        f = rowsum(folded_sym) ** vc_alpha      (0 rows -> 1)
        cor = folded / (f[i] * f[j]),  rescaled to the raw total

    The tile layout is the right shape for the ITERATIVE genome-wide ICE
    (repeated matvecs want dense tiles), but this correction touches each
    pixel a constant number of times — and the imputed diploid matrix at
    10 kb carries tens of millions of *scattered* inter pixels, where
    per-occupied-tile dense storage (128x128 f32 per pixel in the worst
    case) approaches dense-scale memory.  Returns sorted upper-triangle
    (rows, cols, vals).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    a = np.ones(n, np.float64)
    a[: min(len(alpha), n)] = np.asarray(alpha, np.float64)[:n]
    scaled = vals / a[rows]

    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    keys = lo * n + hi
    from ..io.native import gw_accumulator

    acc = gw_accumulator()
    if acc is not None:
        acc.add(keys, scaled)
        k, fv = acc.export()
    else:
        order = np.argsort(keys, kind="stable")
        sk, sv = keys[order], scaled[order]
        starts = (np.r_[0, np.flatnonzero(np.diff(sk)) + 1]
                  if sk.size else np.zeros(0, np.intp))
        k = sk[starts]
        fv = np.add.reduceat(sv, starts) if sk.size else sv
    r_u, c_u = k // n, k % n

    off = r_u != c_u
    s1 = np.bincount(r_u, weights=fv, minlength=n)
    s1 += np.bincount(c_u[off], weights=fv[off], minlength=n)
    f = np.where(s1 == 0, 1.0, s1 ** vc_alpha)
    cor = fv / (f[r_u] * f[c_u])

    raw_total = float(vals.sum())
    cor_total = float(cor.sum() + cor[off].sum())
    rf = raw_total / max(cor_total, np.finfo(np.float64).tiny)
    return r_u, c_u, rf * cor


def blocks_to_coo(bm: BlockMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangle COO (rows, cols, vals) of a symmetric BlockMatrix —
    the cooler-persistence exit path (pixels stream straight to HDF5)."""
    tiles = np.asarray(bm.tiles)
    brow = np.asarray(bm.brow)
    bcol = np.asarray(bm.bcol)
    T = bm.T
    out_r, out_c, out_v = [], [], []
    li, lj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    for k in range(tiles.shape[0]):
        t = tiles[k]
        if brow[k] == bcol[k]:
            sel = (t != 0) & (lj >= li)
        else:
            sel = t != 0
        if not sel.any():
            continue
        out_r.append(brow[k] * T + li[sel])
        out_c.append(bcol[k] * T + lj[sel])
        out_v.append(t[sel])
    if not out_r:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    r = np.concatenate(out_r)
    c = np.concatenate(out_c)
    v = np.concatenate(out_v)
    ok = (r < bm.n) & (c < bm.n)
    order = np.lexsort((c[ok], r[ok]))
    return r[ok][order], c[ok][order], v[ok][order]
