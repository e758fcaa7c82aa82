"""HiCHap's signature two-step bias correction, as fused jitted device ops.

Re-derivation (behavioral spec from the reference, no code reuse):

* ``coverage`` / ``gap_mask``  — HiCHap/matrixBuilding.py:904-929: a bin is a
  gap when its row coverage (fraction of nonzero entries) is below
  ``min(percentile25(nonzero coverages), 0.2)``; the low-resolution variant
  uses a fixed 0.1 threshold (matrixBuilding.py:742-753).
* ``trans2symmetry`` — matrixBuilding.py:945-979: the (possibly asymmetric,
  single-triangle-imputed) matrix is symmetrized; pairs where *both* bins are
  gaps take ``max(M_ij, M_ji)``, every other pair the average.  (The reference
  realizes this with two nested Python loops whose overwrite order yields
  exactly this rule; here it is one ``where``.)
* ``correct_vc`` — matrixBuilding.py:780-790: vanilla-coverage normalization
  ``M / (rowsum^a * colsum^a)`` with zero sums mapped to 1; HiCHap always calls
  it with a = 2/3.
* ``two_step_correction`` — matrixBuilding.py:984-1023: step 1 removes the
  allelic SNP-density bias with the per-bin factor
  ``alpha_i = (MM_i. + PM_i.) / (TM_i. + 1)`` normalized by its max over
  non-gap bins, zeros -> 1, floored at its 20th percentile over non-gap bins;
  step 2 symmetrizes and applies VC(2/3), then rescales so the corrected mean
  matches the raw mean.
* ``genomewide_correction`` — matrixBuilding.py:857-901: same two steps on the
  genome-wide haplotype matrix, with per-chromosome alpha (normalized within
  each chromosome against its own traditional matrix), the lowres gap rule,
  and a single final VC + rescale over the whole matrix.

All ops run on padded ``[N, N]`` tensors with the true size ``n`` passed as a
traced scalar, so one compiled executable serves every chromosome and the
whole batch vmaps/shards over a device mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .masked import masked_max, masked_mean, masked_percentile, valid_row_mask


def coverage(M: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Fraction of nonzero entries per row, over the true n columns."""
    nz = jnp.sum(M != 0, axis=1)
    return jnp.where(n > 0, nz / n, 0.0).astype(M.dtype)


def gap_mask(M: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Boolean gap mask per bin (True = gap).  Padded rows are gaps."""
    N = M.shape[0]
    valid = valid_row_mask(n, N)
    cov = coverage(M, n)
    thr = masked_percentile(cov, valid & (cov > 0), 25.0)
    thr = jnp.minimum(thr, jnp.asarray(0.2, M.dtype))
    return (cov < thr) | ~valid


def gap_mask_lowres(M: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Fixed-threshold (0.1) gap rule used genome-wide (matrixBuilding.py:742)."""
    N = M.shape[0]
    valid = valid_row_mask(n, N)
    cov = coverage(M, n)
    return (cov < 0.1) | ~valid


def trans2symmetry(M: jnp.ndarray, gap: jnp.ndarray,
                   valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Symmetrize a single-triangle-accumulated matrix.

    Reference semantics (matrixBuilding.py:945-979) — two distinct regimes:
      * gap array empty  -> fold the triangles by *summation*
        (``triu(M) + tril(M,-1)^T`` mirrored), keeping the diagonal;
      * gap array non-empty -> pairwise *average*, except gap x gap pairs
        which take the max; diagonal kept.
    ``valid`` restricts the emptiness test to true (unpadded) bins.
    """
    gap_true = gap if valid is None else (gap & valid)
    has_gap = jnp.any(gap_true)

    # Non-empty-gap regime: average / gap-pair max.
    avg = 0.5 * (M + M.T)
    mx = jnp.maximum(M, M.T)
    gg = gap_true[:, None] & gap_true[None, :]
    i = jax.lax.broadcasted_iota(jnp.int32, M.shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, M.shape, 1)
    diag = i == j
    gap_path = jnp.where(diag, M, jnp.where(gg, mx, avg))

    # Empty-gap regime: triangle summation fold.
    upper = jnp.triu(M) + jnp.tril(M, -1).T
    sum_path = jnp.triu(upper, 1).T + upper

    return jnp.where(has_gap, gap_path, sum_path)


def correct_vc(M: jnp.ndarray, alpha: float = 2.0 / 3.0) -> jnp.ndarray:
    """Single-pass vanilla-coverage normalization with exponent ``alpha``."""
    s1 = jnp.sum(M, axis=1) ** alpha
    s1 = jnp.where(s1 == 0, 1.0, s1)
    s2 = jnp.sum(M, axis=0) ** alpha
    s2 = jnp.where(s2 == 0, 1.0, s2)
    return M / (s1[:, None] * s2[None, :])


def _alpha_rule(alpha, nongap, dtype):
    """Normalize to the non-gap max, zeros → 1, floor at the non-gap 20th
    percentile (matrixBuilding.py:876-886) — the ONE implementation the
    intra, genome-wide dense, and margins paths all share."""
    alpha = alpha.astype(dtype)
    amax = masked_max(alpha, nongap)
    alpha = alpha / jnp.where(amax != 0, amax, 1.0)
    alpha = jnp.where(alpha == 0, 1.0, alpha)
    thr = masked_percentile(alpha, nongap, 20.0)
    return jnp.maximum(alpha, thr)


def _snp_density_alpha(TM, MM, PM, nongap_union, dtype):
    alpha = (jnp.sum(MM, axis=1) + jnp.sum(PM, axis=1)) / (jnp.sum(TM, axis=1) + 1)
    return _alpha_rule(alpha, nongap_union, dtype)


@functools.partial(jax.jit, static_argnames=("vc_alpha",))
def two_step_correction(TM: jnp.ndarray, MM: jnp.ndarray, PM: jnp.ndarray,
                        n: jnp.ndarray, vc_alpha: float = 2.0 / 3.0):
    """Two-step correction of one chromosome's maternal/paternal matrices.

    Parameters
    ----------
    TM : traditional (all-contacts) matrix, padded [N, N]
    MM, PM : imputed maternal / paternal matrices, padded [N, N]
    n : true bin count

    Returns (Nor_MM, Nor_PM, gap_M, gap_P) with gaps as boolean masks
    (padded rows are True in both masks).
    """
    dtype = MM.dtype
    N = MM.shape[0]
    valid = valid_row_mask(n, N)

    gm = gap_mask(MM, n)
    gp = gap_mask(PM, n)
    nongap_union = (~gm | ~gp) & valid

    alpha = _snp_density_alpha(TM, MM, PM, nongap_union, dtype)

    s_mm = MM / alpha[:, None]
    s_pm = PM / alpha[:, None]

    sym_mm = trans2symmetry(s_mm, gm, valid)
    sym_pm = trans2symmetry(s_pm, gp, valid)

    cor_mm = correct_vc(sym_mm, vc_alpha)
    cor_pm = correct_vc(sym_pm, vc_alpha)

    # Rescale so the corrected mean matches the raw mean over the true
    # n x n (the means share the same n*n denominator: the ratio of sums
    # IS the ratio of means, so n never appears).
    mm_rf = jnp.sum(MM) / jnp.maximum(jnp.sum(cor_mm), jnp.finfo(dtype).tiny)
    pm_rf = jnp.sum(PM) / jnp.maximum(jnp.sum(cor_pm), jnp.finfo(dtype).tiny)

    return mm_rf * cor_mm, pm_rf * cor_pm, gm, gp


two_step_correction_batch = jax.jit(
    jax.vmap(two_step_correction, in_axes=(0, 0, 0, 0)),
)


def genomewide_alpha(T_M: jnp.ndarray, M_M: jnp.ndarray, P_P: jnp.ndarray,
                     n: jnp.ndarray) -> jnp.ndarray:
    """Per-chromosome genome-wide alpha vector (matrixBuilding.py:876-886).

    Operates on one chromosome's diagonal blocks: T_M is the traditional
    intra block, M_M / P_P the haplotype intra blocks (all padded [N, N]).
    Uses the lowres gap rule.  Returns alpha of shape [N] (1.0 on padding).
    """
    dtype = M_M.dtype
    N = T_M.shape[0]
    valid = valid_row_mask(n, N)
    gap = gap_mask_lowres(T_M, n)
    nongap = ~gap & valid

    alpha = (jnp.sum(M_M, axis=1) + jnp.sum(P_P, axis=1)) / (jnp.sum(T_M, axis=1) + 1)
    alpha = _alpha_rule(alpha, nongap, dtype)
    return jnp.where(valid, alpha, 1.0)


@jax.jit
def genomewide_alpha_margins(t_rowsum: jnp.ndarray, t_rownnz: jnp.ndarray,
                             m_rowsum: jnp.ndarray, p_rowsum: jnp.ndarray,
                             n: jnp.ndarray) -> jnp.ndarray:
    """``genomewide_alpha`` from row margins instead of dense blocks.

    The alpha formula (matrixBuilding.py:876-886) touches its inputs only
    through per-row sums and the traditional block's per-row nonzero count
    (the lowres coverage/gap rule), so past the dense cap it evaluates
    straight from COO margins — no [n, n] block ever materializes.  All
    vectors padded [N], true size ``n``; returns alpha [N] (1.0 on padding).
    """
    dtype = m_rowsum.dtype
    N = t_rowsum.shape[0]
    valid = valid_row_mask(n, N)
    cov = jnp.where(n > 0, t_rownnz / n, 0.0)
    gap = (cov < 0.1) | ~valid
    nongap = ~gap & valid

    alpha = (m_rowsum + p_rowsum) / (t_rowsum + 1)
    alpha = _alpha_rule(alpha, nongap, dtype)
    return jnp.where(valid, alpha, 1.0)


@functools.partial(jax.jit, static_argnames=("vc_alpha",))
def genomewide_correction(H_M: jnp.ndarray, alpha_full: jnp.ndarray,
                          total: jnp.ndarray, vc_alpha: float = 2.0 / 3.0):
    """Whole-genome haplotype correction given the concatenated alpha vector.

    ``H_M`` is the (possibly padded) genome-wide haplotype matrix, with dead
    rows zero; ``alpha_full`` the concatenated per-bin alpha (1.0 on dead
    rows); ``total`` the true total bin count.  Mirrors
    matrixBuilding.py:895-899: scale rows by 1/alpha, symmetrize (plain
    average/transpose-fold), VC(2/3), rescale to the raw mean.
    """
    dtype = H_M.dtype
    s = H_M / alpha_full[:, None]
    # Trans2symmetryLowRes: upper = triu(M) + tril(M,-1)^T; sym = triu(up,1)^T + up
    upper = jnp.triu(s) + jnp.tril(s, -1).T
    sym = jnp.triu(upper, 1).T + upper
    cor = correct_vc(sym, vc_alpha)
    rf = jnp.sum(H_M) / jnp.maximum(jnp.sum(cor), jnp.finfo(dtype).tiny)
    # ``total`` stays in the signature for the sharded wrappers and the
    # driver's dryrun contract; the mean-ratio rescale cancels it.
    del total
    return rf * cor
