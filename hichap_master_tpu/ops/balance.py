"""ICE (iterative correction) matrix balancing as a jitted device iteration.

The reference shells out to ``cooler balance --ignore-diags 1 [--cis-only]``
(HiCHap/matrixBuilding.py:699-714, 1536-1544).  Here the same algorithm runs
as a ``lax.while_loop`` of matvecs on the device — the marginal computation is
a single [N,N]x[N] matvec per iteration, and under ``shard_map`` the row-sum
becomes a ``psum`` over the mesh.

Algorithm (re-derived from cooler's published iterative-correction procedure,
matching ``cooler balance`` defaults unless noted):

1. zero out the first ``ignore_diags`` diagonals (HiCHap passes 1);
2. filter bins: row nonzero-count < ``min_nnz`` (10), row sum < ``min_count``,
   and the MAD-max outlier rule: drop bins whose marginal is below
   ``exp(median(log marg+) - mad_max * MAD(log marg+))`` with ``mad_max=5``;
3. iterate ``marg_i = sum_j M_ij b_i b_j``; divide the bias by the marginal
   normalized to its nonzero mean, until ``var(nonzero marg) < tol`` (1e-5);
4. rescale the bias by ``1/sqrt(mean nonzero marg)`` so balanced marginals
   are ~1, and set filtered bins to NaN.

Returns the cooler-compatible ``weight`` vector.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .masked import masked_mean, masked_median, masked_var, valid_row_mask


def _zero_diags(M: jnp.ndarray, ignore_diags: int) -> jnp.ndarray:
    if ignore_diags <= 0:
        return M
    N = M.shape[0]
    i = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    return jnp.where(jnp.abs(i - j) < ignore_diags, 0.0, M)


@functools.partial(
    jax.jit,
    static_argnames=("ignore_diags", "mad_max", "min_nnz", "min_count",
                     "tol", "max_iters", "fast"),
)
def ice_balance(M: jnp.ndarray, n: jnp.ndarray, *,
                ignore_diags: int = 1, mad_max: int = 5, min_nnz: int = 10,
                min_count: int = 0, tol: float = 1e-5, max_iters: int = 200,
                fast: bool = False):
    """Balance one padded symmetric matrix.  Returns (weights, stats).

    weights : [N] float, NaN at filtered/padded bins — multiply
              ``M_ij * w_i * w_j`` to get the balanced matrix.
    stats   : dict with 'scale', 'var', 'iters', 'converged'.
    fast    : store the matrix in bfloat16 for the iteration (halves memory
              traffic — ICE is bandwidth-bound).  Counts above 256 round at
              ~0.4%, so weights deviate from the float32 result by ~1e-3
              relative; use for interactive/exploratory balancing, not for
              reference-parity outputs.
    """
    dtype = M.dtype
    N = M.shape[0]
    valid = valid_row_mask(n, N)

    M0 = _zero_diags(M, ignore_diags)
    M0 = jnp.where(valid[:, None] & valid[None, :], M0, 0.0)

    # --- bin filters -----------------------------------------------------
    nnz = jnp.sum(M0 != 0, axis=1)
    marg0 = jnp.sum(M0, axis=1)
    keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)

    if mad_max > 0:
        logm = jnp.where(keep & (marg0 > 0), jnp.log(jnp.maximum(marg0, 1e-300)), 0.0)
        sel = keep & (marg0 > 0)
        med = masked_median(logm, sel)
        dev = masked_median(jnp.abs(logm - med), sel)
        cutoff = jnp.exp(med - mad_max * dev)
        keep = keep & (marg0 >= cutoff)

    b0 = jnp.where(keep, jnp.ones((), dtype), 0.0)
    M_it = M0.astype(jnp.bfloat16) if fast else M0

    # --- iteration --------------------------------------------------------
    def body(state):
        it, b, _, _ = state
        if fast:
            marg = jnp.dot(M_it, b.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32) * b
        else:
            # HIGHEST precision: the convergence test (var < 1e-5) sits near
            # the noise floor of a bf16 or TF32 product, where default
            # precision stalls the iteration.
            marg = jnp.dot(M0, b, precision=jax.lax.Precision.HIGHEST) * b
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
    stats = {
        "scale": scale,
        "var": var,
        "iters": iters,
        "converged": var < tol,
    }
    return w, stats


ice_balance_batch = jax.jit(
    jax.vmap(lambda m, n: ice_balance(m, n), in_axes=(0, 0)),
)


def balanced_matrix(M: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Apply weights; NaN weights produce NaN rows exactly like cooler's
    ``matrix(balance=True)`` (consumers call ``nan_to_num`` as the reference
    does, StructureFind.py:854)."""
    return M * w[:, None] * w[None, :]
