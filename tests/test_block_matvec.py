"""Block-sparse symmetric matvec (ops/sparse.block_sym_matvec) against a
dense ``M @ x``, for every block-row reduction and both tile dtypes."""

import jax.numpy as jnp
import numpy as np
import pytest

from hichap_master_tpu.ops.sparse import (block_sym_matvec, blocks_from_dense,
                                          pad_blocks)

T = 128
REDUCES = ["onehot", "scan", "scatter"]


def _case(seed, n=300):
    """Random symmetric counts with n not a multiple of T (row padding)."""
    rng = np.random.default_rng(seed)
    M = (rng.poisson(0.3, (n, n)) * rng.uniform(0.5, 4.0, (n, n))).astype(
        np.float32)
    M = np.triu(M) + np.triu(M, 1).T
    bm = blocks_from_dense(M, T)
    x = np.zeros(bm.R * T, np.float32)
    x[:n] = rng.uniform(0.1, 2.0, n)
    return M, bm, x


def _matvec(bm, x, reduce, dtype=jnp.float32):
    return np.asarray(block_sym_matvec(
        jnp.asarray(bm.tiles, dtype), jnp.asarray(bm.brow),
        jnp.asarray(bm.bcol), jnp.asarray(x), R=bm.R, T=T, reduce=reduce))


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matvec_matches_dense(reduce, dtype):
    M, bm, x = _case(1)
    n = M.shape[0]
    y = _matvec(bm, x, reduce, getattr(jnp, dtype))
    if dtype == "bfloat16":
        # bf16 tiles and inputs, float32 accumulation: the reference rounds
        # the same operands and sums exactly
        r16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)
        want = r16(M) @ r16(x[:n])
    else:
        want = M.astype(np.float64) @ x[:n].astype(np.float64)
    np.testing.assert_allclose(y[:n], want, rtol=1e-5, atol=1e-4)
    assert not y[n:].any(), "padded rows must stay zero"


@pytest.mark.parametrize("reduce", REDUCES)
def test_block_matvec_pad_group_remainder(reduce):
    """Tile counts padded to a multiple (zero tiles at block (0, 0)) must
    contribute nothing, whatever the remainder."""
    _, bm, x = _case(7, n=400)
    assert bm.K % 7 != 0
    y = _matvec(bm, x, reduce)
    y_pad = _matvec(pad_blocks(bm, 7), x, reduce)
    assert pad_blocks(bm, 7).K % 7 == 0
    np.testing.assert_allclose(y_pad, y, rtol=1e-6, atol=1e-5)
