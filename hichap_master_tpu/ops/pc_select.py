"""Device-side PC selection for compartment calling.

``select_pc_new`` (StructureFind.py:374-423) needs the full correlation and
O/E matrices; pulling those to host costs seconds per chromosome over a
host link (~150 MB each at 10 kb).  This module evaluates the same
heuristics as masked reductions on device, so only the chosen signed PC
(a few KB) ever leaves the chip.  Host-side parity implementation:
models/compartment.select_pc_new.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp



def _means_minus(cor: jnp.ndarray, pc: jnp.ndarray, valid: jnp.ndarray,
                 eps: float = 1e-5) -> jnp.ndarray:
    """Within-A/B minus cross-AB correlation contrast (0 on degenerate
    splits), device version of StructureFind.py:375-402."""
    mask_a = (pc > 0) & valid
    mask_b = (pc < 0) & valid
    n_a = jnp.sum(mask_a)
    n_b = jnp.sum(mask_b)

    idx = jnp.arange(pc.shape[0])
    big = pc.shape[0] * 2
    a_min = jnp.min(jnp.where(mask_a, idx, big))
    a_max = jnp.max(jnp.where(mask_a, idx, -1))
    b_min = jnp.min(jnp.where(mask_b, idx, big))
    b_max = jnp.max(jnp.where(mask_b, idx, -1))
    size_a = a_max - a_min
    size_b = b_max - b_min
    lens = jnp.maximum(a_max, b_max) - jnp.minimum(a_min, b_min)

    aa = mask_a[:, None] & mask_a[None, :]
    bb = mask_b[:, None] & mask_b[None, :]
    ab = mask_a[:, None] & mask_b[None, :]
    in_same = (cor > -1) & (cor < 1 - eps)
    in_ab = (cor > -1) & (cor < 1)

    sel_same = (aa | bb) & in_same
    sel_ab = ab & in_ab
    cnt_same = jnp.sum(sel_same)
    cnt_ab = jnp.sum(sel_ab)
    mean_same = jnp.sum(jnp.where(sel_same, cor, 0.0)) / jnp.maximum(cnt_same, 1)
    mean_ab = jnp.sum(jnp.where(sel_ab, cor, 0.0)) / jnp.maximum(cnt_ab, 1)

    bad = ((n_a == 0) | (n_b == 0) | (cnt_ab == 0) | (cnt_same == 0)
           | (mean_ab == 0) | (mean_ab == -1)
           | (size_a <= lens / 2) | (size_b <= lens / 2))
    return jnp.where(bad, 0.0, mean_same - mean_ab)


def _orient_ab(oe: jnp.ndarray, pc: jnp.ndarray,
               valid: jnp.ndarray) -> jnp.ndarray:
    """Flip so the A side (higher intra-O/E nonzero mean) is positive
    (StructureFind.py:403-414)."""
    mask_a = (pc > 0) & valid
    mask_b = (pc < 0) & valid
    aa = mask_a[:, None] & mask_a[None, :] & (oe != 0)
    bb = mask_b[:, None] & mask_b[None, :] & (oe != 0)
    cnt_a = jnp.sum(aa)
    cnt_b = jnp.sum(bb)
    mean_a = jnp.sum(jnp.where(aa, oe, 0.0)) / jnp.maximum(cnt_a, 1)
    mean_b = jnp.sum(jnp.where(bb, oe, 0.0)) / jnp.maximum(cnt_b, 1)
    flip = (cnt_a > 0) & (cnt_b > 0) & (mean_b > mean_a)
    return jnp.where(flip, -pc, pc)


@jax.jit
def select_pc_new_device(cor: jnp.ndarray, oe_ng: jnp.ndarray,
                         pcs: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Pick + orient the compartment PC fully on device.

    cor   : [N, N] correlation over non-gap columns (padded)
    oe_ng : [N, N] O/E restricted to non-gap rows/cols (padded)
    pcs   : [k, N] candidate components
    g     : true non-gap count
    """
    valid = jnp.arange(cor.shape[0]) < g
    scores = jax.vmap(lambda pc: _means_minus(cor, pc, valid))(pcs)
    best = jnp.argmax(jnp.where(scores > 0, scores, 0.0))
    # reference keeps index 0 when every score is <= 0
    pc = pcs[best]
    return _orient_ab(oe_ng, pc, valid)
