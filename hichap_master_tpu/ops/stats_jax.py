"""On-device λ-chunked Poisson + BH-FDR for the loop caller.

The reference runs this stage on the host, per λ-chunk
(HiCHap/StructureFind.py:1869-1902).  Here the whole stage — chunk
assignment against the 2^(k/3) edge grid, Poisson survival at the chunk's
upper edge via the regularized lower incomplete gamma, and per-chunk BH via
one lexsort + a segmented reverse running-min scan — is a single jitted XLA
program, so millions of candidate pixels never bounce through a Python
loop.  Semantics match ``ops.stats.poisson_bh_chunked`` (the float64 host
oracle); device math is float32, which can flip razor-edge q ≈ sig calls —
the host path remains the default on CPU backends and under
``HICHAP_HOST_STATS=1``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc

# 2^(127/3) ≈ 5.4e12 — far above any expected contact count, so a fixed
# edge grid keeps the jitted shapes static.
_MAXBIN = 128


def _edges() -> jnp.ndarray:
    return jnp.concatenate([
        jnp.zeros((1,), jnp.float32),
        jnp.exp2(jnp.arange(_MAXBIN, dtype=jnp.float32) / 3.0),
    ])


def _segmented_reverse_cummin(vals, segs):
    """Running min from the END of each equal-``segs`` run (arrays sorted
    by segment).  Associative segmented-min scan over the reversed array."""
    v = vals[::-1]
    s = segs[::-1]

    def combine(a, b):
        av, aseg = a
        bv, bseg = b
        return jnp.where(aseg == bseg, jnp.minimum(av, bv), bv), bseg

    out, _ = jax.lax.associative_scan(combine, (v, s))
    return out[::-1]


def _pv_seg(o, e, valid):
    """Elementwise Poisson survival + λ-chunk assignment (any shape).

    Returns (pv, seg) with dead pixels at pv = 1.0, seg = -1."""
    o = o.astype(jnp.float32)
    e = e.astype(jnp.float32)
    edges = _edges()
    c = jnp.searchsorted(edges, e, side="right") - 1      # digitize - 1
    ok = valid & (c >= 0) & (c < _MAXBIN)
    ok &= e != edges[jnp.clip(c, 0, _MAXBIN)]             # open lower bound
    rv = edges[jnp.clip(c, 0, _MAXBIN - 1) + 1]
    pv = jnp.where(ok, gammainc(jnp.floor(o) + 1.0, rv), 1.0)
    return pv, jnp.where(ok, c, -1)


def _bh_segmented(pv, seg):
    """Per-segment BH q-values in one lexsort (seg == -1 → dead, q = 1)."""
    order = jnp.lexsort((pv, seg))
    ps = pv[order]
    ss = seg[order]
    live = ss >= 0
    # rank within segment and segment size
    idx = jnp.arange(ps.size)
    is_start = jnp.concatenate([jnp.ones((1,), bool), ss[1:] != ss[:-1]])
    start_idx = jnp.where(is_start, idx, 0)
    start = jax.lax.associative_scan(jnp.maximum, start_idx)
    rank = idx - start + 1
    seg_size = jnp.zeros(ps.size, jnp.int32).at[start].add(
        jnp.ones(ps.size, jnp.int32))[start]
    ranked = ps * seg_size.astype(ps.dtype) / rank.astype(ps.dtype)
    qs = jnp.clip(_segmented_reverse_cummin(ranked, ss), 0.0, 1.0)
    qs = jnp.where(live, qs, 1.0)
    return jnp.zeros_like(ps).at[order].set(qs)


@functools.partial(jax.jit)
def poisson_bh_chunked_jax(o, e, valid):
    """pv, qv for every pixel; invalid/unchunked pixels get 1.0.

    o, e : float arrays (observed counts, expected λ)
    valid: bool mask of live pixels
    """
    pv, seg = _pv_seg(o, e, valid)
    return pv, _bh_segmented(pv, seg)


@functools.partial(jax.jit, static_argnames=("ww", "e_off", "x_off"))
def _post_prep(resolved, bek, bey, epad, xpad, vpad, o_map, pE, biases,
               gap_cs, n, *, ww: int, e_off: int, x_off: int):
    """Shared per-pixel quantities for the device post-filter: observed
    counts gathered straight from the packed raw band map (never uploaded),
    expected-by-distance, bias product, the shared flavor mask, and the
    ±5-bin gap-neighborhood keep (reference bounds [p-5, p+5) clipped to
    [0, N-1), StructureFind.py:1904-1927)."""
    o = o_map[epad + e_off, xpad + x_off]
    em = pE[jnp.clip(epad - ww, 0, pE.shape[0] - 1)]
    yp = xpad + epad
    bias_xy = biases[xpad] * biases[yp]
    mask = vpad & resolved & (bek != 0) & (bey != 0)

    def has_gap(p):
        lo = jnp.where(p > 5, p - 5, 0)
        hi = jnp.where(p + 5 < n, p + 5, n - 1)
        return (gap_cs[hi] - gap_cs[lo]) > 0

    gk = ~(has_gap(xpad) | has_gap(yp))
    return o, em, bias_xy, mask, gk


@jax.jit
def _flavor_e(bs, be, em, bias_xy, mask):
    """Per-flavor expected value + validity (background ratio x biases)."""
    brv = jnp.where(be != 0, bs / jnp.where(be != 0, be, 1.0), 0.0)
    e = em * brv * bias_xy
    return e, mask & (brv != 0) & (e > 0)


@functools.partial(jax.jit, static_argnames=("cap_out",))
def _flavor_compact(qv, pv, val, gk, o, e, xpad, yp, sig, *, cap_out: int):
    """Survivor selection + fixed-size compaction for one flavor."""
    P2 = qv.shape[0]
    surv = val & (qv <= sig) & gk
    idx = jnp.sort(jnp.where(surv, jnp.arange(P2, dtype=jnp.int32),
                             P2))[:cap_out]
    safe = jnp.clip(idx, 0, P2 - 1)
    fold = o / jnp.where(e == 0, 1.0, e)
    return (jnp.sum(surv.astype(jnp.int32)), idx, xpad[safe], yp[safe],
            o[safe], fold[safe], pv[safe], qv[safe])


@functools.partial(jax.jit, static_argnames=("ww", "e_off", "x_off"))
def _post_prep_batch(resolved, bek, bey, epad, xpad, vpad, o_map, pE,
                     biases, gap_cs, ns, *, ww: int, e_off: int,
                     x_off: int):
    def one(rv, ek, ey, ep, xp, vp, om, pe, bi, gc, n):
        return _post_prep(rv, ek, ey, ep, xp, vp, om, pe, bi, gc, n,
                          ww=ww, e_off=e_off, x_off=x_off)

    return jax.vmap(one)(resolved, bek, bey, epad, xpad, vpad, o_map, pE,
                         biases, gap_cs, ns)


@jax.jit
def poisson_bh_chunked_jax_batch(o, e, valid):
    """poisson_bh_chunked_jax over a leading chromosome axis — ONE dispatch.

    The chromosome id folds into the λ-chunk segment key and the whole
    [G, P2] group flattens into a single segmented lexsort; per-segment BH
    over disjoint segments equals the per-chromosome result exactly: one
    standard sort program instead of G independent [P2] sort graphs."""
    G, P2 = o.shape
    pv, seg = _pv_seg(o, e, valid)
    g = jnp.arange(G, dtype=jnp.int32)[:, None]
    segf = jnp.where(seg >= 0, g * _MAXBIN + seg, -1).reshape(-1)
    qv = _bh_segmented(pv.reshape(-1), segf).reshape(G, P2)
    return pv, qv


@functools.partial(jax.jit, static_argnames=("cap_out",))
def _flavor_compact_batch(qv, pv, val, gk, o, e, xpad, yp, sig, *,
                          cap_out: int):
    def one(q, p, v, g, oo, ee, xp_, yy):
        return _flavor_compact(q, p, v, g, oo, ee, xp_, yy, sig,
                               cap_out=cap_out)

    return jax.vmap(one)(qv, pv, val, gk, o, e, xpad, yp)


def loop_post_compact_batch(resolved, bsk, bek, bsy, bey, epad, xpad, vpad,
                            o_map, pE, biases, gap_cs, ns, sig, *,
                            ww: int, e_off: int, x_off: int, cap_out: int):
    """``loop_post_compact`` for a whole same-shape chromosome group in
    ONE dispatch per stage and (at the caller) one host fetch instead of
    ~7 calls x 23 chromosomes of per-call round trips.  All leading axes
    are the group axis; ``ns`` is the per-chromosome bin count.  Same
    split-jit composition (not one fused graph) as the single-chromosome
    path, for the same compile-time reason."""
    o, em, bias_xy, mask, gk = _post_prep_batch(
        resolved, bek, bey, epad, xpad, vpad, o_map, pE, biases, gap_cs,
        ns, ww=ww, e_off=e_off, x_off=x_off)
    yp = epad + xpad


    def flavor(bs, be):
        e, val = _flavor_e(bs, be, em, bias_xy, mask)  # elementwise: batches
        pv, qv = poisson_bh_chunked_jax_batch(o, e, val)
        return _flavor_compact_batch(qv, pv, val, gk, o, e, xpad, yp, sig,
                                     cap_out=cap_out)

    return flavor(bsk, bek), flavor(bsy, bey)


def loop_post_compact(resolved, bsk, bek, bsy, bey, epad, xpad, vpad,
                      o_map, pE, biases, gap_cs, n, sig, *,
                      ww: int, e_off: int, x_off: int, cap_out: int):
    """Device-resident loop post-filter with survivor compaction.

    Runs the whole of the reference's post-escalation stage
    (StructureFind.py:1869-1946) on device for both background flavors —
    background-ratio masks, expected scaling by balance biases, Poisson
    survival, per-λ-chunk BH, q ≤ sig rejection, ±5-bin gap-neighborhood
    removal — and returns only COMPACTED survivors.  Rationale: the
    per-pixel arrays are [P2] ≈ millions; shipping them (plus p/q) to the
    host dominated the loop stage wall time on the first accelerator.
    Survivors are a few thousand: each flavor
    returns (count, idx, xi, yi, o, fold, p, q) sliced to ``cap_out``
    (callers must fall back to the host path when count > cap_out).

    Deliberately NOT one fused jit: the composition stays Python so the
    λ-chunk BH program — the big graph, typically already compiled for
    these [P2] shapes — is reused as-is; a single fused graph at chr1
    scale took far longer to compile.  Intermediates stay on device
    between the pieces, so the split costs only dispatch overhead.

    resolved..bey : [P2] escalation outputs (still on device)
    epad/xpad/vpad: [P2] pixel coordinates/validity (the escalation inputs)
    o_map         : [E, Xp] packed raw band map (models/loops._packed_inputs)
    pE            : [num-ww] expected-by-distance curve
    biases        : [>=n] per-bin balance biases (1/weights)
    gap_cs        : [>=n] exclusive prefix count of gap bins
    n, sig        : traced scalars (bin count, significance level)
    """
    o, em, bias_xy, mask, gk = _post_prep(
        resolved, bek, bey, epad, xpad, vpad, o_map, pE, biases, gap_cs,
        n, ww=ww, e_off=e_off, x_off=x_off)
    yp = epad + xpad

    def flavor(bs, be):
        e, val = _flavor_e(bs, be, em, bias_xy, mask)
        pv, qv = poisson_bh_chunked_jax(o, e, val)
        return _flavor_compact(qv, pv, val, gk, o, e, xpad, yp, sig,
                               cap_out=cap_out)

    return flavor(bsk, bek), flavor(bsy, bey)
