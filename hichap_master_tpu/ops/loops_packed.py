"""Packed-band loop stencils: donut/lower-left sums in O(band) memory.

The contact band at 10 kb is ~1% of the dense matrix (N×num vs N², num =
maxapart/res + maxww + 1 ≈ 221), so full-matrix prefix stencils
(ops/loops_kernel.py) waste two orders of magnitude of bandwidth.  This
module works entirely in the packed layout ``D[e, x] = M[x, x+e]``:

  rect(x, y=x+e; Δr∈[r0,r1], Δc∈[c0,c1])
      = Σ_{Δr,Δc} M[x+Δr, x+e+Δc]
      = Σ_{Δr,Δc} D[e+Δc−Δr, x+Δr]

With ``R`` = prefix of D over e and ``W[e,x] = Σ_{k≥0} R[e−k, x+k]`` (an
anti-diagonal prefix computed by one lax.scan), every rectangle becomes
FOUR statically-shifted slices of W:

  rect[e, x] =  W[e+c1−r0, x+r0] − W[e+c1−r1−1, x+r1+1]
             − W[e+c0−1−r0, x+r0] + W[e+c0−1−r1−1, x+r1+1]

so the complete HICCUPS escalation ladder (all window widths, all regions,
all pixels) costs a few hundred slice-adds over [E, N] arrays — megabytes,
not gigabytes.  Verified against the brute-force region oracle and the
full-matrix stable path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# margins so every shifted slice stays in-bounds: e shifts by at most
# ±(2*maxww+1), x shifts by at most maxww+1.


def pack_margins(maxww: int):
    e_lo = 2 * maxww + 2   # extra rows below logical e=0
    e_hi = 2 * maxww + 2   # extra rows above logical e=B-1
    x_pad = maxww + 2
    return e_lo, e_hi, x_pad


def _pack_coo_core(rows, cols, vals, B: int, Xp: int, e_lo: int,
                   x_pad: int):
    rows = rows.astype(jnp.int32)
    cols = cols.astype(jnp.int32)
    vals = vals.astype(jnp.float32)
    e = cols - rows
    ok = (e >= 0) & (e < B)
    er = jnp.where(ok, e + e_lo, 0)
    xr = jnp.where(ok, rows + x_pad, 0)
    D = jnp.zeros((B + 2 * e_lo, Xp), jnp.float32)
    return D.at[er, xr].add(jnp.where(ok, vals, 0.0))


@functools.partial(jax.jit, static_argnames=("B", "Xp", "e_lo", "x_pad",
                                             "ww"))
def pack_raw_bal(row, d, bv, w, *, B: int, Xp: int, e_lo: int, x_pad: int,
                 ww: int):
    """Packed raw + balanced band maps from the SLIM band COO.

    Upload-minimal form of two ``pack_coo`` calls: the host ships only
    (row uint16/int32, diagonal uint8/uint16, raw value uint16/f32 — the
    narrow forms when the chromosome's bins and counts fit them) plus the
    per-bin balance weights [n] (NaN at filtered bins, cooler semantics);
    the balanced values ``bv * w[x] * w[x+d]`` (NaN→0) are computed on
    device.  Raw keeps d > 0 (diagonal removed), balanced keeps d >= ww —
    the same masks models/loops._packed_inputs applied host-side.
    """
    e = d.astype(jnp.int32)
    x = row.astype(jnp.int32)
    bv = bv.astype(jnp.float32)
    ok = e < B  # e >= 0 by construction (unsigned diagonal)
    er = jnp.where(ok, e + e_lo, 0)
    xr = jnp.where(ok, x + x_pad, 0)
    base = jnp.zeros((B + 2 * e_lo, Xp), jnp.float32)
    nmax = w.shape[0] - 1
    wv = bv * w[jnp.clip(x, 0, nmax)] * w[jnp.clip(x + e, 0, nmax)]
    wv = jnp.nan_to_num(wv)
    D_raw = base.at[er, xr].add(jnp.where(ok & (e > 0), bv, 0.0))
    D_bal = base.at[er, xr].add(jnp.where(ok & (e >= ww), wv, 0.0))
    return D_raw, D_bal


def _derive_pixels_core(row, d, keep, npix, *, ww: int, dmax: int,
                        P2: int):
    """One body for the masked/unmasked pixel derivations — a drifted
    duplicate here would silently split the allelic and non-allelic
    semantics."""
    cap = row.shape[0]
    e = d.astype(jnp.int32)
    sel = (e >= ww) & (e <= dmax)
    if keep is not None:
        sel = sel & keep
    idx = jnp.sort(jnp.where(sel, jnp.arange(cap, dtype=jnp.int32),
                             cap))[:P2]
    safe = jnp.clip(idx, 0, cap - 1)
    vp = jnp.arange(P2, dtype=jnp.int32) < npix
    ep = jnp.where(vp, e[safe], 0)
    xp = jnp.where(vp, row[safe].astype(jnp.int32), 0)
    return ep, xp, vp


@functools.partial(jax.jit, static_argnames=("ww", "dmax", "P2"))
def derive_pixels(row, d, npix, *, ww: int, dmax: int, P2: int):
    """Candidate pixel arrays (epad, xpad, vpad) derived ON DEVICE from
    the already-uploaded slim band COO instead of uploading three more
    [P2] arrays.  Selection d ∈ [ww, dmax] preserves COO order (a stable
    index sort), so the result matches the host arrays element-for-element
    (models/loops._pcaller_prep).  Band padding rows carry d = 0 < ww and
    are never selected."""
    return _derive_pixels_core(row, d, None, npix, ww=ww, dmax=dmax, P2=P2)


@functools.partial(jax.jit, static_argnames=("ww", "dmax", "P2"))
def derive_pixels_masked(row, d, keep, npix, *, ww: int, dmax: int,
                         P2: int):
    """derive_pixels with an extra host-computed keep mask over the band
    order (the allelic pre-filter, models/loops._allelic_prefilter)."""
    return _derive_pixels_core(row, d, keep, npix, ww=ww, dmax=dmax, P2=P2)


@functools.partial(jax.jit, static_argnames=("B", "Xp", "e_lo", "x_pad",
                                             "ww"))
def pack_raw_bal_batch(row, d, bv, w, *, B: int, Xp: int, e_lo: int,
                       x_pad: int, ww: int):
    """pack_raw_bal over a leading chromosome axis (one dispatch per
    same-shape group instead of one per chromosome)."""
    def one(r, dd, v, wv):
        return pack_raw_bal(r, dd, v, wv, B=B, Xp=Xp, e_lo=e_lo,
                            x_pad=x_pad, ww=ww)

    return jax.vmap(one)(row, d, bv, w)


@functools.partial(jax.jit, static_argnames=("ww", "dmax", "P2"))
def derive_pixels_batch(row, d, npix, *, ww: int, dmax: int, P2: int):
    def one(r, dd, n):
        return derive_pixels(r, dd, n, ww=ww, dmax=dmax, P2=P2)

    return jax.vmap(one)(row, d, npix)


@functools.partial(jax.jit, static_argnames=("ww", "dmax", "P2"))
def derive_pixels_masked_batch(row, d, keep, npix, *, ww: int, dmax: int,
                               P2: int):
    def one(r, dd, k, n):
        return derive_pixels_masked(r, dd, k, n, ww=ww, dmax=dmax, P2=P2)

    return jax.vmap(one)(row, d, keep, npix)


@functools.partial(jax.jit, static_argnames=("B", "Xp", "e_lo", "x_pad"))
def pack_coo(rows, cols, vals, B: int, Xp: int, e_lo: int, x_pad: int):
    """Scatter upper-band COO into the packed layout [e_lo+B+e_hi, Xp].

    Logical (e, x) lives at [e + e_lo, x + x_pad].  Out-of-band entries
    (e<0 or e>=B) scatter into a dead row.
    """
    return _pack_coo_core(rows, cols, vals, B, Xp, e_lo, x_pad)


@jax.jit
def anti_diagonal_prefix(D: jnp.ndarray) -> jnp.ndarray:
    """W[e, x] = R[e, x] + W[e-1, x+1], R = cumsum of D over e."""
    R = jnp.cumsum(D, axis=0)

    def step(carry, r_row):
        w_row = r_row + jnp.concatenate(
            [carry[1:], jnp.zeros((1,), carry.dtype)])
        return w_row, w_row

    init = jnp.zeros((D.shape[1],), D.dtype)
    _, W = jax.lax.scan(step, init, R)
    return W


def _shift2(W: jnp.ndarray, de: int, dx: int) -> jnp.ndarray:
    """T[e, x] = W[e + de, x + dx] with zero fill (static shifts)."""
    E, X = W.shape
    out = jnp.zeros_like(W)
    es0, es1 = max(de, 0), min(E + de, E)
    xs0, xs1 = max(dx, 0), min(X + dx, X)
    if es0 >= es1 or xs0 >= xs1:
        return out
    block = W[es0:es1, xs0:xs1]
    return out.at[es0 - de : es1 - de, xs0 - dx : xs1 - dx].set(block)


def rect_map(W: jnp.ndarray, r0: int, r1: int, c0: int, c1: int
             ) -> jnp.ndarray:
    """Rectangle-sum map over the packed domain (same indexing as W)."""
    return (_shift2(W, c1 - r0, r0) - _shift2(W, c1 - r1 - 1, r1 + 1)
            - _shift2(W, c0 - 1 - r0, r0) + _shift2(W, c0 - 1 - r1 - 1,
                                                    r1 + 1))


def donut_map(W: jnp.ndarray, w: int, pw: int) -> jnp.ndarray:
    return (rect_map(W, -w, w, -w, w)
            - rect_map(W, 0, 0, -w, w)
            - rect_map(W, -w, w, 0, 0)
            - rect_map(W, -pw, pw, -pw, pw)
            + rect_map(W, 0, 0, -pw, pw)
            + rect_map(W, -pw, pw, 0, 0))


def lowerleft_map(W: jnp.ndarray, w: int, pw: int) -> jnp.ndarray:
    return rect_map(W, 1, w, -w, -1) - rect_map(W, 1, pw, -pw, -1)


def _escalation_core(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                     ww: int, maxww: int, pw: int, e_lo: int, x_pad: int):
    W_raw = anti_diagonal_prefix(D_raw)
    W_bal = anti_diagonal_prefix(D_bal)
    W_exp = anti_diagonal_prefix(D_exp)

    er = e_pix + e_lo
    xr = x_pix + x_pad

    reads_all, vals_all = [], []
    for w in range(ww, maxww + 1):
        reads_all.append(lowerleft_map(W_raw, w, pw)[er, xr])
        vals_all.append(jnp.stack([
            donut_map(W_bal, w, pw)[er, xr],
            donut_map(W_exp, w, pw)[er, xr],
            lowerleft_map(W_bal, w, pw)[er, xr],
            lowerleft_map(W_exp, w, pw)[er, xr],
        ]))
    reads = jnp.stack(reads_all)          # [L, P]
    vals = jnp.stack(vals_all)            # [L, 4, P]

    def step(carry, inp):
        remaining, stopped = carry
        reads_w = inp
        newly = remaining & (reads_w >= 16) & ~stopped
        ini = jnp.maximum(jnp.sum(remaining & ~stopped), 1)
        ratio = jnp.sum(newly) / ini
        remaining = remaining & ~newly
        stopped = stopped | (ratio < 0.1)
        return (remaining, stopped), newly

    (_, _), newly = jax.lax.scan(step, (valid, jnp.asarray(False)), reads)
    resolved = jnp.any(newly, axis=0)
    picked = jnp.sum(jnp.where(newly[:, None, :], vals, 0.0), axis=0)
    return resolved, picked[0], picked[1], picked[2], picked[3]


@functools.partial(jax.jit,
                   static_argnames=("ww", "maxww", "pw", "B", "e_lo",
                                    "x_pad"))
def escalation_packed(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                      ww: int, maxww: int, pw: int, B: int, e_lo: int,
                      x_pad: int):
    """Full escalation ladder over packed bands; returns per-pixel values.

    e_pix/x_pix are logical packed coordinates of the candidate pixels.
    Semantics identical to models.loops._escalation_device
    (StructureFind.py:1777-1830).
    """
    return _escalation_core(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                            ww, maxww, pw, e_lo, x_pad)


def _escalation_maps_core(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                          ww: int, maxww: int, pw: int, e_lo: int,
                          x_pad: int):
    """Escalation ladder computed in MAP space.

    The per-pixel formulation gathers 5 maps × L levels at every candidate
    pixel (~80M gathers for a dense 10 kb band — measured gather-bound,
    ~1.3 s/chromosome on the first accelerator).  Here the stopping rule runs on [E, Xp]
    mask maps (a few MB) and per-pixel values gather ONCE at the end —
    identical semantics, ~10× less device time.
    """
    E, Xp = D_raw.shape
    er = jnp.where(valid, e_pix + e_lo, 0)
    xr = jnp.where(valid, x_pix + x_pad, 0)
    # candidate-cell mask: scatter the pixel set (padding/allelic-dropped
    # pixels carry valid=False and land on the dead cell (0, 0))
    pixmask = jnp.zeros((E, Xp), jnp.uint8).at[er, xr].max(
        valid.astype(jnp.uint8)) > 0

    W_raw = anti_diagonal_prefix(D_raw)
    W_bal = anti_diagonal_prefix(D_bal)
    W_exp = anti_diagonal_prefix(D_exp)

    remaining = pixmask
    stopped = jnp.asarray(False)
    resolved_map = jnp.zeros((E, Xp), bool)
    acc = [jnp.zeros((E, Xp), jnp.float32) for _ in range(4)]
    for w in range(ww, maxww + 1):
        reads = lowerleft_map(W_raw, w, pw)
        newly = remaining & (reads >= 16) & ~stopped
        ini = jnp.maximum(jnp.where(stopped, 0, jnp.sum(remaining)), 1)
        ratio = jnp.sum(newly) / ini
        remaining = remaining & ~newly
        stopped = stopped | (ratio < 0.1)
        resolved_map = resolved_map | newly
        for a_i, v in enumerate((donut_map(W_bal, w, pw),
                                 donut_map(W_exp, w, pw),
                                 lowerleft_map(W_bal, w, pw),
                                 lowerleft_map(W_exp, w, pw))):
            acc[a_i] = acc[a_i] + jnp.where(newly, v, 0.0)

    resolved = resolved_map[er, xr] & valid
    return (resolved, acc[0][er, xr], acc[1][er, xr], acc[2][er, xr],
            acc[3][er, xr])


@functools.partial(jax.jit,
                   static_argnames=("ww", "maxww", "pw", "B", "e_lo",
                                    "x_pad"))
def escalation_packed_maps(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                           ww: int, maxww: int, pw: int, B: int,
                           e_lo: int, x_pad: int):
    """Map-space escalation (drop-in for escalation_packed)."""
    return _escalation_maps_core(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                                 ww, maxww, pw, e_lo, x_pad)


@functools.partial(jax.jit,
                   static_argnames=("ww", "maxww", "pw", "B", "e_lo",
                                    "x_pad"))
def escalation_packed_maps_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                                 ww: int, maxww: int, pw: int, B: int,
                                 e_lo: int, x_pad: int):
    """Map-space escalation over a leading chromosome axis."""
    return jax.vmap(
        lambda dr, db, de, ep, xp, v: _escalation_maps_core(
            dr, db, de, ep, xp, v, ww, maxww, pw, e_lo, x_pad)
    )(D_raw, D_bal, D_exp, e_pix, x_pix, valid)


@functools.partial(jax.jit,
                   static_argnames=("ww", "maxww", "pw", "B", "e_lo",
                                    "x_pad"))
def escalation_packed_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                            ww: int, maxww: int, pw: int, B: int,
                            e_lo: int, x_pad: int):
    """Escalation over a leading chromosome axis — one dispatch per size
    bucket instead of one per chromosome (all inputs gain a [C, ...] dim).
    The ≥16-reads / <10% stopping rule runs independently per chromosome,
    matching the reference's per-chromosome pcaller loop
    (StructureFind.py:1634-1946)."""
    return jax.vmap(
        lambda dr, db, de, ep, xp, v: _escalation_core(
            dr, db, de, ep, xp, v, ww, maxww, pw, e_lo, x_pad)
    )(D_raw, D_bal, D_exp, e_pix, x_pix, valid)
