"""Chromatin-loop calling — HICCUPS-style donut test on the device.

Behavioral spec: HiCHap/StructureFind.py:1571-2373.  Stages:

1. per chromosome, isotonic-regression expected curve over balanced diagonal
   means (StructureFind.py:2027-2036);
2. donut (K) and lower-left (Y) local backgrounds for every candidate pixel,
   with the ≥16-reads window-escalation ladder (ww → maxww, abort when <10%
   of the remaining pixels resolve) — computed here as summed-area-table
   rectangle stencils gathered at candidate pixels (ops/loops_kernel.py)
   instead of the reference's per-width sparse-diagonal accumulation;
3. λ-chunked Poisson p-values + per-chunk BH-FDR at sig 0.05
   (StructureFind.py:1869-1902), gap-neighborhood (±5 bins) removal, K∩Y;
4. traditional-only selection by distance-quantile ratio and raw strength
   (``Loop_Selecting``; the reference hardcodes 40 kb at
   StructureFind.py:2078-2079 — parameterized here, see DIVERGENCES.md);
5. iterative centroid clustering with weighted-q thresholding
   (``LoopCluster``; the reference mutates a list during iteration, skipping
   elements non-deterministically — fixed here, see DIVERGENCES.md).

Allelic mode: biases = 1 (matrices already two-step corrected), gap +
zero-neighbor pixel pre-filter (the reference's ``right`` neighbor reads the
``left`` cell twice, StructureFind.py:1739-1745 — fixed), per-chromosome
15th-percentile IF·(−log10 q) final threshold.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io.cooler import CoolerReader
from ..ops.loops_kernel import (
    donut_at_stable,
    lowerleft_at_stable,
    row_prefix,
)
from ..ops.stats import isotonic_fit
from ..utils.logging import get_logger
from .compartment import _proper_unit

log = get_logger(__name__)


def _phase_on() -> bool:
    """``HICHAP_LOOP_PHASE_TIMING=1`` turns on per-phase walls for the
    pcaller (prep / upload / escalate / post), recorded via
    utils.profiling as ``loops.phase.*``.  The upload phase BLOCKS on the
    host→device transfers so a diagnostic run can split the link share
    from device compute; leave it off for timed production runs."""
    return os.environ.get("HICHAP_LOOP_PHASE_TIMING") == "1"


def _phase(name: str):
    import contextlib

    from ..utils.profiling import stage

    if _phase_on():
        return stage("loops.phase." + name)
    return contextlib.nullcontext()


def peaks_parameters(res: int):
    """Resolution-scaled widths (StructureFind.py:1575-1617)."""
    if res >= 20000:
        pw, ww = 1, 3
    elif res >= 10000:
        pw, ww = 2, 5
    else:
        pw, ww = 4, 7
    return dict(pw=pw, ww=ww, maxww=20, maxapart=2_000_000, sig=0.05)


# ------------------------------------------------------- pixel stencils
@functools.partial(jax.jit, static_argnames=("ww", "maxww", "pw"))
def _escalation_device(S1_raw, S1_exp, S1_bal, xi, yi, valid,
                       ww: int, maxww: int, pw: int):
    """The whole ≥16-reads window-escalation ladder in one device program.

    Computes every level's backgrounds, then replicates the reference's
    sequential resolution rule (StructureFind.py:1777-1830) as a scan over
    the level axis: a pixel resolves at the first level whose lower-left
    read count reaches 16; when fewer than 10% of the remaining pixels
    resolve at some level, later levels are abandoned.
    Returns (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel.
    """
    levels = list(range(ww, maxww + 1))
    reads_all, bsk_all, bek_all, bsy_all, bey_all = [], [], [], [], []
    for w in levels:
        reads_all.append(lowerleft_at_stable(S1_raw, xi, yi, w, pw))
        bsk_all.append(donut_at_stable(S1_bal, xi, yi, w, pw))
        bek_all.append(donut_at_stable(S1_exp, xi, yi, w, pw))
        bsy_all.append(lowerleft_at_stable(S1_bal, xi, yi, w, pw))
        bey_all.append(lowerleft_at_stable(S1_exp, xi, yi, w, pw))
    reads = jnp.stack(reads_all)  # [L, P]

    def step(carry, reads_w):
        remaining, stopped = carry
        newly = remaining & (reads_w >= 16) & ~stopped
        ini = jnp.maximum(jnp.sum(remaining & ~stopped), 1)
        ratio = jnp.sum(newly) / ini
        remaining = remaining & ~newly
        stopped_next = stopped | (ratio < 0.1)
        return (remaining, stopped_next), newly

    init = (valid, jnp.asarray(False))
    (_, _), newly = jax.lax.scan(step, init, reads)  # newly: [L, P] bool

    def pick(stacked):
        return jnp.sum(jnp.where(newly, jnp.stack(stacked), 0.0), axis=0)

    resolved = jnp.any(newly, axis=0)
    return (resolved, pick(bsk_all), pick(bek_all), pick(bsy_all),
            pick(bey_all))


# ----------------------------------------------------------- per chrom
@functools.partial(jax.jit, static_argnames=("P", "ww", "num"))
def _build_band_prefixes(rows, cols, vals, bal_vals, predict_pad, n,
                         P: int, ww: int, num: int):
    """Device: scatter upper-band COO into banded matrices and row-prefix
    them (raw band d∈[0,num), balanced/expected band d∈[ww,num))."""
    d = cols - rows
    raw_ok = (d > 0) & (d < num)
    bal_ok = (d >= ww) & (d < num)
    r0 = jnp.where(raw_ok, rows, 0)
    c0 = jnp.where(raw_ok, cols, 0)
    M = jnp.zeros((P, P), jnp.float32).at[r0, c0].add(
        jnp.where(raw_ok, vals, 0.0))
    r1 = jnp.where(bal_ok, rows, 0)
    c1 = jnp.where(bal_ok, cols, 0)
    C = jnp.zeros((P, P), jnp.float32).at[r1, c1].add(
        jnp.where(bal_ok, bal_vals, 0.0))
    i = jax.lax.broadcasted_iota(jnp.int32, (P, P), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (P, P), 1)
    dd = j - i
    in_band = (dd >= ww) & (dd < num) & (j < n) & (i < n)
    E = jnp.where(in_band, predict_pad[jnp.clip(dd - ww, 0, num - ww - 1)],
                  0.0)
    return row_prefix(M), row_prefix(C), row_prefix(E)


@functools.partial(jax.jit, static_argnames=("B", "Xp", "e_lo", "x_pad",
                                             "ww"))
def _pack_expected(predictE, n, B: int, Xp: int, e_lo: int, x_pad: int,
                   ww: int):
    """Packed expected band: E[e, x] = predictE[e-ww] on valid cells."""
    E = B + 2 * e_lo
    e = jax.lax.broadcasted_iota(jnp.int32, (E, Xp), 0) - e_lo
    x = jax.lax.broadcasted_iota(jnp.int32, (E, Xp), 1) - x_pad
    ok = (e >= ww) & (e < B) & (x >= 0) & (x + e < n)
    return jnp.where(ok, predictE[jnp.clip(e - ww, 0, B - ww - 1)], 0.0)


def _allelic_prefilter(xi, yi, N: int, gap: Optional[np.ndarray],
                       rows, cols, vals) -> np.ndarray:
    """Vectorized allelic pixel pre-filter (StructureFind.py:1726-1757,
    with the reference's left-cell-read-twice bug fixed — DIVERGENCES D4).

    Drops a pixel when both bins sit in the gap set, or when any in-range
    4-neighbor of (x, y) is zero/absent in the symmetric contact map.
    Neighbor lookups run as one searchsorted over the encoded COO keys
    instead of the reference's per-pixel dict probes.

    Boundary divergence (DIVERGENCES D4): the reference's ``H[xi-1][yi]``
    with ``xi == 0`` does not raise — Python negative indexing wraps to the
    LAST row, which in a banded contact map is almost always zero, so the
    reference silently drops row-0 (and column-edge) pixels.  Here an
    out-of-range neighbor counts as nonzero (keep): edge pixels are judged
    only on their in-range neighbors.
    """
    gap_mask = np.zeros(N, bool)
    if gap is not None and len(gap):
        gap_mask[np.asarray(gap, int)] = True
    both_gap = gap_mask[xi] & gap_mask[yi]

    r64 = rows.astype(np.int64)
    c64 = cols.astype(np.int64)
    keys = np.concatenate([r64 * N + c64, c64 * N + r64])
    kv = np.concatenate([vals, vals]).astype(np.float64)
    order = np.argsort(keys, kind="stable")
    skeys, svals = keys[order], kv[order]

    def _nonzero_at(qx, qy, in_range):
        q = qx.astype(np.int64) * N + qy.astype(np.int64)
        pos = np.searchsorted(skeys, q)
        posc = np.clip(pos, 0, max(skeys.size - 1, 0))
        present = (skeys.size > 0) & (skeys[posc] == q)
        hit = present & (svals[posc] != 0)
        return np.where(in_range, hit, True)

    ok = _nonzero_at(xi - 1, yi, xi - 1 >= 0)
    ok &= _nonzero_at(xi + 1, yi, xi + 1 < N)
    ok &= _nonzero_at(xi, yi + 1, yi + 1 < N)
    ok &= _nonzero_at(xi, yi - 1, yi - 1 >= 0)
    return ~both_gap & ok


def _pcaller_prep(rows, cols, vals, weights, n: int, res: int, params,
                  allelic: bool = False,
                  gap: Optional[np.ndarray] = None,
                  packed: bool = True) -> dict:
    """Host-side preparation shared by the single- and multi-chromosome
    pcaller paths: balance, expected curve, band/pixel padding.

    The 1-core host is the serial floor of the loop stage (~0.7 s x 23
    chromosomes at hg19 10 kb), so work the device path never reads is
    skipped or deferred: the balanced band / column copies (``bb``/``bc``)
    exist only for the non-packed prefix path (``packed=False``), and the
    host-post candidate-pixel arrays materialize lazily via
    ``_ensure_host_pixels`` (the device post derives pixels from the band
    COO on device and only needs them on compaction-overflow fallback)."""
    from ..core.contacts import pad_to_bucket

    pw, ww = params["pw"], params["ww"]
    maxww, maxapart, sig = params["maxww"], params["maxapart"], params["sig"]
    num = maxapart // res + maxww + 1
    N = n
    P = pad_to_bucket(n, 512)
    d_all = cols - rows

    if weights is not None:
        w = np.asarray(weights, np.float64)
        bal_vals = np.nan_to_num(vals * w[rows] * w[cols])  # cooler nan→0
        mask = np.logical_not(w == 0) | np.isnan(w)
        biases = np.zeros_like(w)
        with np.errstate(divide="ignore", invalid="ignore"):
            biases[mask] = 1.0 / w[mask]  # nan weights propagate → dropped
    else:
        bal_vals = vals.astype(np.float64)
        biases = np.ones(n)

    # expected curve from balanced diagonal means (zeros included, the
    # np.diagonal(...).mean() semantics)
    x = np.arange(ww, num)
    dsel = (d_all >= ww) & (d_all < num)
    sums = np.bincount(d_all[dsel] - ww, weights=bal_vals[dsel],
                       minlength=num - ww)
    counts = np.maximum(n - x, 1)
    cdiag_means = np.where(x < n, sums / counts, 0.0)
    ir = isotonic_fit(x, cdiag_means, increasing="auto")
    predictE = np.clip(ir.predict(x), 0, None).astype(np.float32)

    # upload only band pixels (scatter cost grows with updates); pad nnz
    # to a power of two for compiled-graph reuse across chromosomes.
    # HICHAP_LOOP_NNZ_FLOOR lifts the floor so many chromosomes share one
    # compiled shape (each distinct shape is a fresh XLA compile).
    band = (d_all >= 0) & (d_all < num)
    bn = int(band.sum())
    cap = 1 << max(bn - 1, 1).bit_length()
    cap = max(cap, int(os.environ.get("HICHAP_LOOP_NNZ_FLOOR", "1")))
    # narrow wire dtypes: rows fit uint16 for any chromosome under 65,536
    # bins, raw counts fit uint16 when integral and < 65,536 (the usual
    # case) — together with the uint8 diagonal this drops the band upload
    # from 9 to 5 bytes/pixel; the device kernels cast back to i32/f32
    # (ops/loops_packed)
    br = np.zeros(cap, np.uint16 if n <= 0xFFFF else np.int32)
    bvals = vals[band]
    narrow = (bn == 0
              or (np.issubdtype(bvals.dtype, np.integer)
                  and bvals.max(initial=0) <= 0xFFFF)
              or (bvals.max(initial=0) <= 0xFFFF
                  and not (bvals != np.floor(bvals)).any()))
    bv = np.zeros(cap, np.uint16 if narrow else np.float32)
    br[:bn] = rows[band]
    bv[:bn] = bvals
    if packed:
        bc = bb = None  # device recomputes the balanced band from bv + w32
    else:
        bc = np.zeros(cap, np.int32)
        bb = np.zeros(cap, np.float32)
        bc[:bn] = cols[band]
        bb[:bn] = bal_vals[band]
    # slim upload form: the diagonal fits uint8/uint16 and the balanced
    # values recompute on device from bv + weights (ops/loops_packed)
    bd = np.zeros(cap, np.uint8 if num <= 255 else np.uint16)
    bd[:bn] = d_all[band]
    if weights is not None:
        w32 = np.asarray(weights, np.float32)  # NaN preserved (cooler)
    else:
        w32 = np.ones(n, np.float32)

    # candidate pixels straight from the COO (diag removed by d >= ww)
    sel = (d_all >= ww) & (d_all <= maxapart // res)

    # gaps: banded raw row sums == 0 (diag-zeroed upper band)
    rs = np.bincount(rows[(d_all > 0) & (d_all < num)],
                     weights=vals[(d_all > 0) & (d_all < num)], minlength=n)
    gaps = set(np.flatnonzero(rs == 0).tolist())

    pr = dict(n=n, N=N, P=P, num=num, ww=ww, pw=pw, maxww=maxww, sig=sig,
              predictE=predictE, br=br, bc=bc, bv=bv, bb=bb, cap=cap,
              bd=bd, w32=w32, band_keep=None, dmax=maxapart // res,
              biases=biases, gaps=gaps)
    pr["_raw"] = (rows, cols, vals, d_all, sel)

    if allelic:
        _ensure_host_pixels(pr)  # the prefilter needs the pixel arrays
        keep = _allelic_prefilter(pr["xi"], pr["yi"], N, gap, rows, cols,
                                  vals)
        # the same filter in band order, for the on-device pixel derivation
        band_keep = np.zeros(cap, bool)
        band_keep[np.flatnonzero((bd[:bn] >= ww)
                                 & (bd[:bn] <= maxapart // res))[keep]] = \
            True
        pr["band_keep"] = band_keep
        for k in ("xi", "yi", "o_val", "em_val"):
            pr[k] = pr[k][keep]
        npix = pr["xi"].size
        _pad_host_pixels(pr, npix)
    else:
        npix = int(sel.sum())

    log.log(21, "observed contact number: %d", npix)
    pr["npix"] = npix
    # pad pixel arrays to a power of two so compiled graphs are reused
    # across chromosomes
    P2 = 1 << max(npix - 1, 1).bit_length()
    P2 = max(P2, int(os.environ.get("HICHAP_LOOP_NNZ_FLOOR", "1")))
    pr["P2"] = P2

    from ..ops.loops_packed import pack_margins
    e_lo, _e_hi, x_pad = pack_margins(maxww)
    Xp = pad_to_bucket(n + 2 * x_pad,
                       int(os.environ.get("HICHAP_LOOP_XP_BUCKET", "512")))
    pr.update(e_lo=e_lo, x_pad=x_pad, Xp=Xp)
    return pr


def _ensure_host_pixels(pr: dict) -> None:
    """Materialize the host-post candidate-pixel arrays on demand.

    The device post never reads them (pixels derive from the band COO on
    device), so the prep defers these O(nnz) gathers; the host post path
    and the non-packed prefix path call this first."""
    if "xi" in pr:
        return
    rows, cols, vals, d_all, sel = pr["_raw"]
    num, ww = pr["num"], pr["ww"]
    pr["xi"] = rows[sel].astype(np.int64)
    pr["yi"] = cols[sel].astype(np.int64)
    pr["o_val"] = vals[sel].astype(np.float64)
    pr["em_val"] = pr["predictE"][
        np.clip(d_all[sel] - ww, 0, num - ww - 1)].astype(np.float64)
    if "P2" in pr:  # past prep: build the padded forms too
        _pad_host_pixels(pr, pr["npix"])


def _pad_host_pixels(pr: dict, npix: int) -> None:
    xi, yi = pr["xi"], pr["yi"]
    P2 = pr.get("P2")
    if P2 is None:
        P2 = 1 << max(npix - 1, 1).bit_length()
        P2 = max(P2, int(os.environ.get("HICHAP_LOOP_NNZ_FLOOR", "1")))
    xpad = np.zeros(P2, xi.dtype)
    ypad = np.zeros(P2, yi.dtype)
    vpad = np.zeros(P2, bool)
    epad = np.zeros(P2, np.int32)
    xpad[:npix] = xi
    ypad[:npix] = yi
    vpad[:npix] = True
    epad[:npix] = (yi - xi).astype(np.int32)
    pr.update(xpad=xpad, ypad=ypad, vpad=vpad, epad=epad)


def _packed_inputs(pr: dict):
    """Packed-band device inputs + device-derived pixel arrays for one
    prepared chromosome.

    Uploads only the slim band COO — row int32, diagonal uint8/uint16,
    raw value f32 — plus the [n] weight vector; the balanced band, the
    expected map, and the candidate pixel arrays (epad/xpad/vpad) are all
    computed on device (ops/loops_packed).  At chr1 scale this drops the
    per-chromosome upload from ~100 MB (4x band arrays + 3x pixel arrays)
    to ~36 MB.  Returns (D_raw, D_bal, D_exp, epad, xpad, vpad)."""
    from ..ops.loops_packed import (derive_pixels, derive_pixels_masked,
                                    pack_raw_bal)

    row_d = jnp.asarray(pr["br"])
    d_d = jnp.asarray(pr["bd"])
    D_raw, D_bal = pack_raw_bal(row_d, d_d, jnp.asarray(pr["bv"]),
                                jnp.asarray(pr["w32"]), B=pr["num"],
                                Xp=pr["Xp"], e_lo=pr["e_lo"],
                                x_pad=pr["x_pad"], ww=pr["ww"])
    D_exp = _pack_expected(jnp.asarray(pr["predictE"]),
                           jnp.asarray(pr["n"]), pr["num"], pr["Xp"],
                           pr["e_lo"], pr["x_pad"], pr["ww"])
    npix_d = jnp.asarray(pr["npix"], jnp.int32)
    if pr.get("band_keep") is not None:
        ep, xp_, vp = derive_pixels_masked(
            row_d, d_d, jnp.asarray(pr["band_keep"]), npix_d,
            ww=pr["ww"], dmax=pr["dmax"], P2=pr["P2"])
    else:
        ep, xp_, vp = derive_pixels(row_d, d_d, npix_d, ww=pr["ww"],
                                    dmax=pr["dmax"], P2=pr["P2"])
    return D_raw, D_bal, D_exp, ep, xp_, vp


@functools.partial(jax.jit, static_argnames=("B", "Xp", "e_lo", "x_pad",
                                             "ww"))
def _pack_expected_batch(pE, ns, B: int, Xp: int, e_lo: int, x_pad: int,
                         ww: int):
    return jax.vmap(
        lambda p, n: _pack_expected(p, n, B, Xp, e_lo, x_pad, ww))(pE, ns)


def _packed_inputs_batch(prs: List[dict]):
    """_packed_inputs for a same-shape chromosome group: each stage is ONE
    batched dispatch instead of one eager dispatch per chromosome.
    Returns stacked
    (D_raw, D_bal, D_exp, epad, xpad, vpad)."""
    from ..ops.loops_packed import (derive_pixels_batch,
                                    derive_pixels_masked_batch,
                                    pack_raw_bal_batch)

    pr0 = prs[0]
    rows = np.stack([pr["br"] for pr in prs])
    if rows.dtype not in (np.uint16, np.int32):  # mixed-narrowness group
        rows = rows.astype(np.int32)
    ds_h = np.stack([pr["bd"] for pr in prs])
    bvs = np.stack([pr["bv"] for pr in prs])
    if bvs.dtype not in (np.uint16, np.float32):  # np promotion to f64
        bvs = bvs.astype(np.float32)
    maxn = max(pr["n"] for pr in prs)
    w = np.ones((len(prs), maxn), np.float32)
    for i, pr in enumerate(prs):
        w[i, : len(pr["w32"])] = pr["w32"]
    pE_h = np.stack([pr["predictE"] for pr in prs])
    keeps_h = (np.stack([pr["band_keep"] for pr in prs])
               if pr0.get("band_keep") is not None else None)
    hosts = [rows, ds_h, bvs, w, pE_h]
    if keeps_h is not None:
        hosts.append(keeps_h)
    if _phase_on():
        from ..utils.profiling import add as _madd

        _madd("loops.phase.upload_mb",
              sum(a.nbytes for a in hosts) / 2**20)
        with _phase("upload"):
            devs = [jax.device_put(a) for a in hosts]
            jax.block_until_ready(devs)
    else:
        devs = [jnp.asarray(a) for a in hosts]
    rows, ds, bvs, w_d, pE = devs[:5]
    keeps = devs[5] if keeps_h is not None else None
    D_raw, D_bal = pack_raw_bal_batch(
        rows, ds, bvs, w_d, B=pr0["num"], Xp=pr0["Xp"],
        e_lo=pr0["e_lo"], x_pad=pr0["x_pad"], ww=pr0["ww"])
    ns = jnp.asarray(np.asarray([pr["n"] for pr in prs], np.int32))
    D_exp = _pack_expected_batch(pE, ns, pr0["num"], pr0["Xp"],
                                 pr0["e_lo"], pr0["x_pad"], pr0["ww"])
    npix = jnp.asarray(np.asarray([pr["npix"] for pr in prs], np.int32))
    if keeps is not None:
        ep, xp_, vp = derive_pixels_masked_batch(
            rows, ds, keeps, npix, ww=pr0["ww"], dmax=pr0["dmax"],
            P2=pr0["P2"])
    else:
        ep, xp_, vp = derive_pixels_batch(rows, ds, npix, ww=pr0["ww"],
                                          dmax=pr0["dmax"], P2=pr0["P2"])
    if _phase_on():
        # attribute the packing kernels (pack_raw_bal / pack_expected /
        # derive_pixels) to their own phase instead of letting their device
        # time book under the next sync point ('escalate')
        with _phase("pack"):
            jax.block_until_ready((D_raw, D_bal, D_exp, ep, xp_, vp))
    return D_raw, D_bal, D_exp, ep, xp_, vp


def _escalation_fn(batched: bool):
    """Map-space escalation dispatch:

    * CPU — per-pixel formulation (full-map stencils per level cost ~3.5x
      the gathers they replace there);
    * accelerators — the XLA map-space formulation."""
    from ..ops.loops_packed import (escalation_packed,
                                    escalation_packed_batch,
                                    escalation_packed_maps,
                                    escalation_packed_maps_batch)

    if jax.default_backend() == "cpu":
        return escalation_packed_batch if batched else escalation_packed
    return (escalation_packed_maps_batch if batched
            else escalation_packed_maps)


def pcaller_chrom_coo(rows, cols, vals, weights, n: int, res: int, params,
                      allelic: bool = False,
                      gap: Optional[np.ndarray] = None,
                      packed: bool = True):
    """HICCUPS backgrounds + Poisson/BH for one chromosome from COO pixels.

    rows/cols/vals : upper-triangle intra COO (local bins)
    weights        : cooler balance weights (None in allelic mode —
                     matrices are already corrected, biases = 1)
    Everything O(N²) stays on device; host↔device traffic is the COO upload
    plus per-pixel vectors.
    """
    pr = _pcaller_prep(rows, cols, vals, weights, n, res, params,
                       allelic=allelic, gap=gap, packed=packed)
    ww, pw, maxww, num = pr["ww"], pr["pw"], pr["maxww"], pr["num"]

    if packed:
        D_raw, D_bal, D_exp, epad_d, xpad_d, vpad_d = _packed_inputs(pr)
        resolved, bsk, bek, bsy, bey = _escalation_fn(False)(
            D_raw, D_bal, D_exp, epad_d, xpad_d, vpad_d,
            ww, maxww, pw, num, pr["e_lo"], pr["x_pad"])
        dev = (epad_d, xpad_d, vpad_d, D_raw)
    else:
        _ensure_host_pixels(pr)
        S_raw, S_bal, S_exp = _build_band_prefixes(
            jnp.asarray(pr["br"]), jnp.asarray(pr["bc"]),
            jnp.asarray(pr["bv"]), jnp.asarray(pr["bb"]),
            jnp.asarray(pr["predictE"]), jnp.asarray(n), pr["P"], ww, num)
        resolved, bsk, bek, bsy, bey = _escalation_device(
            S_raw, S_exp, S_bal, jnp.asarray(pr["xpad"]),
            jnp.asarray(pr["ypad"]), jnp.asarray(pr["vpad"]),
            ww, maxww, pw)
        dev = None
    return _pcaller_post(pr, resolved, bsk, bek, bsy, bey, res, dev=dev)


def pcaller_multi(inputs: dict, res: int, params, allelic: bool = False,
                  gaps: Optional[dict] = None) -> dict:
    """Multi-chromosome pcaller: one escalation dispatch per size bucket.

    inputs : {chrom: (rows, cols, vals, weights_or_None, n)}
    Chromosomes whose padded band/pixel shapes coincide are stacked and run
    through one vmapped escalation (ops/loops_packed.py) — the per-chrom
    semantics (including the ≥16-reads / <10% stopping rule) are unchanged
    vs pcaller_chrom_coo.  Returns {chrom: (donuts, lowerleft)}.
    """

    gaps = gaps or {}
    preps, groups = {}, {}
    with _phase("prep"):
        for chro, (rows, cols, vals, wt, n) in inputs.items():
            pr = _pcaller_prep(rows, cols, vals, wt, n, res, params,
                               allelic=allelic, gap=gaps.get(chro))
            preps[chro] = pr
            groups.setdefault((pr["Xp"], pr["cap"], pr["P2"]),
                              []).append(chro)

    results = {}
    for _key, chros in groups.items():
        prs = [preps[c] for c in chros]
        pr0 = prs[0]
        D_raw, D_bal, D_exp, epad, xpad, vpad = _packed_inputs_batch(prs)
        resolved, bsk, bek, bsy, bey = _escalation_fn(True)(
            D_raw, D_bal, D_exp, epad, xpad, vpad,
            pr0["ww"], pr0["maxww"], pr0["pw"], pr0["num"],
            pr0["e_lo"], pr0["x_pad"])
        if _phase_on():
            with _phase("escalate"):
                jax.block_until_ready((resolved, bsk, bek, bsy, bey))
        if _use_device_post(pr0):
            # everything stays on device; one batched post per group and
            # one host fetch of compacted survivors
            with _phase("post"):
                got = _post_device_batch(prs, chros, resolved, bsk, bek,
                                         bsy, bey, res,
                                         (epad, xpad, vpad, D_raw))
            for i, chro in enumerate(chros):
                r = got[chro]
                if r is None:  # compaction overflow: host path, this chrom
                    from ..utils.profiling import add as _madd

                    _madd("loops.post_overflow", 1)
                    r = _pcaller_post(preps[chro], resolved[i], bsk[i],
                                      bek[i], bsy[i], bey[i], res)
                results[chro] = r
        else:
            resolved = np.asarray(resolved)
            bsk, bek = np.asarray(bsk), np.asarray(bek)
            bsy, bey = np.asarray(bsy), np.asarray(bey)
            for i, chro in enumerate(chros):
                results[chro] = _pcaller_post(
                    preps[chro], resolved[i], bsk[i], bek[i], bsy[i],
                    bey[i], res)
    return results


def _poisson_bh(o: np.ndarray, e: np.ndarray):
    """λ-chunked Poisson + BH for one flavor's surviving pixels.

    Host float64 vectorized path by default (exact vs the reference);
    the jitted on-device program (ops/stats_jax.py) takes over on
    accelerator backends for large pixel counts unless HICHAP_HOST_STATS=1
    — device math is f32, which can flip razor-edge q ≈ sig pixels."""
    from ..ops.stats import poisson_bh_chunked

    use_device = (jax.default_backend() != "cpu"
                  and o.size >= 262_144
                  and os.environ.get("HICHAP_HOST_STATS") != "1")
    if use_device:
        from ..ops.stats_jax import poisson_bh_chunked_jax

        # pad to the next power of two so the jitted program is shared
        # across chromosomes/flavors instead of compiling per pixel count
        P2 = 1 << max(o.size - 1, 1).bit_length()
        op = np.zeros(P2, np.float32)
        ep = np.zeros(P2, np.float32)
        vp = np.zeros(P2, bool)
        op[: o.size] = o
        ep[: e.size] = e
        vp[: o.size] = True
        pv, qv = poisson_bh_chunked_jax(
            jnp.asarray(op), jnp.asarray(ep), jnp.asarray(vp))
        return (np.asarray(pv, np.float64)[: o.size],
                np.asarray(qv, np.float64)[: o.size])
    return poisson_bh_chunked(o, e)


def _gap_neighborhood_keep(pxi, pyi, N: int, gaps: set) -> np.ndarray:
    """±5-bin gap-neighborhood peak removal (StructureFind.py:1904-1927),
    as two prefix-sum range queries instead of per-pixel Python sets.
    Preserves the reference's exact (asymmetric) window bounds:
    [x-5, x+5) clipped to [0, N-1)."""
    g = np.zeros(N, np.int64)
    g[np.fromiter(gaps, int, len(gaps))] = 1
    cs = np.concatenate([[0], np.cumsum(g)])

    def has_gap(p):
        lo = np.where(p > 5, p - 5, 0)
        hi = np.where(p + 5 < N, p + 5, N - 1)
        return (cs[hi] - cs[lo]) > 0

    return ~(has_gap(pxi) | has_gap(pyi))


def _use_device_post(pr: dict) -> bool:
    """Device post-filter policy: on accelerators the escalation outputs
    are already resident, and compacting survivors on device replaces
    ~25 MB/chromosome of per-pixel downloads with a few hundred KB.
    ``HICHAP_HOST_STATS=1`` forces the float64 host path;
    ``HICHAP_FORCE_DEVICE_POST=1`` forces the device path (CPU tests)."""
    if os.environ.get("HICHAP_HOST_STATS") == "1":
        return False
    if os.environ.get("HICHAP_FORCE_DEVICE_POST") == "1":
        return True
    return jax.default_backend() != "cpu"


def _post_device(pr: dict, resolved, bsk, bek, bsy, bey, res: int, dev):
    """Compacted device post (ops/stats_jax.loop_post_compact); returns
    None when a flavor overflows the compaction buffer (host fallback)."""
    from ..ops.stats_jax import loop_post_compact

    epad_d, xpad_d, vpad_d, D_raw = dev
    N, P2 = pr["N"], pr["P2"]
    nb = len(pr["biases"])
    biases = np.zeros(max(nb, N) + 1, np.float32)
    biases[:nb] = pr["biases"]
    gap_ind = np.zeros(N + 1, np.int64)
    if pr["gaps"]:
        gap_ind[np.fromiter(pr["gaps"], int, len(pr["gaps"]))] = 1
    # exclusive prefix (host semantics: cs[hi] - cs[lo] over [lo, hi))
    cs = np.concatenate([[0], np.cumsum(gap_ind[:-1])]).astype(np.int32)
    cap_out = min(P2, 1 << 16)

    outs = loop_post_compact(
        resolved, bsk, bek, bsy, bey, epad_d, xpad_d, vpad_d, D_raw,
        jnp.asarray(pr["predictE"]), jnp.asarray(biases),
        jnp.asarray(cs), jnp.asarray(N), jnp.asarray(pr["sig"],
                                                     jnp.float32),
        ww=pr["ww"], e_off=pr["e_lo"], x_off=pr["x_pad"], cap_out=cap_out)
    host = jax.device_get(outs)
    out = {}
    for fl, (cnt, _idx, xi, yi, o, fold, pv, qv) in zip("KY", host):
        cnt = int(cnt)
        if cnt > cap_out:
            return None
        out[fl] = {
            (int(a) * res, int(b) * res): (float(ov), float(fv), float(pvv),
                                           float(qvv))
            for a, b, ov, fv, pvv, qvv in zip(
                xi[:cnt], yi[:cnt], o[:cnt], fold[:cnt], pv[:cnt], qv[:cnt])
        }
    common = set(out["K"]) & set(out["Y"])
    return ({pos: out["K"][pos] for pos in common},
            {pos: out["Y"][pos] for pos in common})


def _post_device_batch(prs: List[dict], chros, resolved, bsk, bek, bsy,
                       bey, res: int, dev) -> dict:
    """Batched _post_device for a same-shape group: one dispatch per stage
    and ONE host fetch for the whole group.  Returns {chrom: result or
    None} — None marks a compaction overflow (caller falls back to the
    host path for that chromosome only)."""
    from ..ops.stats_jax import loop_post_compact_batch

    epad, xpad, vpad, D_raw = dev
    pr0 = prs[0]
    G = len(prs)
    maxn = max(pr["N"] for pr in prs)
    biases = np.zeros((G, maxn + 1), np.float32)
    cs = np.zeros((G, maxn + 1), np.int32)
    for i, pr in enumerate(prs):
        nb = len(pr["biases"])
        biases[i, :nb] = pr["biases"]
        gap_ind = np.zeros(pr["N"] + 1, np.int64)
        if pr["gaps"]:
            gap_ind[np.fromiter(pr["gaps"], int, len(pr["gaps"]))] = 1
        c = np.concatenate([[0], np.cumsum(gap_ind[:-1])]).astype(np.int32)
        cs[i, : c.size] = c
        cs[i, c.size:] = c[-1]
    pE = np.stack([pr["predictE"] for pr in prs])
    ns = np.asarray([pr["N"] for pr in prs], np.int32)
    cap_out = min(pr0["P2"], 1 << 16)

    outs = loop_post_compact_batch(
        resolved, bsk, bek, bsy, bey, epad, xpad, vpad, D_raw,
        jnp.asarray(pE), jnp.asarray(biases), jnp.asarray(cs),
        jnp.asarray(ns), jnp.asarray(pr0["sig"], jnp.float32),
        ww=pr0["ww"], e_off=pr0["e_lo"], x_off=pr0["x_pad"],
        cap_out=cap_out)
    host = jax.device_get(outs)

    results = {}
    for i, chro in enumerate(chros):
        out, ok = {}, True
        for fl, (cnt, _idx, xi, yi, o, fold, pv, qv) in zip("KY", host):
            c = int(cnt[i])
            if c > cap_out:
                ok = False
                break
            out[fl] = {
                (int(a) * res, int(b) * res): (float(ov), float(fv),
                                               float(pvv), float(qvv))
                for a, b, ov, fv, pvv, qvv in zip(
                    xi[i][:c], yi[i][:c], o[i][:c], fold[i][:c],
                    pv[i][:c], qv[i][:c])
            }
        if not ok:
            results[chro] = None
            continue
        common = set(out["K"]) & set(out["Y"])
        results[chro] = ({pos: out["K"][pos] for pos in common},
                         {pos: out["Y"][pos] for pos in common})
    return results


def _pcaller_post(pr: dict, resolved, bsk, bek, bsy, bey, res: int,
                  dev=None):
    """Poisson/BH + gap filtering of escalated pixels (reference semantics
    StructureFind.py:1869-1946).  With ``dev`` (device-resident pixel
    coordinates + raw band map) and an accelerator backend the whole stage
    runs on device and only compacted survivors download."""
    if dev is not None and _use_device_post(pr):
        got = _post_device(pr, resolved, bsk, bek, bsy, bey, res, dev)
        if got is not None:
            return got
        from ..utils.profiling import add as _madd

        _madd("loops.post_overflow", 1)
    npix, N, sig = pr["npix"], pr["N"], pr["sig"]
    _ensure_host_pixels(pr)
    xi, yi = pr["xi"], pr["yi"]
    o_val, em_val = pr["o_val"], pr["em_val"]
    biases, gaps = pr["biases"], pr["gaps"]

    ref_mask = np.asarray(resolved)[:npix]
    bSV = {"K": np.asarray(bsk)[:npix], "Y": np.asarray(bsy)[:npix]}
    bEV = {"K": np.asarray(bek)[:npix], "Y": np.asarray(bey)[:npix]}

    mask = (bEV["K"] != 0) & (bEV["Y"] != 0) & ref_mask
    xi, yi = xi[mask], yi[mask]
    with np.errstate(divide="ignore", invalid="ignore"):
        brv = {fl: np.where(bEV[fl][mask] != 0,
                            bSV[fl][mask] / np.where(bEV[fl][mask] != 0,
                                                     bEV[fl][mask], 1.0), 0.0)
               for fl in "KY"}
    em_val = em_val[mask]
    o_val = o_val[mask]

    out = {}
    for fl in "KY":
        nz = brv[fl] != 0
        pxi, pyi = xi[nz], yi[nz]
        e = em_val[nz] * brv[fl][nz] * biases[pxi] * biases[pyi]
        good = e > 0
        pxi, pyi, e = pxi[good], pyi[good], e[good]
        o = o_val[nz][good]
        fold = o / e
        pv, qv = _poisson_bh(o, e)
        rej = qv <= sig
        pxi, pyi = pxi[rej], pyi[rej]
        o, e, fold, pv, qv = o[rej], e[rej], fold[rej], pv[rej], qv[rej]
        if gaps:
            keep = _gap_neighborhood_keep(pxi, pyi, N, gaps)
            pxi, pyi = pxi[keep], pyi[keep]
            o, e, fold, pv, qv = (o[keep], e[keep], fold[keep], pv[keep],
                                  qv[keep])
        out[fl] = {
            (int(a) * res, int(b) * res): (float(ov), float(fv), float(pvv),
                                           float(qvv))
            for a, b, ov, fv, pvv, qvv in zip(pxi, pyi, o, fold, pv, qv)
        }

    common = set(out["K"]) & set(out["Y"])
    donuts = {pos: out["K"][pos] for pos in common}
    lowerleft = {pos: out["Y"][pos] for pos in common}
    return donuts, lowerleft


# --------------------------------------------------------------- driver
def _sym_csr(rows, cols, vals, n: int):
    """Symmetric CSR from upper-triangle COO — the post-stage cache format.

    Selection/clustering/plotting only ever do point lookups, ``diagonal(k)``
    and small window slices, so a CSR serves them at O(nnz) memory where the
    dense float64 build measured ~7 s/GB on the 1-core host (~40 GB and
    several hundred seconds for hg19 at 10 kb — the reference can afford
    dense because it never runs genome-scale at this resolution)."""
    from scipy.sparse import coo_matrix

    off = rows != cols
    dr = np.concatenate([rows, cols[off]])
    dc = np.concatenate([cols, rows[off]])
    dv = np.concatenate([vals, vals[off]])
    return coo_matrix((dv, (dr, dc)), shape=(n, n)).tocsr()


def _window(M, s: int, e: int) -> np.ndarray:
    """Dense [s:e, s:e] window of a dense-or-sparse matrix cache entry."""
    W = M[s:e, s:e]
    return W.toarray() if hasattr(W, "toarray") else W


def call_peaks(cooler_path: str, res: int, allelic, outfil: str,
               gap_file: Optional[str] = None) -> Dict[str, np.ndarray]:
    """CallPeaks parity (StructureFind.py:1954-2060).  Returns raw matrices
    cache {chrom: symmetric CSR} used by selection/clustering."""
    reader = CoolerReader(cooler_path, res)
    if allelic is False or allelic is None:
        chroms = reader.chromnames
    elif allelic in ("Maternal", "Paternal"):
        chroms = [c for c in reader.chromnames
                  if c.startswith(allelic[0])]
        if gap_file is None:
            raise ValueError("Gap file needed for haplotype loop calling")
        gaps_npz = np.load(gap_file, allow_pickle=True)
        gap_lib = gaps_npz[str(res)][()]
    else:
        raise ValueError(f"Unknown allelic key {allelic!r}")

    params = peaks_parameters(res)
    matrices = {}
    head = "\t".join(["chromLabel", "loc_1", "loc_2", "IF", "D-Enrichment",
                      "D-pvalue", "D-qvalue", "LL-Enrichment", "LL-pvalue",
                      "LL-qvalue"]) + "\n"
    inputs, gap_by = {}, {}
    for chro in chroms:
        rows, cols, vals = reader.fetch_coo(chro)
        ci = reader.chromnames.index(chro)
        n = int(reader.chrom_offset[ci + 1] - reader.chrom_offset[ci])
        # sparse host copy kept for the selection/cluster post-stages,
        # built from the COO already fetched (no second h5py pass, and
        # never crosses the device link)
        matrices[chro] = _sym_csr(rows, cols, vals, n)
        if not allelic:
            wt = reader.bins_weight(chro)
        else:
            wt = None
            gap_by[chro] = np.asarray(gap_lib[chro])
        inputs[chro] = (rows, cols, vals, wt, n)

    from ..utils.profiling import stage as _stage
    with _stage("loops.pcaller"):
        results = pcaller_multi(inputs, res, params, allelic=bool(allelic),
                                gaps=gap_by)

    with open(outfil, "w") as f:
        f.write(head)
        for chro in chroms:
            donuts, ll = results[chro]
            label = chro[1:] if allelic else chro
            for pos in donuts:
                row = (label,) + pos + donuts[pos] + ll[pos][1:]
                f.write("%s\t%d\t%d\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g\n"
                        % row)
            log.log(21, "loops %s: %d candidates", chro, len(donuts))
    return matrices


def loop_selecting(matrices, res: int, input_fil: str, output_fil: str,
                   loop_ratio: float = 0.6, loop_strength: float = 16,
                   strict_parity: bool = False):
    """Distance-quantile + strength post-filter (StructureFind.py:2063-2094;
    resolution parameterized instead of the hardcoded 40 kb — DIVERGENCES
    D5; ``strict_parity=True`` reproduces the reference's `// 40000`)."""
    import bisect

    if strict_parity:
        res = 40_000
    sorted_diag = {}  # (chrom, distance) → sorted diagonal, shared by lines
    with open(input_fil) as f, open(output_fil, "w") as o:
        header = f.readline()
        o.write(header)
        for line in f:
            l = line.split()
            chro = l[0]
            b1 = int(l[1]) // res
            b2 = int(l[2]) // res
            M = matrices[chro]
            IF = float(M[b1, b2])
            key = (chro, b2 - b1)
            if key not in sorted_diag:
                # .diagonal(k) works for both ndarray and scipy sparse
                sorted_diag[key] = np.sort(np.asarray(M.diagonal(b2 - b1)))
            dist = sorted_diag[key]
            ratio = bisect.bisect_left(dist, IF) / len(dist)
            if ratio < loop_ratio or IF < loop_strength:
                continue
            o.write(line)


def _cluster_pass(loops: List[tuple], dis: float) -> List[List[tuple]]:
    """Greedy centroid clustering, one scan per cluster (reference
    peakcluster semantics minus its mutate-during-iterate skip)."""
    classes = []
    remaining = sorted(loops, key=lambda t: t[1])
    while remaining:
        cls = [remaining.pop(0)]
        cx = float(np.mean([m[1] for m in cls]))
        cy = float(np.mean([m[2] for m in cls]))
        kept = []
        for lp in remaining:
            if math.sqrt((cx - lp[1]) ** 2 + (cy - lp[2]) ** 2) <= dis:
                cls.append(lp)
                cx = float(np.mean([m[1] for m in cls]))
                cy = float(np.mean([m[2] for m in cls]))
            else:
                kept.append(lp)
        remaining = kept
        classes.append(cls)
    return classes


def loop_cluster(matrices, res: int, rawfil: str, allelic,
                 weight_q_value: float = 1e-4) -> str:
    """Iterative centroid clustering + weighted-q final selection
    (StructureFind.py:2154-2243)."""
    rows = []
    with open(rawfil) as f:
        f.readline()
        for line in f:
            l = line.split()
            rows.append((l[0], int(l[1]), int(l[2]), float(l[9])))
    init_dis = res * math.sqrt(2) + 1000
    by_chrom: Dict[str, List[tuple]] = {}
    for r in rows:
        by_chrom.setdefault(r[0], []).append(r)

    # pass 1: representative = min-q member, count absorbed
    level1 = []
    for chro, lps in by_chrom.items():
        for cls in _cluster_pass(lps, init_dis):
            best = min(cls, key=lambda t: t[3])
            level1.append((best[0], best[1], best[2], best[3], float(len(cls))))

    while True:
        nxt = []
        by_chrom2: Dict[str, List[tuple]] = {}
        for r in level1:
            by_chrom2.setdefault(r[0], []).append(r)
        for chro, lps in by_chrom2.items():
            for cls in _cluster_pass(lps, init_dis * 2):
                best = min(cls, key=lambda t: t[3])
                sums = sum(t[4] for t in cls)
                nxt.append((best[0], best[1], best[2], best[3], sums))
        if len(nxt) == len(level1):
            level1 = nxt
            break
        level1 = nxt

    def _weighted_q(q, sums):
        """q / 10**sums in float64 like the reference's structured-array
        arithmetic: a cluster aggregating 309+ candidates overflows to
        inf (wq -> 0.0, loop kept) where Python-float ``10 ** sums``
        raises OverflowError and killed the run."""
        with np.errstate(over="ignore"):
            return float(np.float64(q) / np.float64(10.0) ** np.float64(sums))

    path, fil = os.path.split(rawfil)
    cluster_fil = os.path.join(path or ".", "Cluster_" + fil)
    with open(cluster_fil, "w") as out:
        out.write("chr\tstart\tend\tIF\tweight_Q-value\taggregateNum\n")
        if not allelic:
            for chro, s1, e1, q, sums in level1:
                wq = _weighted_q(q, sums)
                if wq < weight_q_value:
                    x, y = s1 // res, e1 // res
                    IF = float(matrices[chro][x, y])
                    out.write(f"{chro}\t{s1}\t{e1}\t{IF}\t{wq}\t{sums}\n")
        else:
            pre = allelic[0]
            weighted = []
            for chro, s1, e1, q, sums in level1:
                M = matrices[pre + chro]
                x, y = s1 // res, e1 // res
                wq = _weighted_q(q, sums)
                if wq < weight_q_value:
                    # reference replaces only EXACT zeros with 1e-20
                    # (StructureFind.py's float64 underflow floor), not a
                    # general clamp — a max() compressed every strong
                    # cluster's -log10 score
                    weighted.append((chro, s1, e1, float(M[x, y]),
                                     wq if wq > 0 else 1e-20, sums))
            if weighted:
                thr = {}
                chros = {w[0] for w in weighted}
                arr = np.array([w[3] * -np.log10(w[4]) for w in weighted])
                labels = np.array([w[0] for w in weighted])
                for chro in chros:
                    thr[chro] = np.percentile(arr[labels == chro], 15)
                for w, v in zip(weighted, arr):
                    if v >= thr[w[0]]:
                        out.write("\t".join(map(str, w)) + "\n")
    return cluster_fil


def plot_loops(pdf_path: str, cooler_path: str, res: int, allelic,
               cluster_file: str, matrices, length: int = 4_000_000) -> None:
    """Per-window heatmaps with called loops marked
    (StructureFind.py:2259-2337)."""
    from ..utils.optional import require_matplotlib

    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    reader = CoolerReader(cooler_path, res)
    loops = []
    with open(cluster_file) as f:
        f.readline()
        for line in f:
            p = line.split()
            loops.append((p[0], int(p[1]), int(p[2])))

    cmap = LinearSegmentedColormap.from_list("interactions",
                                             ["#FFFFFF", "#CD0000"])
    chroms = sorted(matrices)
    with PdfPages(pdf_path) as pp:
        for chro in chroms:
            if allelic:
                M = matrices[chro]
                label = chro[1:]
            else:
                M = np.nan_to_num(reader.matrix(chro, balance=True))
                label = chro
            sub = [l for l in loops if l[0] == label]
            N = M.shape[0]
            interval = max(length // res, 1)
            start = 0
            while start + interval <= N:
                end = start + interval
                W = _window(M, start, end)
                sel = [l for l in sub if start * res <= l[1]
                       and l[2] <= end * res]
                nz = W[np.nonzero(W)]
                if nz.size > 100 and sel:
                    fig, ax = plt.subplots(figsize=(10, 9))
                    ax.imshow(W, cmap=cmap, aspect="auto",
                              interpolation="none",
                              vmax=np.percentile(nz, 95), origin="lower")
                    # imshow with no extent centers pixel k AT k, so the
                    # marker lands on the called bin (the reference's +0.5
                    # belongs with its extent=(0, N) axes)
                    for _, s, e in sel:
                        ax.scatter(s // res - start,
                                   e // res - start,
                                   facecolors="none", edgecolors="b", s=10)
                    ax.set_xlabel(f"Chr{label}", size=14)
                    pp.savefig(fig)
                    plt.close(fig)
                start = end


def run_loops(cooler_path: str, res: int, allelic, out_path: str,
              gap_file: Optional[str] = None, loop_ratio: float = 0.6,
              loop_strength: float = 16, plot: bool = False) -> str:
    """run_Loops parity (StructureFind.py:2340-2373).  Returns the final
    Cluster_ file path."""
    os.makedirs(out_path, exist_ok=True)
    unit = _proper_unit(res)
    prefix = os.path.basename(out_path.rstrip("/"))
    outfil = os.path.join(out_path, f"{prefix}_Loops_{unit}.txt")
    matrices = call_peaks(cooler_path, res, allelic, outfil, gap_file)
    if not allelic:
        select_fil = os.path.join(out_path,
                                  f"Selected_{prefix}_Loops_{unit}.txt")
        loop_selecting(matrices, res, outfil, select_fil, loop_ratio,
                       loop_strength)
        final = loop_cluster(matrices, res, select_fil, allelic)
    else:
        final = loop_cluster(matrices, res, outfil, allelic)
    if plot:
        pdf = os.path.join(out_path, f"{prefix}_Loops_Plot_{unit}.pdf")
        plot_loops(pdf, cooler_path, res, allelic, final, matrices)
    log.log(21, "loops done → %s", final)
    return final
