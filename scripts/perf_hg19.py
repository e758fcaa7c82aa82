"""Genome-wide analysis suite at REAL hg19 chromosome sizes, one device.

All 23 hg19 chromosomes (chr1..22+X, the
reference's default ['#','X'] chroms) at their true bin counts —
chr1 = 24,926 bins at 10 kb.  Scale anchor: the reference's GM12878
example is 42 GB FASTQ/mate (README.md:52-55); the matrix/analysis stages
measured here are everything downstream of bed ingestion.

Stages (matching matrixBuilding.py + StructureFind.py semantics):
  1. genome-wide two-step-style ICE at 10 kb — block-sparse tiles
     (ops/sparse.py), the only representable form at this scale
     (dense would be ~343 GB)
  2. per-chromosome dense two-step correction + ICE at 40 kb (the
     reference's local-res example), batched per padding bucket
  3. compartments at 500 kb, all chromosomes (cooler-backed)
  4. TADs at 40 kb, all chromosomes (cooler-backed)
  5. loops at 10 kb, all chromosomes (band COO, batched escalation)

Prints the per-stage warm walls as one JSON line.  On a GPU:
    python scripts/perf_hg19.py
CPU smoke (scaled down 32x):
    PERF_SCALE=32 PERF_WARM=0 JAX_PLATFORMS=cpu python scripts/perf_hg19.py
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np

from perf_sparse_gw import HG19, band_coords, gen_tiles_device, hg19_bins

_S = int(os.environ.get("PERF_SCALE", "1"))
CHROMS = {**{str(i + 1): l // _S for i, l in enumerate(HG19[:22])},
          "X": HG19[22] // _S}
RES_LOOP, RES_TAD, RES_COMP = 10_000, 40_000, 500_000
WARM = os.environ.get("PERF_WARM", "1") == "1"

RESULTS = {}
ONLY = set(filter(None, os.environ.get("PERF_ONLY", "").split(",")))


def want(stage: str) -> bool:
    return not ONLY or stage in ONLY


def timed(label, key, fn):
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    warm = cold
    if WARM:
        t0 = time.perf_counter()
        fn()
        warm = time.perf_counter() - t0
    print(f"{label:56s} {cold:8.2f} s (warm {warm:7.2f} s)", flush=True)
    RESULTS[key] = round(warm, 2)
    return out, warm


def device_hap_batch(key, sizes, n_pad):
    import jax
    import jax.numpy as jnp

    c = len(sizes)
    i = jnp.arange(n_pad)
    d = jnp.abs(i[:, None] - i[None, :]) + 1.0
    lam = 80.0 / d**0.9
    u = jax.random.uniform(key, (c, n_pad, n_pad), jnp.float32, 1e-6, 1.0)
    m = jnp.floor(-jnp.log(u) * lam).astype(jnp.float32)
    m = jnp.triu(m) + jnp.swapaxes(jnp.triu(m, 1), -1, -2)
    valid = i[None, :] < jnp.asarray(sizes)[:, None]
    mask = valid[:, :, None] & valid[:, None, :]
    return jnp.where(mask, m, 0.0)


def band_coo(rng, n, band, loops=40):
    d = np.arange(band)
    lam = 80.0 / (d + 1.0) ** 0.9
    counts = rng.poisson(np.broadcast_to(lam, (n, band))).astype(np.float64)
    for _ in range(loops if n > band + 10 else 0):
        x = int(rng.integers(5, n - band - 5))
        e = int(rng.integers(20, band - 20))
        counts[x, e] = counts[x, e] * 8 + 60
    rows, es = np.nonzero(counts)
    cols = rows + es
    keep = cols < n
    return rows[keep], cols[keep], counts[rows, es][keep]


def synth_cooler(tmp, name, res, rng, tad_size=0):
    from hichap_master_tpu.core import Genome
    from hichap_master_tpu.io import CoolerReader, write_cooler

    g = Genome(CHROMS)
    mats = {}
    for c in CHROMS:
        n = g.n_bins(c, res)
        i = np.arange(n)
        d = np.abs(np.subtract.outer(i, i)) + 1.0
        lam = 80.0 / d**0.9
        if tad_size:
            same = np.equal.outer(i // tad_size, i // tad_size)
            lam = lam * np.where(same, 4.0, 1.0)
        M = rng.poisson(lam).astype(np.float32)
        mats[c] = np.triu(M) + np.triu(M, 1).T
    path = os.path.join(tmp, name)
    write_cooler(path, g, res, mats)
    r = CoolerReader(path, res)
    r.set_weights(np.ones(r.nbins))
    return path


def main():
    import logging
    import tempfile

    import jax

    if os.environ.get("PERF_VERBOSE") == "1":
        logging.basicConfig(level=21, stream=sys.stdout,
                            format="%(name)s: %(message)s")

    from hichap_master_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    import jax.numpy as jnp
    from hichap_master_tpu.core.contacts import pad_to_bucket
    from hichap_master_tpu.models.compartment import run_compartment
    from hichap_master_tpu.models.loops import pcaller_multi, peaks_parameters
    from hichap_master_tpu.models.tads import run_tads
    from hichap_master_tpu.ops import ice_balance_batch
    from hichap_master_tpu.ops.correct import two_step_correction_batch
    from hichap_master_tpu.ops.sparse import sparse_ice_balance

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="perf_hg19_")
    print(f"devices: {jax.devices()}", flush=True)
    print(f"genome: {len(CHROMS)} chroms, {sum(CHROMS.values())/1e6:.0f} Mb"
          f" (hg19{'/'+str(_S) if _S > 1 else ''})", flush=True)
    total = 0.0

    # ---- 1. genome-wide block-sparse ICE at 10 kb (full balance) --------
    if want("gw"):
        T = 128
        n_gw = hg19_bins(RES_LOOP * max(_S // 4, 1))  # keep tiles honest
        R = (n_gw + T - 1) // T
        coords = band_coords(R)
        tiles, brow, bcol = gen_tiles_device(coords, T)
        _ = np.asarray(tiles[0, 0, 0])
        print(f"genome-wide sparse: n={n_gw} tiles={coords.shape[0]} "
              f"({coords.shape[0]*T*T*4/2**20:.0f} MB; dense would be "
              f"{n_gw*n_gw*4/2**30:.0f} GB)", flush=True)

        def _gw():
            w, st = sparse_ice_balance(tiles, brow, bcol, jnp.asarray(n_gw),
                                       R=R, T=T, tol=1e-5, max_iters=200)
            np.asarray(w[:2])
            return int(np.asarray(st["iters"]))

        it, w = timed(f"genome-wide sparse ICE 10kb ({n_gw} bins, tol 1e-5)",
                      "gw_sparse_ice_10kb_s", _gw)
        print(f"  converged in {it} iters", flush=True)
        total += w
        del tiles

    # ---- 2. dense two-step + ICE at 40 kb, batched per bucket -----------
    from hichap_master_tpu.core import Genome
    g = Genome(CHROMS)
    buckets = {}
    for c in CHROMS:
        n = g.n_bins(c, RES_TAD)
        buckets.setdefault(pad_to_bucket(n, 512), []).append(n)
    t_corr = t_ice = 0.0
    for n_pad, sizes in (sorted(buckets.items()) if want("res40") else []):
        k1, k2 = jax.random.split(jax.random.PRNGKey(n_pad))
        m = device_hap_batch(k1, sizes, n_pad)
        p = device_hap_batch(k2, sizes, n_pad)
        t = m + p
        nb = jnp.asarray(sizes, jnp.int32)
        np.asarray(jax.block_until_ready(m)[0, 0, :2])

        def _corr(m=m, p=p, t=t, nb=nb):
            out = two_step_correction_batch(t, m, p, nb)
            np.asarray(out[0][:, 0, :2])
            return out

        _, w = timed(f"two-step 40kb x{len(sizes)} (pad {n_pad})",
                     f"twostep_40kb_pad{n_pad}_s", _corr)
        t_corr += w

        def _ice(t=t, nb=nb):
            wgt, st = ice_balance_batch(t, nb)
            np.asarray(wgt[:, :2])
            return st

        _, w = timed(f"ICE 40kb x{len(sizes)} (pad {n_pad})",
                     f"ice_40kb_pad{n_pad}_s", _ice)
        t_ice += w
        del m, p, t
    total += t_corr + t_ice

    # ---- 3+4. compartments 500 kb / TADs 40 kb ---------------------------
    if want("comp"):
        c500 = synth_cooler(tmp, "c500.cool", RES_COMP, rng)
        _, w = timed("compartments 500kb, 23 chroms", "compartments_500kb_s",
                     lambda: run_compartment(c500, RES_COMP, False,
                                             os.path.join(tmp, "PC")))
        total += w
    if want("tads"):
        c40 = synth_cooler(tmp, "c40.cool", RES_TAD, rng, tad_size=20)
        _, w = timed("TADs 40kb, 23 chroms", "tads_40kb_s",
                     lambda: run_tads(c40, RES_TAD, False,
                                      os.path.join(tmp, "TAD"), plot=False))
        total += w

    # ---- 5. loops at 10 kb, all chromosomes ------------------------------
    if want("loops"):
        params = peaks_parameters(RES_LOOP)
        band = params["maxapart"] // RES_LOOP + params["maxww"] + 1
        # PERF_LOOP_CHROMS limits to the N largest chromosomes (debug)
        sel = sorted(CHROMS, key=lambda c: -CHROMS[c])
        lim = os.environ.get("PERF_LOOP_CHROMS")
        if lim:
            sel = sel[: int(lim)]
        inputs = {}
        for c in sel:
            n = g.n_bins(c, RES_LOOP)
            rows, cols, vals = band_coo(rng, n, band)
            inputs[c] = (rows, cols, vals, np.ones(n), n)
        print(f"loops input: "
              f"{sum(v[0].size for v in inputs.values())/1e6:.1f}M "
              f"band pixels over {len(inputs)} chroms", flush=True)

        def _loops():
            from hichap_master_tpu.utils.profiling import reset_metrics

            # phase walls (if enabled) = last run only; scope the reset to
            # loops.phase.* so earlier stages' accumulators survive
            reset_metrics(prefix="loops.phase")
            results = pcaller_multi(inputs, RES_LOOP, params)
            return sum(len(d) for d, _ in results.values())

        n_peaks, w = timed(f"loops 10kb, {len(sel)} chroms (batched band COO)",
                           "loops_10kb_s", _loops)
        total += w
        print(f"loops found: {n_peaks}", flush=True)
        # HICHAP_LOOP_PHASE_TIMING=1 records the device-vs-link split of
        # the warm loops run (prep/upload/escalate/post)
        from hichap_master_tpu.utils.profiling import metrics
        ph = {k.split(".")[-1]: round(v, 2) for k, v in metrics().items()
              if k.startswith("loops.phase")}
        if ph:
            RESULTS["loops_phases"] = ph
            print(f"loop phases (warm): {json.dumps(ph)}", flush=True)

    RESULTS["total_s"] = round(total, 1)
    RESULTS["chroms"] = len(CHROMS)
    RESULTS["scale_divisor"] = _S
    RESULTS["bins_10kb"] = int(sum(g.n_bins(c, RES_LOOP) for c in CHROMS))
    RESULTS["device"] = jax.devices()[0].device_kind
    print(f"\nFULL SUITE at real hg19 sizes (warm, one device): {total:.1f} s",
          flush=True)
    print(json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    main()
