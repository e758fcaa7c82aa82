"""Full analysis-suite wall-time probe on one device.

Runs the ENTIRE suite over a 1/8-scale synthetic genome (8 chromosomes,
~370 Mb): the per-device workload of an 8-way chromosome-sharded run over
a human-scale genome (parallel/sharding.py shards chromosome batches over
the mesh with no cross-device traffic except ICE psums).

Stages (matching the reference pipeline, StructureFind.py + matrixBuilding.py):
  - two-step correction at 10 kb, all chromosomes (batched per size bucket)
  - ICE balancing at 10 kb, all chromosomes (batched)
  - compartments at 500 kb per chromosome (run_compartment, cooler-backed)
  - TADs at 40 kb per chromosome (run_tads, cooler-backed)
  - loops at 10 kb per chromosome (pcaller_chrom_coo, band COO)

Run: python scripts/perf_fullsuite.py   (PERF_WARM=1 doubles runs to report
compile-cached warm numbers; data generation is excluded from timings).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# 1/8-scale genome: 4 large + 4 small chromosomes (two padding buckets).
# PERF_SCALE divides every size (smoke-testing on CPU).
_S = int(os.environ.get("PERF_SCALE", "1"))
CHROMS = {"1": 61_430_000 // _S, "2": 61_430_000 // _S,
          "3": 61_430_000 // _S, "4": 61_430_000 // _S,
          "5": 30_710_000 // _S, "6": 30_710_000 // _S,
          "7": 30_710_000 // _S, "8": 30_710_000 // _S}
RES_LOOP, RES_TAD, RES_COMP = 10_000, 40_000, 500_000


def timed(label, fn):
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    warm = cold
    if os.environ.get("PERF_WARM", "1") == "1":
        t0 = time.perf_counter()
        fn()
        warm = time.perf_counter() - t0
    print(f"{label:52s} {cold:8.2f} s (warm {warm:6.2f} s)", flush=True)
    return out, warm


def device_hap_batch(key, sizes, n_pad):
    """On-device synthetic haplotype stack [C, n_pad, n_pad]: decay +
    noise, symmetric, masked to each chromosome's real size."""
    import jax
    import jax.numpy as jnp

    c = len(sizes)
    i = jnp.arange(n_pad)
    d = jnp.abs(i[:, None] - i[None, :]) + 1.0
    lam = 80.0 / d**0.9
    u = jax.random.uniform(key, (c, n_pad, n_pad), jnp.float32, 1e-6, 1.0)
    m = jnp.floor(-jnp.log(u) * lam).astype(jnp.float32)  # exp-tail counts
    m = jnp.triu(m) + jnp.swapaxes(jnp.triu(m, 1), -1, -2)
    valid = i[None, :] < jnp.asarray(sizes)[:, None]
    mask = valid[:, :, None] & valid[:, None, :]
    return jnp.where(mask, m, 0.0)


def band_coo(rng, n, band, loops=40):
    """Host band-limited COO (d < band) with planted loop anchors."""
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
    for c, size in CHROMS.items():
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
    import tempfile

    import jax
    import jax.numpy as jnp

    from hichap_master_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    from hichap_master_tpu.models.compartment import run_compartment
    from hichap_master_tpu.models.loops import (pcaller_multi,
                                                peaks_parameters)
    from hichap_master_tpu.models.tads import run_tads
    from hichap_master_tpu.ops import ice_balance_batch
    from hichap_master_tpu.ops.correct import two_step_correction_batch

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="perf_full_")
    print(f"devices: {jax.devices()}", flush=True)
    print(f"genome: {len(CHROMS)} chroms, {sum(CHROMS.values())/1e6:.0f} Mb "
          f"(1/8 human scale)", flush=True)

    from hichap_master_tpu.core.contacts import pad_to_bucket

    sizes_by_bucket = {}
    for c, s in CHROMS.items():
        n = s // RES_LOOP + 1
        sizes_by_bucket.setdefault(pad_to_bucket(n, 512), []).append(n)

    total = 0.0

    # --- two-step correction + ICE at 10 kb, batched per bucket ----------
    for n_pad, sizes in sorted(sizes_by_bucket.items()):
        k1, k2 = jax.random.split(jax.random.PRNGKey(n_pad))
        m = device_hap_batch(k1, sizes, n_pad)
        p = device_hap_batch(k2, sizes, n_pad)
        t = m + p
        nb = jnp.asarray(sizes, jnp.int32)
        jax.block_until_ready(m)

        def _corr(m=m, p=p, t=t, nb=nb):
            return jax.block_until_ready(two_step_correction_batch(t, m, p,
                                                                   nb))

        _, w = timed(f"two-step correction 10kb x{len(sizes)} (pad {n_pad})",
                     _corr)
        total += w

        def _ice(t=t, nb=nb):
            wgt, stats = ice_balance_batch(t, nb)
            jax.block_until_ready(wgt)
            return stats

        _, w = timed(f"ICE balancing 10kb x{len(sizes)} (pad {n_pad})", _ice)
        total += w
        del m, p, t

    # --- compartments 500 kb + TADs 40 kb (cooler-backed, all chroms) ----
    c500 = synth_cooler(tmp, "c500.cool", RES_COMP, rng)
    c40 = synth_cooler(tmp, "c40.cool", RES_TAD, rng, tad_size=20)
    _, w = timed("compartments 500kb, 8 chroms",
                 lambda: run_compartment(c500, RES_COMP, False,
                                         os.path.join(tmp, "PC")))
    total += w
    _, w = timed("TADs 40kb, 8 chroms",
                 lambda: run_tads(c40, RES_TAD, False,
                                  os.path.join(tmp, "TAD"), plot=False))
    total += w

    # --- loops 10 kb per chromosome (band COO) ----------------------------
    params = peaks_parameters(RES_LOOP)
    band = params["maxapart"] // RES_LOOP + params["maxww"] + 1
    g_bins = {c: s // RES_LOOP + 1 for c, s in CHROMS.items()}
    inputs = {}
    for c, n in g_bins.items():
        rows, cols, vals = band_coo(rng, n, band)
        inputs[c] = (rows, cols, vals, np.ones(n), n)

    def _loops():
        results = pcaller_multi(inputs, RES_LOOP, params)
        return sum(len(d) for d, _ in results.values())

    n_peaks, w = timed("loops 10kb, 8 chroms (batched band COO)", _loops)
    total += w
    print(f"loops found: {n_peaks}", flush=True)

    print(f"\nFULL SUITE (warm one-device total, 1/8-scale genome): "
          f"{total:.1f} s", flush=True)


if __name__ == "__main__":
    main()
