"""Benchmark: block-sparse genome-wide ICE at hg19 10 kb on one GPU.

Times ``sparse_ice_balance`` over the full hg19 genome (chr1..22+X,
303,641 bins at 10 kb; ~343 GB dense) on tiles generated on the device
(scripts/perf_sparse_gw.py).  Each sample runs a fixed number of
iterations and ends in ``block_until_ready``.  Fails when JAX finds no
GPU.  The benchmark's cells are not designed yet (ROADMAP A0).

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "samples": [...], "device": {...}}
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

ITERS = 300
SAMPLES = 3


def main():
    import jax
    import jax.numpy as jnp

    from hichap_master_tpu.ops.sparse import sparse_ice_balance
    from hichap_master_tpu.utils.device import setup_compile_cache
    from scripts.perf_sparse_gw import band_coords, gen_tiles_device, hg19_bins

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    setup_compile_cache()

    T = 128
    n = hg19_bins()
    R = (n + T - 1) // T
    tiles, brow, bcol = gen_tiles_device(band_coords(R), T)

    def run():
        w, st = sparse_ice_balance(tiles, brow, bcol, jnp.asarray(n),
                                   R=R, T=T, tol=0.0, max_iters=ITERS)
        jax.block_until_ready(w)
        return int(st["iters"])

    run()  # compile + warm
    rates = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        it = run()
        rates.append(it / (time.perf_counter() - t0))
    print(json.dumps({
        "metric": "sparse_genomewide_ice_iters_per_sec_10kb_hg19",
        "value": sorted(rates)[len(rates) // 2],
        "unit": "iters/s",
        "samples": rates,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
