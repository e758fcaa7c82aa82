"""Genome-wide block-sparse ICE at true hg19 10 kb scale, on one device.

The matrix this balances is hg19 chr1..22+X concatenated at 10 kb — dense
f32 would be ~343 GB, over 4x an 80 GB H100.  The block-sparse form (2 Mb
intra band + sampled far-field tiles) is device-resident; data is
generated ON DEVICE, so no tile crosses the host link.

Usage:  python scripts/perf_sparse_gw.py          (GPU)
        PERF_ITERS=10 JAX_PLATFORMS=cpu python scripts/perf_sparse_gw.py
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np

from hichap_master_tpu.testing.synthetic import HG19 as _HG19

# hg19 chr1..22 + X lengths, in karyotype order
HG19 = list(_HG19.values())


def hg19_bins(res: int = 10_000) -> int:
    return int(sum((l + res - 1) // res for l in HG19))


def band_coords(R: int, band_tiles: int = 3, far_per_row: int = 1,
                seed: int = 0) -> np.ndarray:
    """Block coordinates: intra diagonal band + sampled far-field tiles
    (real genome-wide matrices have sparse inter-chromosomal content)."""
    coords = []
    for off in range(band_tiles):
        rr = np.arange(R - off, dtype=np.int32)
        coords.append(np.stack([rr, rr + off], 1))
    rng = np.random.default_rng(seed)
    for _ in range(far_per_row):
        rr = np.arange(R, dtype=np.int32)
        cc = rng.integers(0, R, R).astype(np.int32)
        lo = np.minimum(rr, cc)
        hi = np.maximum(rr, cc)
        far = np.stack([lo, hi], 1)
        far = far[hi - lo >= band_tiles]  # don't duplicate band tiles
        coords.append(far)
    allc = np.concatenate(coords)
    # dedup (sampled far tiles can collide)
    key = allc[:, 0].astype(np.int64) * R + allc[:, 1]
    _, idx = np.unique(key, return_index=True)
    return allc[np.sort(idx)]


def gen_tiles_device(coords: np.ndarray, T: int, seed: int = 0):
    """Generate Poisson-ish tile values on device from the distance decay."""
    import jax
    import jax.numpy as jnp

    K = coords.shape[0]
    brow = jnp.asarray(coords[:, 0])
    bcol = jnp.asarray(coords[:, 1])

    @jax.jit
    def gen(key):
        li = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
        lj = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
        dist = jnp.abs((bcol - brow)[:, None, None] * T + (lj - li)[None])
        lam = 60.0 / (1.0 + dist.astype(jnp.float32))
        u = jax.random.uniform(key, (K, T, T), jnp.float32, 1e-6, 1.0)
        t = jnp.floor(-jnp.log(u) * lam)
        isdiag = (brow == bcol)[:, None, None]
        ut = jnp.triu(t, 1)
        return jnp.where(isdiag, jnp.triu(t) + jnp.swapaxes(ut, -1, -2), t)

    return gen(jax.random.PRNGKey(seed)), brow, bcol


def main():
    import jax
    import jax.numpy as jnp
    from hichap_master_tpu.ops.sparse import sparse_ice_balance
    from hichap_master_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    T = 128
    # 300 iterations per sample keep dispatch overhead out of the rate
    iters = int(os.environ.get("PERF_ITERS", "300"))
    reduce = os.environ.get("PERF_REDUCE", "onehot")
    n = hg19_bins()
    R = (n + T - 1) // T
    coords = band_coords(R)
    K = coords.shape[0]
    tile_mb = K * T * T * 4 / 2**20
    dense_gb = n * n * 4 / 2**30
    print(f"hg19@10kb: n={n} R={R} K={K} tiles={tile_mb:.0f} MB "
          f"(dense would be {dense_gb:.0f} GB)")

    t0 = time.perf_counter()
    tiles, brow, bcol = gen_tiles_device(coords, T)
    jax.block_until_ready(tiles)
    print(f"device gen: {time.perf_counter() - t0:.1f}s")

    def run():
        w, st = sparse_ice_balance(tiles, brow, bcol, jnp.asarray(n),
                                   R=R, T=T, tol=0.0, max_iters=iters,
                                   reduce=reduce)
        return np.asarray(w), int(np.asarray(st["iters"]))

    print(f"device: {jax.devices()[0].device_kind}")
    t0 = time.perf_counter()
    w, it = run()
    print(f"warm+compile: {time.perf_counter() - t0:.1f}s iters={it} "
          f"finite={np.sum(~np.isnan(w))}")
    t0 = time.perf_counter()
    _, it = run()
    dt = time.perf_counter() - t0
    print(f"measured: {it} iters in {dt:.2f}s = {it / dt:.2f} iters/s")

    def run_fast():
        w, st = sparse_ice_balance(tiles, brow, bcol, jnp.asarray(n),
                                   R=R, T=T, tol=0.0, max_iters=iters,
                                   reduce=reduce, fast=True)
        return np.asarray(w), int(np.asarray(st["iters"]))

    wf, _ = run_fast()  # compile + warm
    t0 = time.perf_counter()
    wf, it = run_fast()
    dt = time.perf_counter() - t0
    m = ~np.isnan(w)
    dev = (np.max(np.abs(wf[m] - w[m]) / np.abs(w[m]))
           if m.any() else 0.0)
    print(f"fast (bf16 tiles): {it} iters in {dt:.2f}s = "
          f"{it / dt:.2f} iters/s (max rel dev {dev:.1e})")


if __name__ == "__main__":
    main()
