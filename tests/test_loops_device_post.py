"""The compacted on-device loop post-filter (ops/stats_jax.loop_post_compact
via models/loops._post_device) must reproduce the host post exactly on
well-separated data — same surviving pixels, f32-tolerance statistics."""

import numpy as np
import pytest

from hichap_master_tpu.models.loops import (pcaller_chrom_coo,
                                            pcaller_multi,
                                            peaks_parameters)

RES = 10_000


def _chrom(rng, n, band, loops=6):
    d = np.arange(band)
    lam = 12.0 / (d + 1.0) ** 0.8
    counts = rng.poisson(np.broadcast_to(lam, (n, band))).astype(np.float64)
    for _ in range(loops):
        x = int(rng.integers(5, n - band - 5))
        e = int(rng.integers(20, band - 20))
        counts[x, e] = counts[x, e] * 10 + 80
    rows, es = np.nonzero(counts)
    cols = rows + es
    keep = cols < n
    return rows[keep].astype(np.int64), cols[keep].astype(np.int64), \
        counts[rows, es][keep]


@pytest.fixture
def params():
    return peaks_parameters(RES)


def _compare(host, dev, label):
    dh, lh = host
    dd, ld = dev
    assert set(dd) == set(dh), label
    assert set(ld) == set(lh), label
    for pos in dh:
        np.testing.assert_allclose(dd[pos], dh[pos], rtol=5e-5,
                                   atol=1e-7, err_msg=f"{label} {pos}")


@pytest.mark.slow
def test_device_post_matches_host_single(params, monkeypatch):
    rng = np.random.default_rng(11)
    n = 512
    band = min(params["maxapart"] // RES + params["maxww"] + 1, n - 8)
    rows, cols, vals = _chrom(rng, n, band)
    # weights with a zero (filtered bin) exercises the bias path
    wt = np.ones(n)
    wt[37] = 0.0
    host = pcaller_chrom_coo(rows, cols, vals, wt, n, RES, params)
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    dev = pcaller_chrom_coo(rows, cols, vals, wt, n, RES, params)
    assert host[0], "test data produced no loops — not exercising the path"
    _compare(host, dev, "single")


@pytest.mark.slow
def test_device_post_matches_host_multi(params, monkeypatch):
    rng = np.random.default_rng(5)
    sizes = {"1": 512, "2": 512, "3": 384}
    band = params["maxapart"] // RES + params["maxww"] + 1
    inputs = {}
    for c, n in sizes.items():
        rows, cols, vals = _chrom(rng, n, min(band, n - 8))
        inputs[c] = (rows, cols, vals, np.ones(n), n)
    host = pcaller_multi(inputs, RES, params)
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    dev = pcaller_multi(inputs, RES, params)
    for c in sizes:
        _compare(host[c], dev[c], c)


def test_device_post_gap_filter(params, monkeypatch):
    """A gap bin adjacent to a called loop must remove it on both paths."""
    rng = np.random.default_rng(11)
    n = 512
    band = min(params["maxapart"] // RES + params["maxww"] + 1, n - 8)
    rows, cols, vals = _chrom(rng, n, band)
    host = pcaller_chrom_coo(rows, cols, vals, np.ones(n), n, RES, params)
    assert host[0]
    # zero out all contacts of a bin 3 away from the first loop's x bin
    x0 = next(iter(host[0]))[0] // RES
    gx = x0 + 3
    drop = (rows != gx) & (cols != gx)
    r2, c2, v2 = rows[drop], cols[drop], vals[drop]
    host2 = pcaller_chrom_coo(r2, c2, v2, np.ones(n), n, RES, params)
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    dev2 = pcaller_chrom_coo(r2, c2, v2, np.ones(n), n, RES, params)
    assert set(dev2[0]) == set(host2[0])
    assert all(p[0] // RES < gx - 5 or p[0] // RES > gx + 5
               or not (gx - 5 <= p[1] // RES <= gx + 5)
               for p in dev2[0])


def test_device_post_overflow_falls_back(params, monkeypatch):
    """When survivors exceed the compaction buffer the device path must
    return None internally and the host path must produce the result."""
    from hichap_master_tpu.models import loops as L

    rng = np.random.default_rng(11)
    n = 512
    band = min(params["maxapart"] // RES + params["maxww"] + 1, n - 8)
    rows, cols, vals = _chrom(rng, n, band)
    host = pcaller_chrom_coo(rows, cols, vals, np.ones(n), n, RES, params)
    assert host[0]

    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    calls = {"n": 0}
    orig = L._post_device

    def tiny_cap(pr, *a, **k):
        calls["n"] += 1
        # shrink the buffer below the survivor count by lying about P2
        pr = dict(pr, P2=1)
        out = orig(pr, *a, **k)
        assert out is None, "cap_out=1 must overflow"
        return out

    monkeypatch.setattr(L, "_post_device", tiny_cap)
    dev = pcaller_chrom_coo(rows, cols, vals, np.ones(n), n, RES, params)
    assert calls["n"] == 1
    assert set(dev[0]) == set(host[0])


def test_batch_overflow_falls_back_per_chrom(params, monkeypatch):
    """When one chromosome of a group overflows the compaction buffer the
    batch post marks it None and pcaller_multi must recompute exactly that
    chromosome through the host path."""
    from hichap_master_tpu.models import loops as L

    rng = np.random.default_rng(5)
    sizes = {"1": 512, "2": 512}
    band = params["maxapart"] // RES + params["maxww"] + 1
    inputs = {}
    for c, n in sizes.items():
        rows, cols, vals = _chrom(rng, n, min(band, n - 8))
        inputs[c] = (rows, cols, vals, np.ones(n), n)
    host = pcaller_multi(inputs, RES, params)

    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    orig = L._post_device_batch

    def overflow_first(prs, chros, *a, **k):
        got = orig(prs, chros, *a, **k)
        got[chros[0]] = None  # simulate compaction overflow
        return got

    monkeypatch.setattr(L, "_post_device_batch", overflow_first)
    from hichap_master_tpu.utils import profiling

    profiling.reset_metrics("loops.post_overflow")
    dev = pcaller_multi(inputs, RES, params)
    assert profiling.metrics()["loops.post_overflow"] == 1
    for c in sizes:
        assert set(dev[c][0]) == set(host[c][0]), c
        assert set(dev[c][1]) == set(host[c][1]), c
        assert set(dev[c][0]) == set(host[c][0]), c
        assert set(dev[c][1]) == set(host[c][1]), c


def test_bh_flat_cap_loops_rows_identically(rng, monkeypatch):
    """The batched post sorts all rows as one flat segmented program; it
    must not change any q-value: per-row poisson_bh_chunked_jax over
    disjoint segments equals the flat segmented-sort batch exactly."""
    import jax.numpy as jnp

    from hichap_master_tpu.ops.stats_jax import (poisson_bh_chunked_jax,
                                                 poisson_bh_chunked_jax_batch)

    G, P2 = 3, 4096
    o = jnp.asarray(rng.poisson(4.0, (G, P2)).astype(np.float32))
    e = jnp.asarray(rng.random((G, P2), np.float32) * 6 + 0.2)
    val = jnp.asarray(rng.random((G, P2)) < 0.8)
    pv_b, qv_b = poisson_bh_chunked_jax_batch(o, e, val)
    for i in range(G):
        pv_i, qv_i = poisson_bh_chunked_jax(o[i], e[i], val[i])
        np.testing.assert_array_equal(np.asarray(pv_i), np.asarray(pv_b)[i])
        np.testing.assert_array_equal(np.asarray(qv_i), np.asarray(qv_b)[i])
