"""Pin the device/host switch boundaries in the loop caller.

The 262,144-pixel stats crossover and the post-filter policy encode
tradeoffs set before the H100 (models/loops.py); these tests pin the exact
boundary and the env-knob overrides (HICHAP_HOST_STATS /
HICHAP_FORCE_DEVICE_POST) so a retune is a deliberate edit, not a drift.
Where the crossover sits on the H100 is not measured yet — retune via
the knobs, see PERF.md."""

import numpy as np
import pytest

import hichap_master_tpu.models.loops as loops_mod
import hichap_master_tpu.ops.stats as stats_mod
import hichap_master_tpu.ops.stats_jax as stats_jax_mod
from hichap_master_tpu.models.loops import _poisson_bh, _use_device_post

THRESH = 262_144


@pytest.fixture
def spies(monkeypatch):
    calls = {"host": 0, "device": 0}
    real_host = stats_mod.poisson_bh_chunked
    real_dev = stats_jax_mod.poisson_bh_chunked_jax

    def host(o, e):
        calls["host"] += 1
        return real_host(o, e)

    def dev(o, e, v):
        calls["device"] += 1
        return real_dev(o, e, v)

    monkeypatch.setattr(stats_mod, "poisson_bh_chunked", host)
    monkeypatch.setattr(stats_jax_mod, "poisson_bh_chunked_jax", dev)
    return calls


def _oe(n, rng):
    e = rng.uniform(0.5, 30.0, n)
    o = rng.poisson(e).astype(np.float64) + 1
    return o, e


def test_stats_switch_boundary_exact(monkeypatch, spies, rng):
    monkeypatch.setattr(loops_mod.jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("HICHAP_HOST_STATS", raising=False)

    o, e = _oe(THRESH - 1, rng)
    _poisson_bh(o, e)
    assert spies == {"host": 1, "device": 0}

    o, e = _oe(THRESH, rng)
    pv_d, qv_d = _poisson_bh(o, e)
    assert spies == {"host": 1, "device": 1}

    # both paths agree at the boundary (device is f32; tolerance covers it)
    pv_h, qv_h = stats_mod.poisson_bh_chunked(o, e)
    np.testing.assert_allclose(pv_d, pv_h, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(qv_d, qv_h, rtol=5e-4, atol=1e-6)


def test_stats_switch_host_override(monkeypatch, spies, rng):
    monkeypatch.setattr(loops_mod.jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("HICHAP_HOST_STATS", "1")
    o, e = _oe(THRESH, rng)
    _poisson_bh(o, e)
    assert spies == {"host": 1, "device": 0}


def test_stats_switch_cpu_backend_stays_host(monkeypatch, spies, rng):
    monkeypatch.delenv("HICHAP_HOST_STATS", raising=False)
    o, e = _oe(THRESH, rng)
    _poisson_bh(o, e)  # suite backend is cpu
    assert spies == {"host": 1, "device": 0}


def test_device_post_policy_knobs(monkeypatch):
    pr = {}
    monkeypatch.delenv("HICHAP_HOST_STATS", raising=False)
    monkeypatch.delenv("HICHAP_FORCE_DEVICE_POST", raising=False)
    assert _use_device_post(pr) is False  # cpu backend default

    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    assert _use_device_post(pr) is True

    monkeypatch.setenv("HICHAP_HOST_STATS", "1")  # host wins over force
    assert _use_device_post(pr) is False

    monkeypatch.delenv("HICHAP_HOST_STATS")
    monkeypatch.delenv("HICHAP_FORCE_DEVICE_POST")
    monkeypatch.setattr(loops_mod.jax, "default_backend", lambda: "gpu")
    assert _use_device_post(pr) is True
