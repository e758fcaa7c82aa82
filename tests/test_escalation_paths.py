"""Loop escalation: the map-space XLA formulation (the accelerator path)
against the per-pixel formulation (the CPU path), and the dispatch that
chooses between them."""

import jax.numpy as jnp
import numpy as np
import pytest

import hichap_master_tpu.models.loops as loops_mod
import hichap_master_tpu.ops.sparse as sparse_mod
from hichap_master_tpu.ops.loops_packed import (escalation_packed,
                                                escalation_packed_batch,
                                                escalation_packed_maps,
                                                escalation_packed_maps_batch)
from hichap_master_tpu.testing.synthetic import escalation_case

CASE = dict(n=300, B=40, ww=3, maxww=8, pw=1)


def _assert_same(got, want):
    res_g, *vals_g = (np.asarray(v) for v in got)
    res_w, *vals_w = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(res_g, res_w)
    for vg, vw in zip(vals_g, vals_w):
        np.testing.assert_allclose(vg[res_w], vw[res_w], rtol=1e-5,
                                   atol=1e-4)
    return res_w


@pytest.mark.parametrize("dense_reads", [True, False])
def test_maps_match_per_pixel(rng, dense_reads):
    args, kw = escalation_case(rng, npix=500, dense_reads=dense_reads, **CASE)
    res = _assert_same(escalation_packed_maps(*args, **kw),
                       escalation_packed(*args, **kw))
    assert res.any(), "case degenerate: nothing resolved"
    if not dense_reads:
        assert not res.all(), "case degenerate: everything resolved"


def test_maps_match_per_pixel_batched(rng):
    cases = [escalation_case(rng, npix=256, **CASE)[0] for _ in range(3)]
    kw = escalation_case(rng, npix=256, **CASE)[1]
    stacked = tuple(jnp.stack(parts) for parts in zip(*cases))
    res = _assert_same(escalation_packed_maps_batch(*stacked, **kw),
                       escalation_packed_batch(*stacked, **kw))
    for i, args in enumerate(cases):  # batch row == unbatched call
        np.testing.assert_array_equal(
            res[i], np.asarray(escalation_packed_maps(*args, **kw)[0]))


def test_maps_empty_pixels(rng):
    args, kw = escalation_case(rng, npix=64, **CASE)
    args = args[:5] + (jnp.zeros(64, bool),)
    res, *vals = escalation_packed_maps(*args, **kw)
    assert not np.asarray(res).any()
    for v in vals:
        assert not np.asarray(v).any()


@pytest.mark.parametrize("batched", [False, True])
def test_escalation_fn_chooses_xla_maps_on_gpu(monkeypatch, batched):
    want = escalation_packed_maps_batch if batched else escalation_packed_maps
    monkeypatch.setattr(loops_mod.jax, "default_backend", lambda: "gpu")
    assert loops_mod._escalation_fn(batched) is want
    monkeypatch.setattr(loops_mod.jax, "default_backend", lambda: "cpu")
    assert loops_mod._escalation_fn(batched) is (
        escalation_packed_batch if batched else escalation_packed)


def test_resolve_reduce_on_gpu(monkeypatch):
    monkeypatch.setattr(sparse_mod.jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("HICHAP_ICE_REDUCE", raising=False)
    assert sparse_mod._resolve_reduce() == "onehot"
    for r in ("onehot", "scan", "scatter"):
        monkeypatch.setenv("HICHAP_ICE_REDUCE", r)
        assert sparse_mod._resolve_reduce() == r
    monkeypatch.setenv("HICHAP_ICE_REDUCE", "pallas")  # no such path
    assert sparse_mod._resolve_reduce() == "onehot"
