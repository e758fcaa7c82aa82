"""utils/device.py: compile-cache placement and host-only pool workers."""

import os

import jax

from hichap_master_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.setup_compile_cache() == str(tmp_path)
    # the variable is JAX's own: the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.setup_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_host_only_worker_pins_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda,cpu")
    before = jax.config.jax_platforms
    try:
        device.host_only_worker()
        assert os.environ["JAX_PLATFORMS"] == "cpu"
        assert jax.config.jax_platforms == "cpu"
    finally:
        jax.config.update("jax_platforms", before)
