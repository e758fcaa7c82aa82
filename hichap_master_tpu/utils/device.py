"""Process-level device setup: the compile cache and host-only workers."""

from __future__ import annotations

import os
import sys

# the checkout root: two levels above this file's package directory
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself; no other directory is set).  Otherwise the cache goes to
    ``<checkout>/.jax_cache``, a fixed path, so a second run of the same
    checkout finds what the first compiled."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def host_only_worker() -> None:
    """Process-pool initializer: keep a worker off the accelerator.

    A JAX process reserves most of a GPU's memory the first time it uses
    it, so a worker that touched the card would starve the parent.  The
    pools that call this run host code only; this makes that a guarantee
    rather than a convention."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")
