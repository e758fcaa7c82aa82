"""Top-k PCA for compartment calling.

Replaces sklearn ``PCA(n_components=3).fit(Cor)`` (HiCHap/StructureFind.py:
338-341).  Components are eigenvectors of the column covariance of the
(row-centered) input; the default path is blocked subspace iteration — k+p
matvecs per sweep — with an exact ``eigh`` fallback for oracle tests.
Signs are unspecified (the reference resolves orientation downstream via
``Select_PC_new`` / ``Select_Allelic_PC``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _center(X: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    N = X.shape[0]
    valid = (jnp.arange(N) < n).astype(X.dtype)
    cnt = jnp.maximum(jnp.sum(valid), 1.0)
    mu = jnp.sum(X * valid[:, None], axis=0) / cnt
    return (X - mu[None, :]) * valid[:, None]


@functools.partial(jax.jit, static_argnames=("k", "iters", "oversample"))
def pca_components_subspace(X: jnp.ndarray, n: jnp.ndarray, k: int = 3,
                            iters: int = 100, oversample: int = 4):
    """[k, N] top principal components via subspace iteration."""
    N = X.shape[0]
    Xc = _center(X, n)
    C = jnp.dot(Xc.T, Xc, precision=jax.lax.Precision.HIGHEST)
    q = k + oversample
    key = jax.random.PRNGKey(0)
    Q = jax.random.normal(key, (N, q), X.dtype)
    valid = (jnp.arange(N) < n).astype(X.dtype)
    Q = Q * valid[:, None]

    def body(_, Q):
        Z = jnp.dot(C, Q, precision=jax.lax.Precision.HIGHEST)
        Qn, _ = jnp.linalg.qr(Z)
        return Qn

    Q = jax.lax.fori_loop(0, iters, body, Q)
    # HIGHEST: a float32 product may run in TF32 on a GPU (~1e-3 relative),
    # which would perturb the Ritz values that order near-degenerate PCs;
    # these products are k+p columns wide, so full precision costs little
    hp = jax.lax.Precision.HIGHEST
    B = jnp.dot(Q.T, jnp.dot(C, Q, precision=hp), precision=hp)
    w, V = jnp.linalg.eigh(B)
    order = jnp.argsort(-w)[:k]
    comps = jnp.dot(Q, V[:, order], precision=hp).T
    # Normalize (QR keeps orthonormal, but Ritz rotation preserves it anyway).
    comps = comps / jnp.linalg.norm(comps, axis=1, keepdims=True)
    # rank(C) < k (degenerate chromosome: fewer non-gap bins than
    # components): QR fills null-space columns with arbitrary directions
    # that can leak onto PADDED rows — re-mask so downstream selection
    # never sees signal outside the valid block
    comps = comps * valid[None, :]
    return comps, w[order]


@functools.partial(jax.jit, static_argnames=("k",))
def pca_components_eigh(X: jnp.ndarray, n: jnp.ndarray, k: int = 3):
    """Exact dense path (CPU oracle / small matrices)."""
    Xc = _center(X, n)
    C = jnp.dot(Xc.T, Xc, precision=jax.lax.Precision.HIGHEST)
    w, V = jnp.linalg.eigh(C)
    order = jnp.argsort(-w)[:k]
    return V[:, order].T, w[order]


def pca_components(X, n, k: int = 3, method: str = "subspace", **kw):
    if method == "eigh":
        return pca_components_eigh(X, n, k)
    return pca_components_subspace(X, n, k, **kw)
