"""Compartment model parity vs numpy/sklearn-style oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from hichap_master_tpu.core.contacts import pad_to_bucket
from hichap_master_tpu.ops.expected import (
    correlation_matrix,
    default_compartment_gap,
    distance_decay,
    oe_matrix,
)
from hichap_master_tpu.ops.pca import pca_components_eigh, pca_components_subspace
from hichap_master_tpu.models.compartment import (
    run_compartment,
    select_pc_new,
    single_chrom_compartment,
)
from hichap_master_tpu.testing.oracles import (oracle_distance_decay,
                                               synthetic_contact_matrix)


def _pad(M, N):
    out = np.zeros((N, N), np.float64)
    out[: M.shape[0], : M.shape[1]] = M
    return out


def test_distance_decay_matches_oracle(rng):
    n = 150
    M = synthetic_contact_matrix(rng, n, gap_frac=0.1)
    N = pad_to_bucket(n)
    Mj = jnp.asarray(_pad(M, N))
    gap = np.asarray(default_compartment_gap(Mj, jnp.asarray(n)))
    G = np.flatnonzero(gap[:n])
    # oracle's gap rule (<= 0.05 coverage)
    cov = (M != 0).sum(0) / n
    G_oracle = np.flatnonzero(cov <= 0.05)
    np.testing.assert_array_equal(G, G_oracle)
    got = np.asarray(distance_decay(Mj, jnp.asarray(gap), jnp.asarray(n)))[:n]
    want = oracle_distance_decay(M, G_oracle)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_oe_and_corr_match_numpy(rng):
    n = 120
    M = synthetic_contact_matrix(rng, n, gap_frac=0.05)
    N = pad_to_bucket(n)
    Mj = jnp.asarray(_pad(M, N))
    gap = default_compartment_gap(Mj, jnp.asarray(n))
    dec = distance_decay(Mj, gap, jnp.asarray(n))
    oe = np.asarray(oe_matrix(Mj, dec, jnp.asarray(n)))[:n, :n]
    decline = np.asarray(dec)[:n].copy()
    decline[decline == 0] = decline[np.nonzero(decline)].min()
    want = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if M[i, j] != 0:
                want[i, j] = M[i, j] / decline[abs(i - j)]
    np.testing.assert_allclose(oe, want, rtol=1e-6)

    # correlation parity with np.corrcoef on the non-gap columns
    ng = np.flatnonzero(~np.asarray(gap)[:n])
    X = want[:, ng]
    ref = np.corrcoef(X, rowvar=False)
    ref[np.isnan(ref)] = 0
    ref[np.isinf(ref)] = 1
    Xp = np.zeros((N, N))
    Xp[:n, : len(ng)] = X
    got = np.asarray(correlation_matrix(jnp.asarray(Xp), jnp.asarray(n)))
    np.testing.assert_allclose(got[: len(ng), : len(ng)], ref, atol=1e-9)


def test_pca_subspace_matches_eigh(rng):
    n = 200
    A = rng.random((n, n))
    C = (A + A.T) / 2
    N = pad_to_bucket(n)
    Cp = jnp.asarray(_pad(C, N))
    exact, wE = pca_components_eigh(Cp, jnp.asarray(n), 3)
    approx, wS = pca_components_subspace(Cp, jnp.asarray(n), 3, iters=150)
    exact = np.asarray(exact)
    approx = np.asarray(approx)
    np.testing.assert_allclose(np.asarray(wS), np.asarray(wE), rtol=1e-6)
    for i in range(3):
        r = abs(np.dot(exact[i], approx[i]))
        assert r > 1 - 1e-8, f"component {i} misaligned: {r}"
    # padding stays zero
    assert np.abs(exact[:, n:]).max() < 1e-10


def test_pca_matches_sklearn(rng):
    from sklearn.decomposition import PCA
    n = 90
    A = rng.random((n, n))
    C = np.corrcoef(A)
    N = pad_to_bucket(n)
    comps, _ = pca_components_eigh(jnp.asarray(_pad(C, N)), jnp.asarray(n), 3)
    comps = np.asarray(comps)[:, :n]
    ref = PCA(n_components=3).fit(C).components_
    for i in range(3):
        assert abs(np.dot(comps[i], ref[i])) > 1 - 1e-8


def test_run_compartment_end_to_end(tmp_path, rng):
    """Build a block-structured matrix and check A/B recovery + outputs."""
    from hichap_master_tpu.core import Genome
    from hichap_master_tpu.io import write_cooler

    n = 100
    res = 100_000
    # checkerboard compartment structure
    sign = np.where((np.arange(n) // 10) % 2 == 0, 1, -1)
    base = 2.0 + 0.8 * np.outer(sign, sign)
    d = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    lam = base * 60 / (1 + d)
    M = rng.poisson(lam).astype(float)
    M = np.triu(M) + np.triu(M, 1).T
    g = Genome({"1": n * res - res // 2})
    path = str(tmp_path / "c.cool")
    write_cooler(path, g, res, {"1": M})

    tracks = run_compartment(path, res, False, str(tmp_path / "PC"),
                             pca_method="eigh")
    pc = tracks["1"]
    assert (tmp_path / "PC" / "PC_Compartment_100K.txt").exists()
    r = abs(np.corrcoef(pc, sign[: len(pc)])[0, 1])
    assert r > 0.8, f"compartment signal not recovered: r={r}"
