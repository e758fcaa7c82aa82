"""Multi-device sharding verification, run in a clean 8-device CPU process.

Executed by tests/test_sharding.py via subprocess (the virtual device count
is fixed when JAX starts, so it needs a fresh interpreter).  Checks that sharded results match single-device results
exactly and prints one OK line per check.
"""

from __future__ import annotations

import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    assert len(jax.devices()) >= 8, f"need 8 devices, got {len(jax.devices())}"

    from hichap_master_tpu.core.contacts import pad_to_bucket
    from hichap_master_tpu.ops.balance import ice_balance
    from hichap_master_tpu.ops.correct import two_step_correction
    from hichap_master_tpu.parallel import (
        analysis_train_step,
        make_mesh,
        sharded_ice_balance,
        sharded_two_step,
    )
    from hichap_master_tpu.testing.oracles import synthetic_contact_matrix

    rng = np.random.default_rng(11)
    mesh = make_mesh(8)
    assert mesh.shape["chrom"] * mesh.shape["bins"] == 8
    print(f"OK mesh {dict(mesh.shape)}")

    # --- two-step: sharded == single device -------------------------------
    C = mesh.shape["chrom"] * 2
    n = 120
    N = pad_to_bucket(n)
    TM = np.zeros((C, N, N), np.float32)
    for i in range(C):
        TM[i, :n, :n] = synthetic_contact_matrix(rng, n, gap_frac=0.05,
                                                 scale=80.0)
    MM = (TM * 0.31).astype(np.float32)
    PM = (TM * 0.29).astype(np.float32)
    ns = np.full(C, n, np.int32)
    fn = sharded_two_step(mesh)
    s_mm, s_pm, s_gm, s_gp = fn(jnp.asarray(TM), jnp.asarray(MM),
                                jnp.asarray(PM), jnp.asarray(ns))
    for i in range(C):
        r_mm, _, r_gm, _ = two_step_correction(
            jnp.asarray(TM[i]), jnp.asarray(MM[i]), jnp.asarray(PM[i]),
            jnp.asarray(n))
        np.testing.assert_allclose(np.asarray(s_mm)[i], np.asarray(r_mm),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(s_gm)[i], np.asarray(r_gm))
    print("OK sharded two-step matches single-device")

    # --- ICE: sharded == single device ------------------------------------
    n2 = 200
    S = 128 * 8
    G = np.zeros((S, S), np.float32)
    G[:n2, :n2] = synthetic_contact_matrix(rng, n2, gap_frac=0.0, scale=60.0)
    fn2 = sharded_ice_balance(mesh)
    w_sharded, _ = fn2(jnp.asarray(G), jnp.asarray(n2))
    w_single, _ = ice_balance(jnp.asarray(G), jnp.asarray(n2), max_iters=50)
    ws, w1 = np.asarray(w_sharded), np.asarray(w_single)
    np.testing.assert_array_equal(np.isnan(ws), np.isnan(w1))
    m = ~np.isnan(w1)
    np.testing.assert_allclose(ws[m], w1[m], rtol=1e-4)
    print("OK sharded ICE matches single-device")

    # --- full train step runs over the mesh --------------------------------
    step = analysis_train_step(mesh)
    alpha = np.ones(S, np.float32)
    nm, npm, w, cor, di = step(jnp.asarray(TM[:, :128, :128]),
                               jnp.asarray(MM[:, :128, :128]),
                               jnp.asarray(PM[:, :128, :128]),
                               jnp.asarray(np.minimum(ns, 120)),
                               jnp.asarray(G), jnp.asarray(alpha),
                               jnp.asarray(S))
    assert np.isfinite(np.asarray(nm)).all()
    assert np.isfinite(np.asarray(cor)).all()
    assert np.isfinite(np.asarray(di)).all()
    print("OK analysis_train_step over", dict(mesh.shape))

    # --- sparse genome-wide ICE: sharded == single device ------------------
    from hichap_master_tpu.ops.sparse import (asym_blocks_from_coo,
                                              blocks_from_dense,
                                              ice_balance_blocks,
                                              genomewide_correction_blocks,
                                              pad_blocks,
                                              blocks_to_dense)
    from hichap_master_tpu.parallel import (sharded_sparse_ice,
                                            sharded_sparse_genomewide)

    n3 = 520
    i3 = np.arange(n3)
    d3 = np.abs(np.subtract.outer(i3, i3))
    Msp = (rng.poisson(40.0 / (d3 + 1.0)) * (d3 < 96)).astype(np.float32)
    Msp = np.triu(Msp)
    Msp = Msp + np.triu(Msp, 1).T
    bm = pad_blocks(blocks_from_dense(Msp, T=64), 8)
    fn3 = sharded_sparse_ice(mesh, bm.R, bm.T, max_iters=50)
    w_sp, _ = fn3(jnp.asarray(bm.tiles), jnp.asarray(bm.brow),
                  jnp.asarray(bm.bcol), jnp.asarray(n3))
    w_1c, _ = ice_balance_blocks(bm, max_iters=50)
    w_sp = np.asarray(w_sp)[:n3]
    w_1c = np.asarray(w_1c)
    np.testing.assert_array_equal(np.isnan(w_sp), np.isnan(w_1c))
    msk = ~np.isnan(w_1c)
    np.testing.assert_allclose(w_sp[msk], w_1c[msk], rtol=1e-4)
    print("OK sharded sparse ICE matches single-device")

    Hasym = (Msp * rng.uniform(0.5, 1.5, Msp.shape)).astype(np.float32)
    ri, ci = np.nonzero(Hasym)
    ab = asym_blocks_from_coo(ri, ci, Hasym[ri, ci], n3, T=64)
    # pad the shared coordinate list to the device count
    padU = pad_blocks(type(bm)(tiles=ab.U, brow=ab.brow, bcol=ab.bcol,
                               n=ab.n, T=ab.T, R=ab.R), 8)
    padL = pad_blocks(type(bm)(tiles=ab.L, brow=ab.brow, bcol=ab.bcol,
                               n=ab.n, T=ab.T, R=ab.R), 8)
    af = np.ones(ab.R * ab.T, np.float32)
    af[:n3] = rng.uniform(0.4, 1.0, n3).astype(np.float32)
    fn4 = sharded_sparse_genomewide(mesh, ab.R, ab.T)
    cor_sh = fn4(jnp.asarray(padU.tiles), jnp.asarray(padL.tiles),
                 jnp.asarray(padU.brow), jnp.asarray(padU.bcol),
                 jnp.asarray(af))
    ref_bm = genomewide_correction_blocks(ab, af[:n3])
    got = blocks_to_dense(type(bm)(tiles=np.asarray(cor_sh), brow=padU.brow,
                                   bcol=padU.bcol, n=n3, T=ab.T, R=ab.R))
    want = blocks_to_dense(ref_bm)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)
    print("OK sharded sparse genome-wide correction matches single-device")

    # --- sharded loop escalation == single-device map-space path ----------
    from hichap_master_tpu.ops.loops_packed import (escalation_packed_maps,
                                                    pack_margins)
    from hichap_master_tpu.parallel.sharding import sharded_loop_escalation

    ww, maxww, pw = 3, 6, 1
    e_lo, _e_hi, x_pad = pack_margins(maxww)
    Cs, B, Xp, P2 = 8, 32, 128, 64
    E = B + 2 * e_lo
    Dr = rng.poisson(2.0, (Cs, E, Xp)).astype(np.float32)
    Db = (Dr * 0.7).astype(np.float32)
    De = (Dr * 0.5 + 0.1).astype(np.float32)
    e_pix = rng.integers(ww, B - 1, (Cs, P2)).astype(np.int32)
    x_pix = rng.integers(0, Xp - 2 * x_pad - B, (Cs, P2)).astype(np.int32)
    valid = rng.random((Cs, P2)) < 0.9
    esc = sharded_loop_escalation(mesh, ww, maxww, pw, e_lo, x_pad)
    outs = esc(jnp.asarray(Dr), jnp.asarray(Db), jnp.asarray(De),
               jnp.asarray(e_pix), jnp.asarray(x_pix), jnp.asarray(valid))
    for i in range(Cs):
        ref = escalation_packed_maps(
            jnp.asarray(Dr[i]), jnp.asarray(Db[i]), jnp.asarray(De[i]),
            jnp.asarray(e_pix[i]), jnp.asarray(x_pix[i]),
            jnp.asarray(valid[i]), ww, maxww, pw, B, e_lo, x_pad)
        np.testing.assert_array_equal(np.asarray(outs[0])[i],
                                      np.asarray(ref[0]))
        for k in range(1, 5):
            np.testing.assert_allclose(np.asarray(outs[k])[i],
                                       np.asarray(ref[k]), rtol=1e-6)
    print("OK sharded loop escalation matches single-device")

    # --- sharded compartment == single-device fused graph ------------------
    from hichap_master_tpu.models.compartment import _compartment_fused
    from hichap_master_tpu.parallel.sharding import sharded_compartment

    Cc, Nc, nc = 8, 128, 100
    Mb = np.zeros((Cc, Nc, Nc), np.float32)
    for i in range(Cc):
        Mb[i, :nc, :nc] = synthetic_contact_matrix(rng, nc, gap_frac=0.05,
                                                   scale=60.0)
    gapb = np.zeros((Cc, Nc), bool)
    gapb[:, nc:] = True
    ngb = np.zeros((Cc, Nc), np.int32)
    gbs = np.zeros(Cc, np.int32)
    for i in range(Cc):
        ng = np.flatnonzero(~gapb[i, :nc])
        ngb[i, :ng.size] = ng
        gbs[i] = ng.size
    nb = np.full(Cc, nc, np.int32)
    comp = sharded_compartment(mesh)
    oe_b, cor_b, pcs_b, pc_b = comp(jnp.asarray(Mb), jnp.asarray(gapb),
                                    jnp.asarray(nb), jnp.asarray(ngb),
                                    jnp.asarray(gbs))
    for i in range(Cc):
        _, _, _, pc_ref = _compartment_fused(
            jnp.asarray(Mb[i]), jnp.asarray(gapb[i]), jnp.asarray(nb[i]),
            jnp.asarray(ngb[i]), jnp.asarray(gbs[i]), 0, "subspace")
        ref = np.asarray(pc_ref)
        got = np.asarray(pc_b)[i]
        # PCA sign/solver tolerance: compare up to sign, loose tol
        err = min(np.abs(got - ref).max(), np.abs(got + ref).max())
        assert err < 1e-3, f"chrom {i}: pc mismatch {err}"
    print("OK sharded compartment matches single-device")

    # --- sharded hybrid ICE (production 10 kb weights path) ---------------
    from hichap_master_tpu.ops.sparse_hybrid import (hybrid_from_coo,
                                                     ice_balance_hybrid)
    from hichap_master_tpu.parallel import (shard_hybrid_layout,
                                            sharded_hybrid_ice)

    n_h = 700
    i_h = np.arange(n_h)
    d_h = np.abs(np.subtract.outer(i_h, i_h))
    Mh = (rng.poisson(30.0 / (d_h + 1.0)) * (d_h < 80)).astype(np.float32)
    sc_r = rng.integers(0, n_h, 4000)
    sc_c = rng.integers(0, n_h, 4000)
    Mh[np.minimum(sc_r, sc_c), np.maximum(sc_r, sc_c)] += rng.poisson(
        2.0, 4000).astype(np.float32) + 1.0
    rh, ch2 = np.nonzero(np.triu(Mh))
    hyb = hybrid_from_coo(rh, ch2, Mh[rh, ch2], n_h, T=64, min_tile_occ=64)
    assert hyb.sc_nnz.sum() > 0 and hyb.bm.K > 1
    bm_h, scc, scv, lb, snz = shard_hybrid_layout(hyb, 8)
    hice = sharded_hybrid_ice(mesh, bm_h.R, bm_h.T, max_iters=30, tol=1e-6)
    w_h, st_h = hice(jnp.asarray(bm_h.tiles), jnp.asarray(bm_h.brow),
                     jnp.asarray(bm_h.bcol), jnp.asarray(scc),
                     jnp.asarray(scv), jnp.asarray(lb), jnp.asarray(snz),
                     jnp.asarray(n_h))
    w_h = np.asarray(w_h)[:n_h]
    w_ref, st_ref = ice_balance_hybrid(hyb, max_iters=30, tol=1e-6)
    w_ref = np.asarray(w_ref)
    np.testing.assert_array_equal(np.isnan(w_h), np.isnan(w_ref))
    mk = ~np.isnan(w_ref)
    np.testing.assert_allclose(w_h[mk], w_ref[mk], rtol=1e-4)
    assert int(np.asarray(st_h["iters"])) == int(np.asarray(st_ref["iters"]))
    print("OK sharded hybrid ICE matches single-device")

    # same path with the compensated-scan reduction: per-shard segment
    # sums + psum must match the single-device onehot fixed point
    hice_s = sharded_hybrid_ice(mesh, bm_h.R, bm_h.T, max_iters=30,
                                tol=1e-6, reduce="scan")
    w_hs, st_hs = hice_s(jnp.asarray(bm_h.tiles), jnp.asarray(bm_h.brow),
                         jnp.asarray(bm_h.bcol), jnp.asarray(scc),
                         jnp.asarray(scv), jnp.asarray(lb),
                         jnp.asarray(snz), jnp.asarray(n_h))
    w_hs = np.asarray(w_hs)[:n_h]
    np.testing.assert_array_equal(np.isnan(w_hs), np.isnan(w_ref))
    np.testing.assert_allclose(w_hs[mk], w_ref[mk], rtol=1e-4)
    print("OK sharded hybrid ICE (scan reduce) matches single-device")

    # --- sharded TAD Baum-Welch (nested while_loop under GSPMD) -----------
    from hichap_master_tpu.models.tads import init_parameters
    from hichap_master_tpu.ops.hmm import _baum_welch_device, _pad_sequences
    from hichap_master_tpu.parallel import sharded_tads_em

    model = init_parameters(3)
    seqs = [np.sin(np.linspace(0, 6, 40 + 7 * (i % 5))).astype(np.float32)
            * (2.0 + (i % 3)) + rng.normal(0, 0.3, 40 + 7 * (i % 5))
            for i in range(32)]
    X, L = _pad_sequences(seqs)
    margs = (jnp.asarray(model.A), jnp.asarray(model.pi),
             jnp.asarray(model.means), jnp.asarray(model.varis),
             jnp.asarray(model.weights), jnp.asarray(model.A <= 0),
             jnp.asarray(model.pi <= 0))
    em = sharded_tads_em(mesh, tol=1e-6, max_iters=10)
    it_s, params_s, ll_s = em(jnp.asarray(X), jnp.asarray(L), *margs)
    it_1, params_1, ll_1 = _baum_welch_device(
        jnp.asarray(X), jnp.asarray(L), *margs, 1e-6, 10)
    assert int(np.asarray(it_s)) == int(np.asarray(it_1))
    np.testing.assert_allclose(float(ll_s), float(ll_1), rtol=1e-4)
    for p_s, p_1 in zip(params_s, params_1):
        # psum reduction order differs from the single-device einsum tree;
        # f32 drift compounds ~1e-7/EM step
        np.testing.assert_allclose(np.asarray(p_s), np.asarray(p_1),
                                   rtol=2e-3, atol=1e-5)
    print("OK sharded TAD Baum-Welch matches single-device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
