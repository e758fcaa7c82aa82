"""Device-mesh sharding of the numerical core.

The reference's only parallelism is process fan-out over file chunks
(SURVEY.md §2.2); the scaling axes here are:

* **chromosome batch** (the data-parallel analogue) — the padded
  ``[C, N, N]`` batch shards over the ``chrom`` mesh axis; corrections are
  embarrassingly parallel per chromosome;
* **bin dimension** (the sequence/tensor-parallel analogue) — the
  genome-wide matrix block-shards over the ``bins`` axis; balancing
  marginals are matvecs whose contraction XLA partitions with ``psum``
  collectives.

Everything here annotates shardings on the *same* jitted functions used
on one device (ops/balance.py, ops/correct.py); GSPMD inserts the
collectives.  ``analysis_train_step`` is the "full training step" used by
``__graft_entry__.dryrun_multichip``: genome-wide ICE iteration
(bins-sharded matvec + psum) fused with the per-chromosome two-step
correction (chrom-sharded batch) in one compiled program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.balance import ice_balance
from ..ops.correct import two_step_correction


def make_mesh(n_devices: int | None = None,
              axis_names: Tuple[str, str] = ("chrom", "bins")) -> Mesh:
    """A 2D mesh over the available devices; the chrom axis gets the larger
    factor when the device count is not a perfect square."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    # factor n = a * b with a >= b, a as small as possible >= sqrt(n)
    b = int(np.floor(np.sqrt(n)))
    while n % b:
        b -= 1
    a = n // b
    return Mesh(np.asarray(devs).reshape(a, b), axis_names)


def shard_chrom_batch(batch: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a [C, N, N] batch with chromosomes over the chrom axis and rows
    over the bins axis."""
    return jax.device_put(batch, NamedSharding(mesh, P("chrom", "bins", None)))


def sharded_ice_balance(mesh: Mesh):
    """Genome-wide ICE with the matrix block-sharded over the full mesh.

    The per-iteration marginal ``M @ b`` contracts the column dimension;
    with M sharded P('chrom','bins') the contraction reduces over the
    ``bins`` axis — XLA emits a reduce-scatter/psum over ICI.
    """
    m_sharding = NamedSharding(mesh, P("chrom", "bins"))
    rep = NamedSharding(mesh, P())

    def fn(M, n):
        return ice_balance(M, n, max_iters=50)

    return jax.jit(fn, in_shardings=(m_sharding, rep),
                   out_shardings=(rep, None))


def sharded_two_step(mesh: Mesh):
    """Per-chromosome two-step correction, batch sharded over chrom and the
    row dimension sharded over bins."""
    b_shard = NamedSharding(mesh, P("chrom", "bins", None))
    n_shard = NamedSharding(mesh, P("chrom"))

    fn = jax.vmap(two_step_correction, in_axes=(0, 0, 0, 0))
    return jax.jit(fn, in_shardings=(b_shard, b_shard, b_shard, n_shard),
                   out_shardings=(b_shard, b_shard, n_shard, n_shard))


def sharded_genomewide_correction(mesh: Mesh):
    """Genome-wide two-step: alpha scaling + symmetrization + VC(2/3) on a
    bins-sharded matrix (row/col sums become cross-device reductions)."""
    from ..ops.correct import genomewide_correction

    m_sharding = NamedSharding(mesh, P("chrom", "bins"))
    v_sharding = NamedSharding(mesh, P("bins"))
    rep = NamedSharding(mesh, P())

    def fn(H, alpha, total):
        return genomewide_correction(H, alpha, total)

    return jax.jit(fn, in_shardings=(m_sharding, v_sharding, rep),
                   out_shardings=m_sharding)


def sharded_sparse_ice(mesh: Mesh, R: int, T: int, *, max_iters: int = 200,
                       tol: float = 1e-5, reduce: str = "onehot"):
    """Genome-wide ICE on the block-sparse layout (ops/sparse.py), tiles
    sharded over the flattened (chrom x bins) device set.

    Each device holds K/D tiles; the per-iteration marginal's block-row
    reduction is a [R, K] @ [K, T] contraction over the sharded tile axis,
    which GSPMD partitions into a psum over ICI — the bias vector stays
    replicated (R*T floats, trivially small next to the tiles).  This is the
    formulation that makes a true genome-wide 10 kb matrix (~304k bins for
    hg19, ~370 GB dense) representable: storage scales with occupied tiles
    and shards linearly across the mesh.  Pad K to the device count with
    ``ops.sparse.pad_blocks``.
    """
    from ..ops.sparse import sparse_ice_balance

    tile_s = NamedSharding(mesh, P(("chrom", "bins"), None, None))
    k_s = NamedSharding(mesh, P(("chrom", "bins")))
    rep = NamedSharding(mesh, P())

    def fn(tiles, brow, bcol, n):
        return sparse_ice_balance(tiles, brow, bcol, n, R=R, T=T,
                                  max_iters=max_iters, tol=tol, reduce=reduce)

    return jax.jit(fn, in_shardings=(tile_s, k_s, k_s, rep),
                   out_shardings=(rep, None))


def sharded_sparse_genomewide(mesh: Mesh, R: int, T: int,
                              reduce: str = "onehot"):
    """Genome-wide two-step correction on asymmetric block storage
    (ops/sparse.sparse_genomewide_correction), U/L tile pairs sharded over
    the flattened device set; the VC row sums psum over the mesh and the
    corrected tiles come back still sharded (never densified)."""
    from ..ops.sparse import sparse_genomewide_correction

    tile_s = NamedSharding(mesh, P(("chrom", "bins"), None, None))
    k_s = NamedSharding(mesh, P(("chrom", "bins")))
    rep = NamedSharding(mesh, P())

    def fn(U, L, brow, bcol, alpha_full):
        return sparse_genomewide_correction(U, L, brow, bcol, alpha_full,
                                            R=R, T=T, reduce=reduce)

    return jax.jit(fn, in_shardings=(tile_s, tile_s, k_s, k_s, rep),
                   out_shardings=tile_s)


def shard_hybrid_layout(h, n_devices: int):
    """Host-side prep of a ``HybridGW`` for ``sharded_hybrid_ice``: pads the
    tile and scattered-pixel axes to the device count and builds per-device
    CLAMPED row bounds.

    The scattered pixels are row-sorted; sharding them in contiguous ranges
    means device d sees rows' pixels in [d*per, (d+1)*per).  Its local
    bounds are the global bounds shifted by the range start and clipped to
    the range — rows fully outside become empty segments, rows spanning a
    boundary get partial sums on both devices, and the psum of the
    per-device compensated-scan marginals reassembles the exact row sums.

    Returns (BlockMatrix padded, sc_cols [Pd], sc_vals [Pd],
    lbounds [D, N+1], sc_nnz [N]).
    """
    from ..ops.sparse import pad_blocks

    bm = pad_blocks(h.bm, n_devices)
    N = bm.R * bm.T
    D = n_devices
    P_ = h.P
    per = -(-P_ // D)
    Pd = per * D
    sc_cols = np.zeros(Pd, np.int32)
    sc_vals = np.zeros(Pd, np.float32)
    sc_cols[:P_] = np.asarray(h.sc_cols)
    sc_vals[:P_] = np.asarray(h.sc_vals, np.float32)
    gb = np.full(N + 1, h.bounds[-1], np.int64)
    gb[: h.bounds.size] = np.asarray(h.bounds)
    starts = (np.arange(D, dtype=np.int64) * per)[:, None]
    lbounds = np.clip(gb[None, :] - starts, 0, per).astype(np.int32)
    sc_nnz = np.zeros(N, np.float32)
    sc_nnz[: h.sc_nnz.size] = np.asarray(h.sc_nnz)
    return bm, sc_cols, sc_vals, lbounds, sc_nnz


def sharded_hybrid_ice(mesh: Mesh, R: int, T: int, *, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0, tol: float = 1e-5,
                       max_iters: int = 200, reduce: str = "onehot"):
    """The PRODUCTION genome-wide 10 kb weights path
    (ops/sparse_hybrid.hybrid_ice_balance, used by
    pipeline/matrix._write_weights) over a device mesh.

    Tiles shard over the flattened (chrom x bins) device set exactly like
    ``sharded_sparse_ice``; the scattered COO remainder shards in contiguous
    row-sorted ranges, each device running the compensated-prefix segment
    sums against its CLAMPED local bounds (``shard_hybrid_layout``), and the
    two partial marginals psum over the mesh inside a ``shard_map`` region.
    Filter semantics and the convergence loop are byte-identical to the
    single-device ``hybrid_ice_balance``; parity is pinned by
    testing/sharding_check.py.  Replaces the reference's host-bound
    ``cooler balance`` subprocess (HiCHap/matrixBuilding.py:706-714), which
    cannot reach genome-wide 10 kb at all.

    ``reduce`` selects the per-shard tile block-row reduction (``"onehot"``
    or ``"scan"``): inside the shard_map region both are pure per-device
    computations over the local tile shard producing a [R*T] partial that
    the explicit ``psum`` combines, so the compensated-scan strategy shards
    exactly as cleanly here as the one-hot matmul (unlike the GSPMD
    auto-partitioned ``sharded_sparse_ice``, where the scan's
    data-dependent gathers would force all-gathers and ``"onehot"`` stays
    pinned).

    Call via: fn(tiles, brow, bcol, sc_cols, sc_vals, lbounds, sc_nnz, n)
    with arrays from ``shard_hybrid_layout``.
    """
    import functools

    from ..ops.masked import masked_mean, masked_median, masked_var
    from ..ops.sparse import block_sym_matvec
    from ..ops.sparse_hybrid import _segment_sums

    flat = ("chrom", "bins")
    N = R * T
    tile_s = NamedSharding(mesh, P(flat, None, None))
    k_s = NamedSharding(mesh, P(flat))
    px_s = NamedSharding(mesh, P(flat))
    d_s = NamedSharding(mesh, P(flat, None))
    rep = NamedSharding(mesh, P())

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(flat, None, None), P(flat), P(flat), P(flat), P(flat),
                  P(flat, None), P()),
        out_specs=P())
    def _marg(tiles, brow, bcol, sc_cols, sc_vals, lbounds, b):
        y = block_sym_matvec(tiles, brow, bcol, b, R=R, T=T,
                             reduce=reduce)
        y = y + _segment_sums(sc_vals * b[sc_cols], lbounds[0])
        return jax.lax.psum(y, flat)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(flat, None, None), P(flat), P(flat), P()),
        out_specs=P())
    def _mv_tiles(tiles, brow, bcol, b):
        return jax.lax.psum(
            block_sym_matvec(tiles, brow, bcol, b, R=R, T=T,
                             reduce=reduce), flat)

    def fn(tiles, brow, bcol, sc_cols, sc_vals, lbounds, sc_nnz, n):
        if not jnp.issubdtype(tiles.dtype, jnp.floating):
            tiles = tiles.astype(jnp.float32)
        if not jnp.issubdtype(sc_vals.dtype, jnp.floating):
            sc_vals = sc_vals.astype(tiles.dtype)
        dtype = tiles.dtype
        if ignore_diags > 0:
            li = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
            lj = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
            gdiff = ((bcol - brow).astype(jnp.int32)[:, None, None] * T
                     + (lj - li)[None])
            tiles = jnp.where(jnp.abs(gdiff) < ignore_diags, 0.0, tiles)

        valid = jnp.arange(N) < n
        ones = jnp.where(valid, jnp.ones((), dtype), 0.0)
        marg0 = _marg(tiles, brow, bcol, sc_cols, sc_vals, lbounds,
                      ones) * ones
        nnz = (_mv_tiles((tiles != 0).astype(dtype), brow, bcol, ones)
               + sc_nnz)
        keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)
        if mad_max > 0:
            sel = keep & (marg0 > 0)
            logm = jnp.where(sel, jnp.log(jnp.maximum(marg0, 1e-300)), 0.0)
            med = masked_median(logm, sel)
            dev = masked_median(jnp.abs(logm - med), sel)
            keep = keep & (marg0 >= jnp.exp(med - mad_max * dev))
        b0 = jnp.where(keep, jnp.ones((), dtype), 0.0)

        def body(state):
            it, b, _, _ = state
            marg = _marg(tiles, brow, bcol, sc_cols, sc_vals, lbounds,
                         b) * b
            nz = marg != 0
            mean_nz = masked_mean(marg, nz)
            var = masked_var(marg, nz)
            margn = marg / jnp.where(mean_nz != 0, mean_nz, 1.0)
            margn = jnp.where(margn == 0, 1.0, margn)
            return it + 1, b / margn, var, mean_nz

        def cond(state):
            it, _, var, _ = state
            return (var >= tol) & (it < max_iters)

        init = (jnp.zeros((), jnp.int32), b0, jnp.asarray(jnp.inf, dtype),
                jnp.ones((), dtype))
        iters, b, var, scale = jax.lax.while_loop(cond, body, init)
        w = b / jnp.sqrt(jnp.where(scale > 0, scale, 1.0))
        w = jnp.where(keep & (b != 0), w, jnp.nan)
        return w, {"scale": scale, "var": var, "iters": iters,
                   "converged": var < tol}

    return jax.jit(fn, in_shardings=(tile_s, k_s, k_s, px_s, px_s, d_s,
                                     rep, rep),
                   out_shardings=(rep, None))


def sharded_tads_em(mesh: Mesh, tol: float = 1e-6, max_iters: int = 500):
    """GMM-HMM Baum-Welch (ops/hmm._baum_welch_device — the one
    nested-while_loop program in the framework) with the padded DI-segment
    batch sharded over the flattened (chrom x bins) device set.

    The E-step vmaps over sequences and reduces sufficient statistics over
    the batch axis; with X/L sharded on that axis GSPMD turns each
    reduction into a psum while the parameter state in the while_loop
    carry stays replicated.  Replaces GHMM's single-threaded C Baum-Welch
    (HiCHap/StructureFind.py:1052-1110).

    Returns a jitted fn(X [B,T], L [B], A0, pi0, means0, varis0, weights0,
    zero_A, zero_pi) -> (iters, params, loglik).
    """
    from ..ops.hmm import _baum_welch_device

    flat = ("chrom", "bins")
    x_s = NamedSharding(mesh, P(flat, None))
    l_s = NamedSharding(mesh, P(flat))
    rep = NamedSharding(mesh, P())

    def fn(X, L, A0, pi0, means0, varis0, weights0, zero_A, zero_pi):
        return _baum_welch_device(X, L, A0, pi0, means0, varis0, weights0,
                                  zero_A, zero_pi, tol, max_iters)

    return jax.jit(
        fn,
        in_shardings=(x_s, l_s, rep, rep, rep, rep, rep, rep, rep),
        out_shardings=(None, rep, None))


def analysis_train_step(mesh: Mesh):
    """The framework's full "training step" over a device mesh:

      1. genome-wide ICE iteration block (bins-sharded matvec, psum),
      2. chromosome-batched two-step correction (chrom-sharded),
      3. genome-wide alpha-corrected VC pass.

    Returns a jitted fn(TM, MM, PM, n_bins, G, alpha, total) ->
    (nor_mm, nor_pm, weights, corrected_G, di_batch) compiled over the
    mesh (see __graft_entry__.dryrun_multichip for a worked call).
    """
    b_shard = NamedSharding(mesh, P("chrom", "bins", None))
    n_shard = NamedSharding(mesh, P("chrom"))
    g_shard = NamedSharding(mesh, P("chrom", "bins"))
    v_shard = NamedSharding(mesh, P("bins"))
    rep = NamedSharding(mesh, P())

    def step(TM, MM, PM, n_bins, G, alpha, total):
        from ..ops.correct import genomewide_correction
        from ..ops.di import directionality_index, tad_gap_mask

        nor_mm, nor_pm, _, _ = jax.vmap(two_step_correction)(TM, MM, PM,
                                                             n_bins)
        w, _ = ice_balance(G, total, max_iters=20)
        corrected = genomewide_correction(G, alpha, total)
        # DI over the corrected chromosome batch (the TAD front-end)
        gaps = jax.vmap(lambda m, n: tad_gap_mask(m, n, 4))(nor_mm, n_bins)
        di = jax.vmap(lambda m, g, n: directionality_index(m, g, n, 4))(
            nor_mm, gaps, n_bins)
        return nor_mm, nor_pm, w, corrected, di

    di_shard = NamedSharding(mesh, P("chrom", "bins"))
    return jax.jit(
        step,
        in_shardings=(b_shard, b_shard, b_shard, n_shard, g_shard, v_shard,
                      rep),
        out_shardings=(b_shard, b_shard, rep, g_shard, di_shard))


def sharded_loop_escalation(mesh: Mesh, ww: int, maxww: int, pw: int,
                            e_lo: int, x_pad: int):
    """Map-space loop escalation (ops/loops_packed.py) sharded over the
    mesh: the chromosome axis of the packed-band batch spreads across ALL
    devices (chrom × bins flattened) — band stencils are per-chromosome
    local, so the escalation runs with zero cross-device traffic."""
    from ..ops.loops_packed import _escalation_maps_core

    c3 = NamedSharding(mesh, P(("chrom", "bins"), None, None))
    c2 = NamedSharding(mesh, P(("chrom", "bins"), None))

    def fn(D_raw, D_bal, D_exp, e_pix, x_pix, valid):
        return jax.vmap(
            lambda dr, db, de, ep, xp, v: _escalation_maps_core(
                dr, db, de, ep, xp, v, ww, maxww, pw, e_lo, x_pad)
        )(D_raw, D_bal, D_exp, e_pix, x_pix, valid)

    return jax.jit(fn, in_shardings=(c3, c3, c3, c2, c2, c2),
                   out_shardings=(c2, c2, c2, c2, c2))


def sharded_compartment(mesh: Mesh, step: int = 0,
                        pca_method: str = "subspace"):
    """The fused compartment graph (decay → O/E → correlation → PCA →
    signed PC selection, models/compartment.py) vmapped over a chromosome
    batch and sharded over the flattened (chrom × bins) device set — each
    chromosome's pipeline is device-local, so compartments scale
    embarrassingly across the mesh.

    Returns a jitted fn(Mb, gapb, nb, ngb, gb) -> (oe, cor, pcs, pc) with
    Mb [C, N, N]; gapb [C, N] bool; nb/gb [C] ints; ngb [C, N] gather index
    of non-gap columns (pad with 0)."""
    from ..models.compartment import _compartment_fused

    c3 = NamedSharding(mesh, P(("chrom", "bins"), None, None))
    c2 = NamedSharding(mesh, P(("chrom", "bins"), None))
    c1 = NamedSharding(mesh, P(("chrom", "bins")))

    def fn(Mb, gapb, nb, ngb, gb):
        return jax.vmap(
            lambda m, g, n, ng, gg: _compartment_fused.__wrapped__(
                m, g, n, ng, gg, step, pca_method)
        )(Mb, gapb, nb, ngb, gb)

    return jax.jit(fn, in_shardings=(c3, c2, c1, c2, c1),
                   out_shardings=(c3, c3, None, c2))
