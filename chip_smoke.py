#!/usr/bin/env python3
"""Smoke run of the whole product path on one GPU.

Phases, in order:

1. device - what JAX sees, the card, optional imports, the native library
   and the compile cache;
2. parity - each device stage against its plain float64 reference at real
   hg19 widths;
3. traditional end to end - valid beds -> ``matrix -N`` (500 kb and 10 kb
   genome-wide, 40 kb local) -> compartments (500 kb), TADs (40 kb) and
   loops (10 kb), all through ``hichap_master_tpu.cli.run``;
4. diploid end to end - allelic beds -> ``matrix`` (imputation, two-step
   correction; 500 kb and 10 kb genome-wide, 40 kb local) -> TADs and
   loops (40 kb, the resolution the matrix stage writes gaps for) on the
   maternal haplotype, with the gap file the matrix stage writes.

Bin counts, matrix shapes and device-resident state are full hg19; only
depth (valid pairs) is cut.  Data is generated from ``--seed``.  The last
line of standard output is one JSON object naming the device.  Exits
non-zero when JAX finds no GPU, unless ``--rehearse`` (a tiny run for the
CPU: parity widths and the end-to-end genome cut down), and when any
phase fails.

    python chip_smoke.py
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# depth of the end-to-end runs (valid pairs); GM12878 libraries hold
# billions of contacts (Rao et al. 2014), so this is the one cut
TRAD_PAIRS = 20_000_000
HAP_PAIRS = {"Bi_Allelic": 10_000_000, "M_M": 1_500_000, "P_P": 1_500_000,
             "M_P": 150_000, "P_M": 150_000}
# --rehearse: parity widths are divided by REHEARSE_LEN; the end-to-end
# runs use two chromosomes at 1/8 of their length and 1/100 of the pairs
REHEARSE_LEN, REHEARSE_PAIRS = 64, 100
REHEARSE_E2E = {"21": 8, "22": 8}
SIG = 0.05


def _cdiv(a, b):
    return -(-a // b)


class Smoke:
    def __init__(self, rehearse: bool, seed: int):
        import jax

        from hichap_master_tpu.testing.synthetic import HG19

        self.jax = jax
        self.rehearse = rehearse
        self.len_div = REHEARSE_LEN if rehearse else 1
        self.pair_div = REHEARSE_PAIRS if rehearse else 1
        self.sizes = {c: n // self.len_div for c, n in HG19.items()}
        self.e2e_sizes = ({c: HG19[c] // k for c, k in REHEARSE_E2E.items()}
                          if rehearse else dict(HG19))
        self.seed = seed
        self.failures = []

    # ------------------------------------------------------------ helpers
    def rng(self, k: int):
        return np.random.default_rng([self.seed, k])

    def compiled(self, name, fn, *args, **static):
        """Compile ``fn`` for these arguments and print its memory use."""
        c = fn.lower(*args, **static).compile()
        ma = c.memory_analysis()
        if ma is None:
            print(f"  compiled {name}: memory analysis not available")
        else:
            print(f"  compiled {name}: arguments "
                  f"{ma.argument_size_in_bytes / 2**20:.1f} MiB, outputs "
                  f"{ma.output_size_in_bytes / 2**20:.1f} MiB, temporaries "
                  f"{ma.temp_size_in_bytes / 2**20:.1f} MiB")
        return c

    def check(self, name, shape, err, tol, precision, ok=True):
        passed = bool(ok) and err <= tol
        print(f"parity {name} [{shape}]: error {err:.3e} <= tol {tol:.0e} "
              f"({precision}): {'PASS' if passed else 'FAIL'}", flush=True)
        if not passed:
            self.failures.append(name)

    def peak(self, label):
        stats = self.jax.devices()[0].memory_stats()
        peak = (f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB"
                if stats else "not reported on this platform")
        print(f"peak device bytes after {label}: {peak}", flush=True)

    # ------------------------------------------------------ phase 1: device
    def phase_device(self):
        import importlib

        from hichap_master_tpu.io.native import get_lib
        from hichap_master_tpu.utils.device import setup_compile_cache

        jax = self.jax
        d = jax.devices()
        print(f"device: platform={d[0].platform} kind={d[0].device_kind} "
              f"count={len(d)} jax={jax.__version__}")
        if shutil.which("nvidia-smi"):
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            print("card name, power limit (nvidia-smi):")
            print(smi)
        else:
            print("nvidia-smi: not found")
        print(f"compile cache: {setup_compile_cache()}")
        print("loop shape knobs: " + ", ".join(
            f"{k}={os.environ[k]}" for k in sorted(os.environ)
            if k.startswith("HICHAP_LOOP_")))
        for mod in ("h5py", "pandas", "matplotlib"):
            try:
                m = importlib.import_module(mod)
                state = f"installed {getattr(m, '__version__', '?')}"
            except ImportError:
                state = "not installed"
            print(f"optional {mod}: {state} (the main path does not use it)")
        print(f"g++: {shutil.which('g++') or 'not found'}; native hicio: "
              f"{'built' if get_lib() is not None else 'unavailable'}",
              flush=True)

    # ------------------------------------------------------ phase 2: parity
    def phase_parity(self):
        for fn in (self.parity_ice_dense, self.parity_sparse_marginal,
                   self.parity_two_step, self.parity_compartment,
                   self.parity_hmm, self.parity_escalation, self.parity_bh):
            t0 = time.perf_counter()
            fn()
            print(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)",
                  flush=True)
        self.peak("parity")

    def parity_ice_dense(self):
        import jax.numpy as jnp

        from hichap_master_tpu.core.contacts import pad_to_shape
        from hichap_master_tpu.ops.balance import ice_balance
        from hichap_master_tpu.testing.oracles import (
            oracle_ice, synthetic_contact_matrix)

        n = max(_cdiv(self.sizes["1"], 40_000), 96)
        iters = 100
        M = synthetic_contact_matrix(self.rng(1), n, gap_frac=0.05)
        P = pad_to_shape(n)
        Mp = np.zeros((P, P), np.float32)
        Mp[:n, :n] = M
        args = (jnp.asarray(Mp), jnp.asarray(n))
        c = self.compiled("ice_balance", ice_balance, *args, tol=0.0,
                          max_iters=iters)
        w = np.asarray(c(*args)[0])[:n]
        ref = oracle_ice(M, tol=0.0, max_iters=iters)
        fin = ~np.isnan(ref)
        err = float(np.max(np.abs(w[fin] - ref[fin]) / np.abs(ref[fin])))
        self.check("dense ICE chr1@40kb", f"n={n}, {iters} iterations", err,
                   1e-3, "float32, HIGHEST matvec vs float64 oracle",
                   ok=np.array_equal(np.isnan(w), ~fin))

    def parity_sparse_marginal(self):
        import functools

        import jax
        import jax.numpy as jnp
        import scipy.sparse as sp

        from hichap_master_tpu.core import Genome
        from hichap_master_tpu.ops.sparse import block_sym_matvec, blocks_to_coo
        from hichap_master_tpu.ops.sparse_hybrid import (_scattered_marginal,
                                                         hybrid_from_coo)

        rng = self.rng(2)
        n = Genome(self.sizes).total_bins(10_000)
        nb, ns = 8_000_000 // self.pair_div, 2_000_000 // self.pair_div
        r = rng.integers(0, n, nb)
        c = np.minimum(r + np.exp(rng.uniform(0, np.log(500), nb)).astype(
            np.int64), n - 1)
        a, b = rng.integers(0, n, ns), rng.integers(0, n, ns)
        rows = np.concatenate([r, np.minimum(a, b)])
        cols = np.concatenate([c, np.maximum(a, b)])
        keys = np.unique(rows[rows < cols] * n + cols[rows < cols])
        rows, cols = keys // n, keys % n
        vals = (rng.poisson(3.0, keys.size) + 1).astype(np.int32)
        h = hybrid_from_coo(rows, cols, vals, n, assume_unique=True)
        bm = h.bm
        N = bm.R * bm.T
        bounds = np.full(N + 1, h.bounds[-1], np.int32)
        bounds[: h.bounds.size] = h.bounds
        x = np.zeros(N, np.float32)
        x[:n] = rng.uniform(0.5, 1.5, n)

        @functools.partial(jax.jit, static_argnames=("R", "T"))
        def marginal(tiles, brow, bcol, sc_cols, sc_vals, bounds, x, *, R,
                     T):
            t = block_sym_matvec(tiles.astype(jnp.float32), brow, bcol, x,
                                 R=R, T=T)
            return t, _scattered_marginal(
                sc_cols, sc_vals.astype(jnp.float32), bounds, x)

        args = tuple(jnp.asarray(v) for v in (
            bm.tiles, bm.brow, bm.bcol, h.sc_cols, h.sc_vals, bounds, x))
        cm = self.compiled("sparse + hybrid marginal", marginal, *args,
                           R=bm.R, T=bm.T)
        y_t, y_s = (np.asarray(v, np.float64) for v in cm(*args))

        def sym(r_, c_, v_):
            U = sp.coo_matrix((np.asarray(v_, np.float64), (r_, c_)),
                              shape=(N, N)).tocsr()
            return U + U.T - sp.diags(U.diagonal())

        x64 = x.astype(np.float64)
        ref_t = sym(*blocks_to_coo(bm)) @ x64
        ref_all = sym(rows, cols, vals) @ x64

        def rel(y, ref):
            live = ref > 0
            return float(max(np.max(np.abs(y[live] - ref[live]) / ref[live]),
                             np.max(np.abs(y[~live]), initial=0.0)))

        shape = f"hg19@10kb n={n}, {bm.K} tiles, {h.bounds[-1]} scattered"
        self.check("sparse ICE marginal (tiles, reduce=onehot)", shape,
                   rel(y_t, ref_t), 1e-5, "float32 HIGHEST vs scipy float64")
        # the scattered part's prefix sums carry error relative to the
        # mass of a 128-pixel chunk, not of the row: ~128 float32 ulps
        self.check("hybrid ICE marginal (tiles + scattered)", shape,
                   rel(y_t + y_s, ref_all), 1e-4,
                   "float32 HIGHEST + compensated prefix vs scipy float64")

    def parity_two_step(self):
        import jax.numpy as jnp

        from hichap_master_tpu.core.contacts import pad_to_shape
        from hichap_master_tpu.ops.correct import two_step_correction
        from hichap_master_tpu.testing.oracles import (
            oracle_two_step, synthetic_contact_matrix)

        rng = self.rng(3)
        n = max(_cdiv(self.sizes["21"], 40_000), 96)
        TM = synthetic_contact_matrix(rng, n, gap_frac=0.05, scale=120.0)
        half = []
        for p in (0.3, 0.28):
            H = np.triu(rng.binomial(TM.astype(int), p).astype(float))
            half.append(H + np.triu(H, 1).T)
        P = pad_to_shape(n)

        def pad(M):
            out = np.zeros((P, P), np.float32)
            out[:n, :n] = M
            return jnp.asarray(out)

        args = (pad(TM), pad(half[0]), pad(half[1]), jnp.asarray(n))
        c = self.compiled("two_step_correction", two_step_correction, *args)
        nor_mm, nor_pm, gm, gp = (np.asarray(v) for v in c(*args))
        o_mm, o_pm, o_gm, o_gp = oracle_two_step(TM, *half)
        err = 0.0
        for got, want in ((nor_mm, o_mm), (nor_pm, o_pm)):
            got = got[:n, :n]
            big = np.abs(want) > 1e-6 * np.abs(want).max()
            err = max(err, float(np.max(np.abs(got[big] - want[big])
                                        / np.abs(want[big]))))
        same_gaps = (np.array_equal(np.flatnonzero(gm[:n]), o_gm)
                     and np.array_equal(np.flatnonzero(gp[:n]), o_gp))
        self.check("two-step correction chr21@40kb", f"n={n}", err, 1e-4,
                   "float32 vs float64 oracle, gaps exact", ok=same_gaps)

    def parity_compartment(self):
        from hichap_master_tpu.models.compartment import (
            select_pc_new, single_chrom_compartment)
        from hichap_master_tpu.testing.oracles import oracle_compartment

        rng = self.rng(4)
        res = 500_000
        n = max(_cdiv(self.sizes["1"], res), 120)
        sign = np.where((np.arange(n) // 12) % 2 == 0, 1, -1)
        d = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        lam = (2.0 + 0.8 * np.outer(sign, sign)) * 400 / (1 + d)
        M = rng.poisson(lam).astype(float)
        M = np.triu(M) + np.triu(M, 1).T
        dev = single_chrom_compartment(M, res)
        gap, oe, cor, pcs = oracle_compartment(M)
        ng = np.flatnonzero(~gap)
        pc_ref = select_pc_new(cor, oe[np.ix_(ng, ng)], pcs)
        ng_d = dev["nongap"]
        pc_dev = select_pc_new(dev["cor"], dev["oe"][np.ix_(ng_d, ng_d)],
                               dev["pcs"])
        same_gap = np.array_equal(dev["gap"], gap)
        r = float(np.corrcoef(pc_dev, pc_ref)[0, 1]) if same_gap else 0.0
        big = np.abs(pc_ref) >= 0.05 * np.abs(pc_ref).max()
        agree = (float(np.mean(np.sign(pc_dev[big]) == np.sign(pc_ref[big])))
                 if same_gap else 0.0)
        print(f"  compartments: selected-PC sign agreement {agree:.4f}, "
              f"correlation {r:.6f}")
        self.check("compartment selected PC chr1@500kb", f"n={n}",
                   1.0 - r, 1e-4,
                   "float32 subspace PCA vs float64 eigh; 1 - correlation",
                   ok=same_gap and agree >= 0.99)

    def parity_hmm(self):
        import jax.numpy as jnp

        from hichap_master_tpu.core import Genome
        from hichap_master_tpu.models.tads import init_parameters
        from hichap_master_tpu.ops.hmm import _e_step, _pad_sequences
        from hichap_master_tpu.testing.oracles import oracle_gmmhmm_loglik

        rng = self.rng(5)
        g = Genome(self.sizes)
        lengths = [max(g.n_bins(c, 40_000), 8) for c in g.labels]
        state = rng.integers(0, 3, sum(lengths))
        x = rng.normal(np.array([-40.0, 0.0, 40.0])[state], 15.0)
        seqs = np.split(x, np.cumsum(lengths)[:-1])
        m = init_parameters(3)
        X, L = _pad_sequences(seqs)
        args = (jnp.asarray(X, jnp.float32), jnp.asarray(L)) + tuple(
            jnp.asarray(v, jnp.float32)
            for v in (m.A, m.pi, m.means, m.varis, m.weights))
        c = self.compiled("GMM-HMM E-step", _e_step, *args)
        ll = float(c(*args)["loglik"])
        ref = oracle_gmmhmm_loglik(seqs, m.A, m.pi, m.means, m.varis,
                                   m.weights)
        self.check("GMM-HMM log-likelihood hg19@40kb",
                   f"{len(seqs)} sequences, {sum(lengths)} bins",
                   abs(ll - ref) / abs(ref), 1e-4,
                   "float32, HIGHEST products vs float64 forward algorithm")

    def parity_escalation(self):
        from hichap_master_tpu.models.loops import peaks_parameters
        from hichap_master_tpu.ops.loops_packed import (escalation_packed,
                                                        escalation_packed_maps)
        from hichap_master_tpu.testing.synthetic import escalation_case

        p = peaks_parameters(10_000)
        n = max(_cdiv(self.sizes["1"], 10_000), 400)
        B = p["maxapart"] // 10_000
        npix = (1 << 21) // self.len_div
        # a rehearsal climbs 4 window levels, not 16: compile time on a CPU
        maxww = p["ww"] + 3 if self.rehearse else p["maxww"]
        args, kw = escalation_case(self.rng(6), n, B, p["ww"], maxww,
                                   p["pw"], npix)
        cm = self.compiled("escalation_packed_maps", escalation_packed_maps,
                           *args, **kw)
        cp = self.compiled("escalation_packed", escalation_packed, *args,
                           **kw)
        res_m, *vals_m = (np.asarray(v) for v in cm(*args))
        res_p, *vals_p = (np.asarray(v) for v in cp(*args))
        same = np.array_equal(res_m, res_p) and res_m.any() and \
            not res_m.all()
        err = max(float(np.max(np.abs(vm[res_p] - vp[res_p])
                               / np.maximum(np.abs(vp[res_p]), 1.0)))
                  for vm, vp in zip(vals_m, vals_p))
        print(f"  escalation: {int(res_p.sum())} of {npix} pixels resolved")
        self.check("loop escalation, map space vs per pixel, chr1@10kb",
                   f"n={n}, band {B}, {npix} pixels", err, 1e-5,
                   "float32 both; resolved sets exact", ok=same)

    def parity_bh(self):
        import jax.numpy as jnp

        from hichap_master_tpu.ops.stats import poisson_bh_chunked
        from hichap_master_tpu.ops.stats_jax import poisson_bh_chunked_jax

        rng = self.rng(7)
        N = (1 << 21) // self.len_div
        e = rng.uniform(0.5, 30.0, N)
        o = rng.poisson(e * np.where(rng.random(N) < 0.02, 3.0, 1.0)) + 0.0
        args = (jnp.asarray(o, jnp.float32), jnp.asarray(e, jnp.float32),
                jnp.ones(N, bool))
        c = self.compiled("poisson_bh_chunked_jax", poisson_bh_chunked_jax,
                          *args)
        q_dev = np.asarray(c(*args)[1], np.float64)
        q_host = poisson_bh_chunked(o, e)[1]
        flips = int(np.sum((q_dev <= SIG) != (q_host <= SIG)))
        print(f"  Poisson/BH: {flips} q-value flips at sig {SIG} of {N} "
              f"pixels ({int(np.sum(q_host <= SIG))} significant on host)")
        self.check("device Poisson/BH vs host float64", f"{N} pixels",
                   flips / N, 1e-4, "float32 device vs float64 host; "
                   "error = share of pixels whose q <= sig flips")

    # ------------------------------------------------ end-to-end helpers
    def cli(self, argv):
        """One CLI call; prints its stage walls and returns them."""
        from hichap_master_tpu import cli
        from hichap_master_tpu.utils import profiling

        profiling.reset_metrics()
        t0 = time.perf_counter()
        rc = cli.run(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"hichap-tpu {argv[0]} returned {rc}")
        m = profiling.metrics()
        print(f"  {argv[0]}: {wall:.2f} s", flush=True)
        for k in sorted(m):
            print(f"    {k:<40} {m[k]:10.3f}")
        overflow = int(m.get("loops.post_overflow", 0))
        if argv[0] == "loops":
            print(f"    loop post compaction overflows (host path): "
                  f"{overflow}")
        return wall, m

    def genome_file(self, work):
        from hichap_master_tpu.core import Genome

        g = Genome(self.e2e_sizes)
        path = os.path.join(work, "genomeSize")
        g.write(path)
        return g, path

    # --------------------------------------------- phase 3: traditional
    def phase_traditional(self, work):
        from hichap_master_tpu.io import CoolerReader
        from hichap_master_tpu.testing.synthetic import (power_law_pairs,
                                                         write_valid_bed_bulk)

        g, gsz = self.genome_file(work)
        n = TRAD_PAIRS // self.pair_div
        rep = os.path.join(work, "trad_beds")
        os.makedirs(rep)
        t0 = time.perf_counter()
        sizes = np.asarray([g.sizes[c] for c in g.labels])
        c1, p1, c2, p2 = power_law_pairs(self.rng(10), sizes, n)
        n_intra = int(np.sum(c1 == c2))
        write_valid_bed_bulk(os.path.join(rep, "SMOKE_R1_Valid.bed"),
                             g.labels, c1, p1, c2, p2)
        del c1, p1, c2, p2
        print(f"traditional: {len(g.labels)} chromosomes "
              f"({sum(g.sizes.values()) / 1e6:.0f} Mb), {n} valid pairs "
              f"({n_intra} intra); beds generated in "
              f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
        ws = os.path.join(work, "trad_ws")
        out = os.path.join(work, "trad_matrix")
        self.cli(["matrix", "-w", ws, "-N", "-b", rep, "-o", out, "-gs",
                  gsz, "-wR", "500000", "10000", "-lR", "40000"])
        cool = os.path.join(out, "Cooler", "Merged_Multi.cool")
        for res, want in ((500_000, n), (10_000, n), (40_000, n_intra)):
            r = CoolerReader(cool, res)
            v = r.pixels_coo()[2]
            w = r.bins_weight()
            nbins = sum(g.cooler_n_bins(c, res) for c in g.labels)
            if int(v.sum()) != want or r.nbins != nbins:
                raise AssertionError(
                    f"{res}: pixel sum {int(v.sum())} (want {want}), "
                    f"nbins {r.nbins}")
            fin = np.isfinite(w)
            if not fin.any() or not (w[fin] > 0).all():
                raise AssertionError(f"{res}: weights finite {fin.mean():.3f}")
            print(f"  cooler {res}: {v.size} pixels, sum {int(v.sum())} = "
                  f"pairs counted, {fin.mean():.3f} of weights finite")
        calls = {}
        for cmd, res, sub in (("compartment", "500000", "PC"),
                              ("tads", "40000", "TAD"),
                              ("loops", "10000", "Loops")):
            od = os.path.join(work, "trad_" + sub)
            calls[cmd] = self.cli([cmd, "-w", ws, "-c", cool, "-R", res,
                                   "-o", od])
            self.report_calls(cmd, od)
        self.peak("traditional end to end")
        # the loops stage once more with phase walls on; this switch blocks
        # on uploads, so it runs after the end-to-end walls above
        os.environ["HICHAP_LOOP_PHASE_TIMING"] = "1"
        wall, m = self.cli(["loops", "-w", ws, "-c", cool, "-R", "10000",
                            "-o", os.path.join(work, "trad_Loops_phases")])
        del os.environ["HICHAP_LOOP_PHASE_TIMING"]
        for ph in ("escalate", "post"):
            v = m.get(f"loops.phase.{ph}", 0.0)
            print(f"loops phase {ph}: {v:.3f} s = {100 * v / wall:.1f}% of "
                  f"the loops stage ({wall:.2f} s, phase timing on)")

    def report_calls(self, cmd, out_dir):
        files = sorted(glob.glob(os.path.join(out_dir, "*.txt")))
        if not files:
            raise AssertionError(f"{cmd} wrote no output under {out_dir}")
        for f in files:
            with open(f) as fh:
                lines = [ln for ln in fh if ln.strip()]
            for ln in lines:
                for field in ln.split()[1:]:
                    try:
                        v = float(field)
                    except ValueError:
                        continue
                    if not np.isfinite(v):
                        raise AssertionError(f"{f}: non-finite {field!r}")
            print(f"    output {os.path.basename(f)}: {len(lines)} lines")

    # ------------------------------------------------- phase 4: diploid
    def phase_diploid(self, work):
        from hichap_master_tpu.io import CoolerReader
        from hichap_master_tpu.testing.synthetic import (
            power_law_pairs, write_allelic_bed_bulk)

        g, gsz = self.genome_file(work)
        rep = os.path.join(work, "hap_beds")
        os.makedirs(rep)
        rng = self.rng(20)
        sizes = np.asarray([g.sizes[c] for c in g.labels])
        t0 = time.perf_counter()
        total = 0
        for cls, n in HAP_PAIRS.items():
            n //= self.pair_div
            total += n
            cols = power_law_pairs(rng, sizes, n)
            tags = (rng.choice(3, n, p=[0.4, 0.3, 0.3])
                    if cls in ("M_M", "P_P") else None)
            write_allelic_bed_bulk(
                os.path.join(rep, f"SMOKE_R1_Valid_{cls}.bed"), g.labels,
                *cols, tags=tags)
        print(f"diploid: {total} allelic pairs "
              + ", ".join(f"{k} {v // self.pair_div}"
                          for k, v in HAP_PAIRS.items())
              + f"; beds generated in {time.perf_counter() - t0:.1f} s "
              "(set-up)", flush=True)
        ws = os.path.join(work, "hap_ws")
        out = os.path.join(work, "hap_matrix")
        self.cli(["matrix", "-w", ws, "-b", rep, "-o", out, "-gs", gsz,
                  "-wR", "500000", "10000", "-lR", "40000"])
        cdir = os.path.join(out, "Cooler")
        imp = os.path.join(cdir, "SMOKE_R1_Imputated_Haplotype_Multi.cool")
        gap = os.path.join(cdir, "SMOKE_R1_Imputated_Gap.npz")
        for res in (500_000, 10_000, 40_000):
            r = CoolerReader(imp, res)
            v = r.pixels_coo()[2]
            if not (v.size and np.isfinite(v).all() and (v >= 0).all()):
                raise AssertionError(f"imputed cooler {res}: bad counts")
            if len(r.chromnames) != 2 * len(g.labels):
                raise AssertionError(f"imputed cooler {res}: "
                                     f"{len(r.chromnames)} haplotypes")
            print(f"  imputed cooler {res}: {r.nbins} bins, {v.size} "
                  f"pixels, all finite")
        # the matrix stage writes gaps for its local (40 kb) resolution
        # only, so the allelic loops run there, like the reference's own
        # 40 kb loop selection (StructureFind.py:2078-2079); 10 kb local
        # matrices for all of hg19 would be tens of GB of dense host arrays
        for cmd, res, extra in (("tads", "40000", []),
                                ("loops", "40000", ["--gap-file", gap])):
            od = os.path.join(work, f"hap_{cmd}")
            self.cli([cmd, "-w", ws, "-c", imp, "-R", res, "-A", "Maternal",
                      "-o", od] + extra)
            self.report_calls(cmd, od)
        self.peak("diploid end to end")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="a tiny run for the CPU: parity widths / %d, "
                         "end to end on chromosomes %s at 1/8 length with "
                         "pairs / %d; allows a non-GPU device" % (
                             REHEARSE_LEN, "+".join(REHEARSE_E2E),
                             REHEARSE_PAIRS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    # loop-stage shape knobs (USAGE.md section 13): coarse padded shapes,
    # so that the chromosomes share a few compiled loop programs.  With the
    # default buckets hg19 at 10 kb compiles ~20 shape groups, about ten
    # minutes cold on an H100 (PERF.md); the rehearsal pads its two
    # chromosomes to one shape.
    knobs = ({"HICHAP_LOOP_NNZ_FLOOR": str(1 << 17)} if args.rehearse else
             {"HICHAP_LOOP_XP_BUCKET": "8192",
              "HICHAP_LOOP_NNZ_FLOOR": str(1 << 22)})
    for k, v in knobs.items():
        os.environ.setdefault(k, v)
    smoke = Smoke(args.rehearse, args.seed)
    t0 = time.perf_counter()
    print("== phase 1: device", flush=True)
    smoke.phase_device()
    print("== phase 2: parity", flush=True)
    smoke.phase_parity()
    with tempfile.TemporaryDirectory(prefix="hichap_smoke_") as work:
        print("== phase 3: traditional end to end", flush=True)
        smoke.phase_traditional(work)
        print("== phase 4: diploid end to end", flush=True)
        smoke.phase_diploid(work)
    print(f"smoke total: {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failures:
        print(f"chip_smoke: parity failed: {smoke.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
