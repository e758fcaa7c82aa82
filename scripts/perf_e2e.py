"""TRUE end-to-end measurement: valid beds → matrix/coolers → cooler-backed
compartments / TADs / loops, at real hg19 chromosome sizes.

perf_hg19.py measures the analysis stages on synthetic device arrays; this
script runs the ACTUAL product path a user hits — streamed bed ingestion,
traditional matrix construction (500 kb genome-wide + 40 kb local + 10 kb
genome-wide hybrid-sparse), ICE weights, cooler writes, then
``run_compartment`` / ``run_tads`` / ``run_loops`` reading those coolers
(including ``run_loops``'s dense fetch + selection + clustering host
stages).  Scale anchor: the reference's GM12878 example is 42 GB FASTQ
per mate (README.md:52-55); PERF_E2E_PAIRS valid pairs (default 5e7)
is the corresponding order of post-filter contacts.

The bed→matrix stage is where ingestion lives; ``parse_only_s`` isolates
the pure parse share of that wall.

Prints the stage walls as one JSON line at the end.

    python scripts/perf_e2e.py                      # full, on a GPU
    PERF_SCALE=64 PERF_E2E_PAIRS=2e5 JAX_PLATFORMS=cpu python scripts/perf_e2e.py
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np

from perf_sparse_gw import HG19

_S = int(os.environ.get("PERF_SCALE", "1"))
CHROMS = {**{str(i + 1): l // _S for i, l in enumerate(HG19[:22])},
          "X": HG19[22] // _S}
PAIRS = int(float(os.environ.get("PERF_E2E_PAIRS", "5e7")))
RES_LOOP, RES_TAD, RES_COMP = 10_000, 40_000, 500_000

RESULTS = {}


def timed(label, key, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    print(f"{label:56s} {dt:8.2f} s", flush=True)
    RESULTS[key] = round(dt, 2)
    return out, dt


def gen_beds(rep_dir: str, rng) -> str:
    """PAIRS valid pairs in the 15-column bed format: 75% intra with
    log-uniform distances 1 kb-5 Mb, 25% inter uniform — the shape that
    stresses both the banded tile mass and the scattered trans pixels."""
    from hichap_master_tpu.testing.synthetic import (power_law_pairs,
                                                     write_valid_bed_bulk)

    os.makedirs(rep_dir, exist_ok=True)
    labels = list(CHROMS)
    path = os.path.join(rep_dir, "E2E_R1_Valid.bed")
    cols = power_law_pairs(rng, np.asarray([CHROMS[c] for c in labels]),
                           PAIRS)
    write_valid_bed_bulk(path, labels, *cols)
    print(f"generated {PAIRS/1e6:.1f}M pairs "
          f"({os.path.getsize(path)/2**30:.2f} GB)", flush=True)
    return path


def main():
    import logging
    import tempfile

    import jax

    if os.environ.get("PERF_VERBOSE") == "1":
        logging.basicConfig(level=21, stream=sys.stdout,
                            format="%(name)s: %(message)s")
    from hichap_master_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    from hichap_master_tpu.core import Genome
    from hichap_master_tpu.io.bedio import iter_valid_bed
    from hichap_master_tpu.models.compartment import run_compartment
    from hichap_master_tpu.models.loops import run_loops
    from hichap_master_tpu.models.tads import run_tads
    from hichap_master_tpu.pipeline.matrix import (
        traditional_matrix_construction)

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="perf_e2e_")
    print(f"devices: {jax.devices()}", flush=True)
    print(f"genome: {len(CHROMS)} chroms, {sum(CHROMS.values())/1e6:.0f} Mb"
          f" (hg19{'/' + str(_S) if _S > 1 else ''}), "
          f"{PAIRS/1e6:.1f}M pairs", flush=True)

    g = Genome(CHROMS)
    gsz = os.path.join(tmp, "genomeSize")
    g.write(gsz)
    # PERF_E2E_BED reuses a previously generated replicate dir (generation
    # is ~13 min of untimed setup at full scale)
    rep = os.environ.get("PERF_E2E_BED") or os.path.join(tmp, "rep1")
    bed = os.path.join(rep, "E2E_R1_Valid.bed")
    if os.path.exists(bed):
        print(f"reusing {bed} ({os.path.getsize(bed)/2**30:.2f} GB)",
              flush=True)
    else:
        bed = gen_beds(rep, rng)  # generation is setup, not measured e2e

    total = 0.0

    # ingestion share: one pure-parse pass over the bed
    def _parse():
        npairs = 0
        for c1, _p1, _c2, _p2 in iter_valid_bed([bed], g):
            npairs += len(c1)
        return npairs

    npairs, w = timed("parse-only pass (ingestion share)", "parse_only_s",
                      _parse)
    print(f"  parsed {npairs/1e6:.1f}M pairs "
          f"({npairs/max(w,1e-9)/1e6:.2f} M pairs/s)", flush=True)

    # beds → matrices → coolers → weights (the measured product stage)
    out_dir = os.path.join(tmp, "Matrix")
    whole = [RES_COMP, RES_LOOP]
    _, w = timed(
        f"matrix: beds → coolers (500kb GW + 40kb local + 10kb GW) + ICE",
        "matrix_s",
        lambda: traditional_matrix_construction(
            out_dir, [rep], gsz, whole_res=whole, local_res=[RES_TAD]))
    total += w
    cool = os.path.join(out_dir, "Cooler", "Merged_Multi.cool")

    _, w = timed("compartments 500kb (cooler-backed)", "compartments_s",
                 lambda: run_compartment(cool, RES_COMP, False,
                                         os.path.join(tmp, "PC")))
    total += w
    _, w = timed("TADs 40kb (cooler-backed)", "tads_s",
                 lambda: run_tads(cool, RES_TAD, False,
                                  os.path.join(tmp, "TAD"), plot=False))
    total += w
    _, w = timed("loops 10kb (run_loops: fetch+call+select+cluster)",
                 "loops_s",
                 lambda: run_loops(cool, RES_LOOP, False,
                                   os.path.join(tmp, "Loops")))
    total += w

    from hichap_master_tpu.utils.profiling import metrics
    RESULTS["stage_walls"] = {k: round(v, 2) for k, v in metrics().items()}
    RESULTS["total_s"] = round(total, 1)
    RESULTS["pairs"] = PAIRS
    RESULTS["scale_divisor"] = _S
    RESULTS["device"] = jax.devices()[0].device_kind
    RESULTS["ingestion_share_of_matrix"] = round(
        RESULTS["parse_only_s"] / max(RESULTS["matrix_s"], 1e-9), 3)
    print(f"\nTRUE E2E (beds → coolers → calls) at hg19"
          f"{'/' + str(_S) if _S > 1 else ''}: {total:.1f} s "
          f"(+{RESULTS['parse_only_s']:.0f}s pure parse inside matrix)",
          flush=True)
    print(json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    main()
