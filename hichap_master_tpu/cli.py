"""hichap-tpu command line — sub-command parity with ``scripts/hichap``.

(The command keeps its historical name; the program runs on a GPU.)

The reference CLI (scripts/hichap:11-437) exposes eight sub-commands coupled
by a workspace directory convention; all eight exist here with the same
names, flags and defaults, plus analysis sub-commands (``compartment``,
``tads``, ``loops``, ``specificity``) for the layers the reference leaves
library-only (README.md:348-397).

Workspace convention (scripts/hichap:27-31): each stage writes a canonically
named folder that the next stage discovers by default:

    genome/  fastqchunks/  Global_bams/  RescueFastq/  ReMap_bams/
    UniqRawBed/  Filtered_Bed|Allelic_Bed/  Matrix/Cooler/
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .utils.logging import get_logger, setup_logging

log = get_logger("hichap_master_tpu.cli")

WS_DIRS = {
    "genome": "genome",
    "chunks": "fastqchunks",
    "global": "Global_bams",
    "rescue": "RescueFastq",
    "remap": "ReMap_bams",
    "rawbed": "UniqRawBed",
    "filtered": "Filtered_Bed",
    "allelic": "Allelic_Bed",
    "matrix": "Matrix",
}


def _ws(args, key):
    d = os.path.join(args.workspace, WS_DIRS[key])
    os.makedirs(d, exist_ok=True)
    return d


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hichap-tpu",
        description="JAX diploid Hi-C analysis framework")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s 0.1.0")
    sub = parser.add_subparsers(dest="command")

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-log", "--logfile", default="HiCHap.log")
    common.add_argument("-w", "--workspace", default="hichap_workspace")
    common.add_argument("-r", "--resume", action="store_true", default=False,
                        help="skip this stage when its canonical output "
                             "folder is already populated (stage-granular "
                             "checkpoint/resume, like re-invoking the "
                             "reference's sub-commands)")

    p = sub.add_parser("rebuildG", parents=[common],
                       help="rebuild parental genomes from phased SNPs")
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-S", "--Snp", default=None)
    p.add_argument("-e", "--enzyme", default="MboI")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("rebuildF", parents=[common],
                       help="split FASTQ mates into tagged chunks")
    p.add_argument("-1", "--fastq1", required=True)
    p.add_argument("-2", "--fastq2", required=True)
    p.add_argument("-c", "--chunksize", type=int, default=4_000_000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    for name in ("GlobalMapping", "ReMapping"):
        p = sub.add_parser(name, parents=[common],
                           help=f"{name} with bowtie2 or the fake aligner")
        p.add_argument("-b", "--bowtie2Path", default="bowtie2")
        p.add_argument("-f", "--fastq", default=None)
        p.add_argument("-i", "--bowtieIndex", nargs="+", required=True)
        p.add_argument("-o", "--out", default=None)
        p.add_argument("-m", "--mode", choices=["PBS", "WS"], default="WS")
        p.add_argument("-wt", "--WSthreads", type=int, default=16)
        p.add_argument("-pt", "--PBSthreads", type=int, nargs="+",
                       default=[20, 4])
        p.add_argument("-mem", "--memory", type=int, default=10)
        p.add_argument("-PBSlog", "--PBSlogfile", default=None)
        p.add_argument("--fake-aligner", action="store_true", default=False,
                       help="use the deterministic FakeAligner (indexes are "
                            "FASTA paths); hermetic testing")
        p.add_argument("--bam-format", action="store_true", default=False,
                       help="store mapped chunks as BGZF .bam (the "
                            "reference's workspace format) instead of SAM "
                            "text; WS mode only")

    p = sub.add_parser("Rescue", parents=[common],
                       help="cut unmapped reads at ligation junctions")
    p.add_argument("-b", "--bam", default=None)
    p.add_argument("-e", "--enzyme", default="MboI")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("bamProcess", parents=[common],
                       help="integrate alignments into bed records")
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-gb", "--Globalbam", default=None)
    p.add_argument("-rb", "--Rebam", default=None)
    p.add_argument("-f", "--fragments", nargs="+", required=True)
    p.add_argument("-s", "--snp", default=None)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--rfo", action="store_true", default=False,
                   help="relaxed uniqueness: keep best-scoring multireads")
    p.add_argument("--readlen", type=int, default=150,
                   help="uncut-mate read length sentinel")

    p = sub.add_parser("filtering", parents=[common],
                       help="HiC noise filtering + allelic assignment")
    p.add_argument("-b", "--bed", default=None)
    p.add_argument("-uc", "--unclean", action="store_true", default=False)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("matrix", parents=[common],
                       help="contact matrices + correction + cooler output")
    p.add_argument("-b", "--bedPath", nargs="+", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-gs", "--genomeSize", required=True)
    p.add_argument("-wR", "--wholeRes", nargs="+", type=int, default=None)
    p.add_argument("-lR", "--localRes", nargs="+", type=int,
                   default=[500_000, 40_000])
    p.add_argument("-ratio", "--ImputationRatio", type=float, default=0.9)
    p.add_argument("-min", "--ImputationMin", type=int, default=2)
    p.add_argument("-region", "--ImputationRegion", type=int,
                   default=10_000_000)
    p.add_argument("-C", "--chroms", nargs="*", default=["#", "X"])

    # ---- analysis layers (library-only in the reference) -----------------
    p = sub.add_parser("compartment", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--traditional-pc", default=None)
    p.add_argument("--sliding", action="store_true", default=False)
    p.add_argument("--plot", action="store_true", default=False)
    # 'legacy' = the reference's Select_PC (StructureFind.py:345-372)
    p.add_argument("--pc-selector", default="new", choices=["new", "legacy"])

    p = sub.add_parser("tads", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--minTAD", type=int, default=200_000)
    p.add_argument("--maxTAD", type=int, default=4_000_000)
    p.add_argument("--state-num", type=int, default=3, choices=[3, 5, 6])
    p.add_argument("--window", type=int, default=600_000)
    p.add_argument("--test-type", default="ttest",
                   choices=["ttest", "chitest"])
    p.add_argument("--plot", action="store_true", default=False)

    p = sub.add_parser("loops", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--gap-file", default=None)
    p.add_argument("--loop-ratio", type=float, default=0.6)
    p.add_argument("--loop-strength", type=float, default=16)

    p = sub.add_parser("specificity", parents=[common])
    p.add_argument("kind", choices=["loop", "boundary", "compartment"])
    p.add_argument("-c", "--cooler", default=None)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="loop/boundary file, or maternal+paternal PC files")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--offset", type=int, default=10)

    return parser


_DONE_MARK = ".hichap_stage_done"


def _stage_done(args, out_dir) -> bool:
    """Stage-granular resume: skip only stages this CLI COMPLETED (a
    completion marker is written at the end of each resumable stage) —
    "any non-empty file exists" also matched the partial outputs of a
    crashed stage and skipped straight past the failure."""
    if not getattr(args, "resume", False):
        return False
    if out_dir and os.path.exists(os.path.join(out_dir, _DONE_MARK)):
        log.log(21, "resume: stage completed previously under %s — skipping",
                out_dir)
        return True
    return False


_STAGE_OUT = {
    "rebuildG": "genome", "rebuildF": "chunks", "GlobalMapping": "global",
    "Rescue": "rescue", "ReMapping": "remap", "bamProcess": "rawbed",
}


def run(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    os.makedirs(args.workspace, exist_ok=True)
    setup_logging(os.path.join(args.workspace, args.logfile))
    from .utils.device import setup_compile_cache

    setup_compile_cache()
    log.log(21, "hichap-tpu %s args: %s", args.command, vars(args))

    stage_out_dir = None
    if args.command in _STAGE_OUT:
        stage_out_dir = getattr(args, "out", None) or os.path.join(
            args.workspace, WS_DIRS[_STAGE_OUT[args.command]])
        if _stage_done(args, stage_out_dir):
            return 0
    t_start = time.perf_counter()

    if args.command == "rebuildG":
        from .pipeline.genome_rebuild import (
            build_raw_genome, rebuild_genome, snps_integration)
        out = args.out or _ws(args, "genome")
        os.makedirs(out, exist_ok=True)
        if args.NonAllelic:
            build_raw_genome(args.genome, args.enzyme, out, args.threads)
        else:
            if not args.Snp:
                parser.error("rebuildG needs -S/--Snp unless -N")
            npz = snps_integration(args.Snp, out)
            rebuild_genome(args.genome, npz, args.enzyme, out, args.threads)

    elif args.command == "rebuildF":
        from .pipeline.chunking import split_reads
        out = args.out or _ws(args, "chunks")
        split_reads(args.fastq1, out, args.chunksize, 1)
        split_reads(args.fastq2, out, args.chunksize, 2)

    elif args.command in ("GlobalMapping", "ReMapping"):
        from .pipeline.mapping import (
            Bowtie2Aligner, FakeAligner, pbs_mapping, ws_mapping,
            ws_rescue_mapping)
        is_global = args.command == "GlobalMapping"
        fastq = args.fastq or _ws(args, "chunks" if is_global else "rescue")
        out = args.out or _ws(args, "global" if is_global else "remap")
        fmt = "bam" if args.bam_format else "sam"
        if args.bam_format and args.mode == "PBS" and not args.fake_aligner:
            raise SystemExit("--bam-format requires WS mode (PBS jobs "
                             "run bowtie2 one-liners that emit SAM)")
        aligner = (FakeAligner() if args.fake_aligner
                   else Bowtie2Aligner(args.bowtie2Path,
                                       max(1, args.WSthreads // 4)))
        if is_global:
            if args.mode == "PBS" and not args.fake_aligner:
                pbs_mapping(fastq, out, args.bowtieIndex, cell="hichap",
                            bowtie2=args.bowtie2Path,
                            threads=args.PBSthreads[1],
                            num_task=args.PBSthreads[0], mem_gb=args.memory,
                            log_dir=args.PBSlogfile)
            else:
                ws_mapping(fastq, out, args.bowtieIndex, aligner=aligner,
                           out_format=fmt)
        else:
            tags = (["Maternal", "Paternal"] if len(args.bowtieIndex) == 2
                    else [""])
            idx_by_tag = dict(zip(tags, args.bowtieIndex))
            if args.mode == "PBS" and not args.fake_aligner:
                from .pipeline.mapping import pbs_rescue_mapping
                pbs_rescue_mapping(fastq, out, idx_by_tag, cell="hichap",
                                   bowtie2=args.bowtie2Path,
                                   threads=args.PBSthreads[1],
                                   num_task=args.PBSthreads[0],
                                   mem_gb=args.memory,
                                   log_dir=args.PBSlogfile)
            else:
                ws_rescue_mapping(fastq, out, idx_by_tag, aligner=aligner,
                                  out_format=fmt)

    elif args.command == "Rescue":
        from .pipeline.rescue import cutting_reads_to_remapping
        aln = args.bam or _ws(args, "global")
        out = args.out or _ws(args, "rescue")
        # every chunk alignment rescues independently — Maternal and
        # Paternal files alike — so the haplotype mark never narrows the
        # selection here; -N stays accepted for reference-CLI parity
        cutting_reads_to_remapping(aln, out, args.enzyme, "NonAllelic",
                                   args.threads)

    elif args.command == "bamProcess":
        from .pipeline.bam_process import bam_extract
        gdir = args.Globalbam or _ws(args, "global")
        rdir = args.Rebam or _ws(args, "remap")
        out = args.out or _ws(args, "rawbed")
        bam_extract(gdir, rdir, out, args.fragments, args.snp,
                    threads=args.threads, level=2 if args.rfo else 1,
                    allelic=not args.NonAllelic, read_len=args.readlen)

    elif args.command == "filtering":
        from .pipeline.filtering import allelic_filtering, hic_filtering
        bed = args.bed or _ws(args, "rawbed")
        if args.NonAllelic:
            out = args.out or _ws(args, "filtered")
            hic_filtering(bed, out, "NonAllelic", clean=not args.unclean)
        else:
            out = args.out or _ws(args, "allelic")
            filt = _ws(args, "filtered")
            hic_filtering(bed, filt, "Maternal", clean=not args.unclean)
            hic_filtering(bed, filt, "Paternal", clean=not args.unclean)
            m_bed = next(os.path.join(filt, f) for f in os.listdir(filt)
                         if "Maternal_Valid" in f)
            p_bed = next(os.path.join(filt, f) for f in os.listdir(filt)
                         if "Paternal_Valid" in f)
            allelic_filtering(m_bed, p_bed, out)

    elif args.command == "matrix":
        from .pipeline.matrix import (
            haplotype_matrix_construction, traditional_matrix_construction)
        if not os.path.exists(args.genomeSize):
            hint = os.path.join(args.workspace, WS_DIRS["genome"],
                                "genomeSize")
            raise FileNotFoundError(
                f"genomeSize file not found: {args.genomeSize!r}"
                + (f" (rebuildG wrote {hint})" if os.path.exists(hint)
                   else " (run rebuildG first; it writes "
                        "<workspace>/genome/genomeSize)"))
        if args.NonAllelic:
            traditional_matrix_construction(
                args.out, args.bedPath, args.genomeSize,
                args.wholeRes or [], args.localRes, args.chroms)
        else:
            haplotype_matrix_construction(
                args.out, args.bedPath, args.genomeSize,
                args.wholeRes or [], args.localRes,
                imputation_region=args.ImputationRegion,
                imputation_min=args.ImputationMin,
                imputation_ratio=args.ImputationRatio, chroms=args.chroms)

    elif args.command == "compartment":
        from .models.compartment import run_compartment
        allelic = False if args.allelic == "False" else args.allelic
        run_compartment(args.cooler, args.resolution, allelic, args.out,
                        sliding=args.sliding,
                        traditional_pc_file=args.traditional_pc,
                        plot=args.plot, selector=args.pc_selector)

    elif args.command == "tads":
        from .models.tads import run_tads
        allelic = False if args.allelic == "False" else args.allelic
        run_tads(args.cooler, args.resolution, allelic, args.out,
                 min_tad=args.minTAD, max_tad=args.maxTAD,
                 state_num=args.state_num, window=args.window,
                 test_type=args.test_type, plot=args.plot)

    elif args.command == "loops":
        from .models.loops import run_loops
        allelic = False if args.allelic == "False" else args.allelic
        run_loops(args.cooler, args.resolution, allelic, args.out,
                  gap_file=args.gap_file, loop_ratio=args.loop_ratio,
                  loop_strength=args.loop_strength)

    elif args.command == "specificity":
        from .models.specificity import (
            BoundaryAllelicSpecificity, CompartmentAllelicSpecificity,
            LoopAllelicSpecificity)
        if args.kind == "loop":
            LoopAllelicSpecificity(args.cooler, args.input[0],
                                   args.resolution).run(args.out)
        elif args.kind == "boundary":
            BoundaryAllelicSpecificity(args.cooler, args.input[0],
                                       args.resolution,
                                       args.offset).run(args.out)
        else:
            CompartmentAllelicSpecificity(args.input[0], args.input[1],
                                          args.resolution).run(args.out)

    if stage_out_dir and os.path.isdir(stage_out_dir):
        with open(os.path.join(stage_out_dir, _DONE_MARK), "w") as f:
            f.write(args.command + "\n")
    _dump_stage_metrics(args, time.perf_counter() - t_start)
    return 0


def _dump_stage_metrics(args, total: float) -> None:
    """Persist per-stage wall-time metrics (utils/profiling.py) plus the
    command total under ``<workspace>/Metrics/<command>.json`` — the
    observability layer the reference lacks (SURVEY §5)."""
    import json

    from .utils import profiling

    m = profiling.metrics()
    m[f"{args.command}.total"] = total
    mdir = os.path.join(args.workspace, "Metrics")
    os.makedirs(mdir, exist_ok=True)
    path = os.path.join(mdir, f"{args.command}.json")
    with open(path, "w") as f:
        json.dump(m, f, indent=2, sort_keys=True)
    log.log(21, "stage metrics written to %s", path)


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
