"""Mapping orchestration: aligner adapters + fault-tolerant executors.

Spec: HiCHap/mapping.py.  Two execution backends mirror the reference:

* **WS** (workstation) — a local process pool, 4 concurrent mapping jobs
  sharing the thread budget (mapping.py:94-187);
* **PBS** — qsub script generation, qstat polling with task throttling, and
  the validate-outputs/resubmit retry loop (mapping.py:421-603).

Both run through one ``RetryingExecutor`` abstraction: submit tasks, validate
expected outputs (missing or <100-byte results count as failures,
mapping.py:308-354), resubmit failures until clean or the retry budget is
exhausted.  Aligners are adapters:

* ``Bowtie2Aligner`` — ``bowtie2 -x idx -U fq`` producing name-sorted SAM
  (the reference pipes through ``samtools view|sort -n``; sorting happens
  here in-process, no samtools dependency);
* ``FakeAligner`` — deterministic exact-match alignment against an in-memory
  genome, for hermetic tests and CI (unique/multi hits set AS/XS so the
  uniqueness logic is exercised).
"""

from __future__ import annotations

import gzip
import multiprocessing
import os
import shutil
import subprocess
import time
from concurrent.futures import ProcessPoolExecutor, as_completed

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.genome import strip_chr
from ..io.sam import AlnRecord, write_sam
from ..utils.device import host_only_worker
from ..utils.logging import get_logger

log = get_logger(__name__)

# fork after jax's threads have started is unsafe; the workers run host
# code only (host_only_worker keeps them off the accelerator)
_MP = multiprocessing.get_context("spawn")

MIN_OUTPUT_BYTES = 100  # mapping.py:330 (outputs smaller than this = failed)


# ------------------------------------------------------------- executors
@dataclass
class Task:
    fn: Callable
    args: tuple
    expected_output: str
    tries: int = 0


_FASTQ_SUFFIXES = (".fastq.gz", ".fastq", ".fq.gz", ".fq")


def _output_ok(path: str, min_bytes: int = MIN_OUTPUT_BYTES) -> bool:
    return os.path.exists(path) and os.path.getsize(path) >= min_bytes


class RetryingExecutor:
    """Local pool with output validation + resubmission (the WS analogue of
    the reference's PBS retry loop)."""

    def __init__(self, workers: int = 4, max_retries: int = 3,
                 min_bytes: int | None = None):
        self.workers = workers
        self.max_retries = max_retries
        # rescue outputs may legitimately be tiny (few unmapped reads):
        # min_bytes=0 validates existence only
        self.min_bytes = MIN_OUTPUT_BYTES if min_bytes is None else min_bytes

    def run(self, tasks: List[Task]) -> None:
        pending = list(tasks)
        while pending:
            with ProcessPoolExecutor(self.workers, mp_context=_MP,
                                     initializer=host_only_worker) as ex:
                futs = {ex.submit(t.fn, *t.args): t for t in pending}
                for fu in as_completed(futs):
                    t = futs[fu]
                    try:
                        fu.result()
                    except Exception as e:  # noqa: BLE001
                        log.warning("task for %s raised: %s",
                                    t.expected_output, e)
            failed = [t for t in pending if not self._ok(t.expected_output)]
            for t in failed:
                t.tries += 1
                if t.tries > self.max_retries:
                    raise RuntimeError(
                        f"mapping output {t.expected_output} still failing "
                        f"after {self.max_retries} retries")
            if failed:
                log.log(21, "resubmitting %d failed mapping task(s)",
                        len(failed))
            pending = failed

    def _ok(self, path: str) -> bool:
        return _output_ok(path, self.min_bytes)


class PBSExecutor:
    """qsub/qstat batch backend (mapping.py:191-306).  Tasks become shell
    one-liners submitted with qsub; submission throttles on the number of
    queued jobs with the given name; outputs validate + resubmit like WS."""

    def __init__(self, num_task: int = 20, mem_gb: int = 10,
                 poll_s: float = 5.0, max_retries: int = 3,
                 qsub: str = "qsub", qstat: str = "qstat"):
        self.num_task = num_task
        self.mem_gb = mem_gb
        self.poll_s = poll_s
        self.max_retries = max_retries
        self.qsub = qsub
        self.qstat = qstat

    def available(self) -> bool:
        return shutil.which(self.qsub) is not None

    def _job_count(self, keyword: str) -> int:
        import xml.etree.ElementTree as ET

        try:
            out = subprocess.run([self.qstat, "-xl"], capture_output=True,
                                 text=True, check=False).stdout
            root = ET.fromstring(out)
        except Exception:  # noqa: BLE001
            return 0
        return sum(1 for j in root if keyword in
                   (j.findtext("Job_Name") or ""))

    def submit_shell(self, cmd: str, name: str, threads: int,
                     log_dir: str) -> None:
        script = (f'echo "{cmd}" | {self.qsub} -N {name} '
                  f"-l nodes=1:ppn={threads} -l mem={self.mem_gb}gb -d ./ "
                  f"-e {log_dir} -o {log_dir}")
        # block until qsub ACCEPTS the job: a fire-and-forget Popen raced
        # the drain loop (qstat could poll before the job appeared,
        # prematurely validating outputs and double-submitting) and
        # leaked zombie handles
        subprocess.run(script, shell=True, capture_output=True, check=False)

    def run_shell_tasks(self, cmds: List[Tuple[str, str]], name: str,
                        threads: int, log_dir: str) -> None:
        """cmds: (shell command, expected output).  Throttle, drain,
        validate, resubmit until clean."""
        pending = list(cmds)
        retries = 0
        while pending:
            for cmd, _out in pending:
                while self._job_count(name) >= self.num_task:
                    time.sleep(self.poll_s)
                self.submit_shell(cmd, name, threads, log_dir)
            # drain: require TWO consecutive zero readings — _job_count
            # reads 0 on a transient qstat error too
            zeros = 0
            while zeros < 2:
                zeros = zeros + 1 if self._job_count(name) <= 0 else 0
                time.sleep(self.poll_s)
            failed = [(c, o) for c, o in pending
                      if not _output_ok(o)]
            if failed:
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"{len(failed)} PBS mapping task(s) still failing")
                log.log(21, "PBS: resubmitting %d failed task(s)", len(failed))
            pending = failed


# -------------------------------------------------------------- aligners
def _read_fastq(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            seq = f.readline().strip()
            f.readline()
            qual = f.readline().strip()
            yield h[1:].split()[0], seq, qual


class Bowtie2Aligner:
    """Subprocess adapter producing name-sorted SAM."""

    def __init__(self, bowtie2: str = "bowtie2", threads: int = 4):
        self.bowtie2 = bowtie2
        self.threads = threads

    def available(self) -> bool:
        return shutil.which(self.bowtie2) is not None

    def map_chunk(self, index: str, fq: str, out_sam: str) -> str:
        tmp = out_sam + ".unsorted"
        cmd = [self.bowtie2, "-x", index, "-p", str(self.threads), "-U", fq,
               "-S", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        # name-sort (samtools sort -n parity, HiCHap/mapping.py:74-76) via
        # the native external-memory sort: constant host memory even for
        # multi-million-read chunks (headers are dropped; every SAM
        # consumer in io/sam.py skips them anyway)
        from ..io.native import sam_sort_merge
        sam_sort_merge([tmp], out_sam)
        os.remove(tmp)
        return out_sam


class FakeAligner:
    """Deterministic exact-substring aligner for hermetic tests.

    Searches the read (and its reverse complement) in every chromosome:
    one hit → mapped with AS=0; several hits → AS=0 plus XS=0
    (multi-mapped under level-1 uniqueness); none → unmapped."""

    _COMP = str.maketrans("ACGT", "TGCA")

    def __init__(self, genome: Optional[Dict[str, str]] = None,
                 max_hits: int = 4):
        self.genome = ({strip_chr(c): s.upper() for c, s in genome.items()}
                       if genome else None)
        self.max_hits = max_hits
        self._cache: Dict[str, Dict[str, str]] = {}

    @classmethod
    def from_fasta(cls, path: str) -> "FakeAligner":
        from ..io.fasta import read_fasta
        return cls({c: a.tobytes().decode() for c, a in
                    read_fasta(path).items()})

    def _genome_for(self, index) -> Dict[str, str]:
        """With no fixed genome, treat the index as a FASTA path (so one
        instance serves both parental indexes)."""
        if self.genome is not None:
            return self.genome
        key = str(index)
        if key not in self._cache:
            from ..io.fasta import read_fasta
            self._cache[key] = {c: a.tobytes().decode().upper()
                                for c, a in read_fasta(key).items()}
        return self._cache[key]

    def _hits(self, seq: str, genome: Dict[str, str]):
        hits = []
        for c, ref in genome.items():
            start = 0
            while len(hits) <= self.max_hits:
                p = ref.find(seq, start)
                if p < 0:
                    break
                hits.append((c, p, 0))
                start = p + 1
        rc = seq.translate(self._COMP)[::-1]
        for c, ref in genome.items():
            start = 0
            while len(hits) <= self.max_hits:
                p = ref.find(rc, start)
                if p < 0:
                    break
                hits.append((c, p, 16))
                start = p + 1
        return hits

    def map_chunk(self, index: str, fq: str, out_sam: str) -> str:
        genome = self._genome_for(index)
        records = []
        for name, seq, qual in _read_fastq(fq):
            hits = self._hits(seq, genome) if seq else []
            if not hits:
                records.append(AlnRecord(name, 4, None, -1, 0, seq, qual))
            else:
                c, p, flag = hits[0]
                xs = 0 if len(hits) > 1 else None
                # SAM convention: stored SEQ/QUAL are alignment-oriented —
                # snps_match indexes rec.seq by reference offset, so a
                # flag-16 record must carry the reverse complement
                sq, ql = ((seq.translate(self._COMP)[::-1], qual[::-1])
                          if flag & 16 else (seq, qual))
                records.append(AlnRecord(name, flag, c, p, 42, sq, ql,
                                         tag_as=0, tag_xs=xs))
        records.sort(key=lambda r: r.query_name)
        write_sam(out_sam, records)
        return out_sam


# ---------------------------------------------------------------- driver
def _map_one(aligner, index: str, fq: str, out_sam: str) -> str:
    return aligner.map_chunk(index, fq, out_sam)


def _map_one_bam(aligner, index: str, fq: str, out_bam: str) -> str:
    """Map to name-sorted SAM, then store the chunk as BGZF BAM — the
    reference's workspace keeps ``.bam`` chunks (bamProcess.py:730); with
    ``--bam-format`` ours does too, so external tools (samtools, IGV)
    pointed at Global_bams/ReMap_bams find real BAMs."""
    from ..io.bam import sam_to_bam
    tmp_sam = out_bam[:-4] + ".tobam.tmp"
    aligner.map_chunk(index, fq, tmp_sam)
    tmp_bam = out_bam + ".tmp"
    sam_to_bam(tmp_sam, tmp_bam)
    os.replace(tmp_bam, out_bam)
    os.remove(tmp_sam)
    return out_bam


def ws_mapping(fastq_dir: str, out_dir: str, indexes: Sequence[str],
               aligner=None, threads: int = 16, jobs: int = 4,
               index_tags: Optional[Sequence[str]] = None,
               out_format: str = "sam") -> List[str]:
    """WS-mode mapping of every chunk against each index
    (mapping.py:94-187).  ``indexes`` has two entries (Maternal, Paternal)
    in allelic mode or one otherwise; output files carry the index tag.
    ``out_format="bam"`` stores chunks as BGZF BAM (the reference's
    workspace format, bamProcess.py:730); downstream stages read either."""
    if out_format not in ("sam", "bam"):
        raise ValueError(f"out_format must be 'sam' or 'bam', "
                         f"got {out_format!r}")
    os.makedirs(out_dir, exist_ok=True)
    if aligner is None:
        aligner = Bowtie2Aligner(threads=max(1, threads // jobs))
    chunks = sorted(f for f in os.listdir(fastq_dir)
                    if "chunk" in f and f.endswith(_FASTQ_SUFFIXES))
    if not chunks:
        raise FileNotFoundError(
            f"no chunk FASTQs ({'/'.join(_FASTQ_SUFFIXES)}) under "
            f"{fastq_dir} — run rebuildF first or check the directory")
    if index_tags is None:
        if len(indexes) == 2:
            index_tags = ("Maternal", "Paternal")
        else:
            index_tags = tuple(os.path.basename(str(i)) for i in indexes)

    map_fn = _map_one_bam if out_format == "bam" else _map_one
    tasks = []
    outs = []
    for f in chunks:
        fq = os.path.join(fastq_dir, f)
        stem = f.split(".")[0]
        for idx, tag in zip(indexes, index_tags):
            out_aln = os.path.join(out_dir, f"{stem}_{tag}.{out_format}")
            tasks.append(Task(map_fn, (aligner, idx, fq, out_aln), out_aln))
            outs.append(out_aln)
    RetryingExecutor(workers=jobs).run(tasks)
    log.log(21, "WS mapping: %d task(s) complete", len(tasks))
    return outs


def _rescue_jobs(rescue_dir: str, out_dir: str, index_by_tag):
    """(fq_path, out_sam, index, tag) for every ``*_<tag>_unmapped.fq`` —
    the one enumeration both rescue backends share."""
    jobs = []
    for f in sorted(os.listdir(rescue_dir)):
        if not f.endswith("_unmapped.fq"):
            continue
        stem = f.removesuffix("_unmapped.fq")
        tag = next((t for t in index_by_tag if t and t in f), "")
        jobs.append((os.path.join(rescue_dir, f),
                     os.path.join(out_dir, stem + ".sam"),
                     index_by_tag[tag], tag))
    return jobs


def ws_rescue_mapping(rescue_dir: str, out_dir: str,
                      index_by_tag: Dict[str, object],
                      aligner_by_tag: Optional[Dict[str, object]] = None,
                      aligner=None, jobs: int = 4,
                      out_format: str = "sam") -> List[str]:
    """Re-map rescue FASTQs, each against its own genome
    (mapping.py:644-712).  ``index_by_tag`` maps a filename tag (e.g.
    ``Maternal``/``Paternal``, or "" for non-allelic) to the index; rescue
    files are ``*_<tag>_unmapped.fq`` and emit ``*_<tag>.sam``."""
    if out_format not in ("sam", "bam"):
        raise ValueError(f"out_format must be 'sam' or 'bam', "
                         f"got {out_format!r}")
    os.makedirs(out_dir, exist_ok=True)
    map_fn = _map_one_bam if out_format == "bam" else _map_one
    tasks: List[Task] = []
    outs: List[str] = []
    for fq, out_sam, idx, tag in _rescue_jobs(rescue_dir, out_dir,
                                              index_by_tag):
        if out_format == "bam":
            out_sam = out_sam[:-4] + ".bam"
        al = (aligner_by_tag or {}).get(tag, aligner)
        if al is None:
            al = Bowtie2Aligner()
        tasks.append(Task(map_fn, (al, idx, fq, out_sam), out_sam))
        outs.append(out_sam)
    # Rescue outputs may legitimately be tiny (few unmapped reads):
    # validate existence only, but keep the same retry loop as global
    # mapping (a transient worker failure resubmits instead of aborting
    # the stage).
    RetryingExecutor(workers=jobs, min_bytes=0).run(tasks)
    log.log(21, "rescue mapping: %d file(s)", len(tasks))
    return outs


def pbs_rescue_mapping(rescue_dir: str, out_dir: str,
                       index_by_tag: Dict[str, str], cell: str,
                       bowtie2: str = "bowtie2", threads: int = 4,
                       num_task: int = 20, mem_gb: int = 10,
                       log_dir: Optional[str] = None,
                       qsub: str = "qsub", qstat: str = "qstat") -> List[str]:
    """PBS-submitted rescue re-mapping (mapping.py:790-970): each
    ``*_<tag>_unmapped.fq`` maps against its own genome, with the same
    throttle/validate/resubmit loop as global mapping."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = log_dir or out_dir
    ex = PBSExecutor(num_task=num_task, mem_gb=mem_gb, poll_s=0.5,
                     qsub=qsub, qstat=qstat)
    if not ex.available():
        raise RuntimeError("qsub not found; use WS mode")
    cmds = []
    for fq, out_sam, idx, _tag in _rescue_jobs(rescue_dir, out_dir,
                                               index_by_tag):
        cmds.append((f"{bowtie2} -x {idx} -p {threads} -U {fq} -S {out_sam}",
                     out_sam))
    ex.run_shell_tasks(cmds, cell, threads, log_dir)
    return [o for _, o in cmds]


def pbs_mapping(fastq_dir: str, out_dir: str, indexes: Sequence[str],
                cell: str, bowtie2: str = "bowtie2",
                threads: int = 4, num_task: int = 20, mem_gb: int = 10,
                log_dir: Optional[str] = None,
                index_tags: Optional[Sequence[str]] = None) -> List[str]:
    """PBS-mode mapping (mapping.py:421-603).  Requires qsub/qstat."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = log_dir or out_dir
    ex = PBSExecutor(num_task=num_task, mem_gb=mem_gb)
    if not ex.available():
        raise RuntimeError("qsub not found; use WS mode")
    if index_tags is None:
        index_tags = (("Maternal", "Paternal") if len(indexes) == 2
                      else tuple(os.path.basename(str(i)) for i in indexes))
    chunks = sorted(f for f in os.listdir(fastq_dir)
                    if "chunk" in f and f.endswith(_FASTQ_SUFFIXES))
    if not chunks:
        raise FileNotFoundError(
            f"no chunk FASTQs ({'/'.join(_FASTQ_SUFFIXES)}) under "
            f"{fastq_dir} — run rebuildF first or check the directory")
    cmds = []
    for f in chunks:
        fq = os.path.join(fastq_dir, f)
        stem = f.split(".")[0]
        for idx, tag in zip(indexes, index_tags):
            out_sam = os.path.join(out_dir, f"{stem}_{tag}.sam")
            cmd = f"{bowtie2} -x {idx} -p {threads} -U {fq} -S {out_sam}"
            cmds.append((cmd, out_sam))
    ex.run_shell_tasks(cmds, cell, threads, log_dir)
    return [o for _, o in cmds]
