"""hichap_master_tpu — a JAX diploid Hi-C analysis framework for one GPU.

A ground-up rebuild of the capabilities of HiCHap (Prayforhanluo/HiCHap_master):
haplotype-resolved and traditional Hi-C processing — genome rebuild from phased
SNPs, read chunking / junction rescue / mapping orchestration, BAM integration
with fragment assignment and per-read SNP matching, Hi-C noise filtering and
allelic assignment, multi-resolution contact matrices with inter-chromosomal
imputation and two-step bias correction, cooler-compatible persistence, and
structure analysis (compartments / TADs / loops) with allelic-specificity tests.

Unlike the reference (a Python-2 pipeline of per-line loops and dense numpy),
the numerical core here runs on an accelerator: batched padded contact tensors,
jitted balancing iterations, scan-based HMMs, stencil loop statistics, and
pjit/shard_map sharding of the chromosome batch over a device mesh.
"""

__version__ = "0.1.0"
