"""Batched contact-matrix containers for device execution.

The reference keeps one dense numpy matrix per chromosome and loops over
chromosomes in Python (HiCHap/matrixBuilding.py:1026-1041).  Here we batch
chromosomes into a single padded tensor ``[C, N, N]`` (N = bucket size, a
multiple of 128) plus a per-chromosome ``n_bins``
vector, so corrections/balancing vmap over the chromosome axis and shard over
a device mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence

import numpy as np


def pad_to_bucket(n: int, bucket: int = 128) -> int:
    """Round up to a multiple of ``bucket``."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_to_shape(n: int, bucket: int = 128) -> int:
    """Round up to the compile-shape ladder: 256→2048 in powers of two, then
    ×1.5 steps (3072, 4608, 6912, 10368, …), each 128-aligned.

    Fine-grained padding (128/512 buckets) compiles a distinct executable
    per distinct padded size — ~20 shapes across hg19 chromosomes at 40 kb.
    Each distinct program costs a compile and an executable load.  The
    geometric ladder bounds distinct shapes to O(log N) per pipeline — 4 at
    40 kb, 2 at 500 kb — at ≤2.25× padded AREA waste.  ``HICHAP_SHAPE_LADDER=0`` restores plain
    bucket padding.
    """
    # read per call (not import-time) so flipping the env mid-process works,
    # matching _resolve_reduce's convention (review find); the getenv cost
    # is noise next to the compiles this function gates
    if os.environ.get("HICHAP_SHAPE_LADDER", "1") == "0":
        return pad_to_bucket(n, bucket)
    n = max(int(n), 1)
    p = 256
    while p < n and p < 2048:
        p *= 2
    while p < n:
        p = -(-p * 3 // 2)          # ceil ×1.5
        p = -(-p // bucket) * bucket  # keep lane alignment
    return p


def bucket_groups(labels: Sequence[str], n_bins: Mapping[str, int],
                  bucket: int = 512, ladder: bool = False):
    """Group chromosomes whose padded sizes coincide.

    Padding every chromosome to the genome-wide max wastes device memory
    quadratically
    (chr21 padded to chr1's size is ~30x larger than needed); grouping by
    rounded size keeps batches dense while bounding compile count to the
    number of distinct buckets.

    ``ladder=True`` groups by the geometric compile-shape ladder
    (``pad_to_shape``) instead of fixed buckets — use for groups that feed
    compiled device programs, where the number of DISTINCT shapes is the
    cost that matters; keep fixed buckets for host accumulators, where
    padded bytes are the cost.

    Returns a list of ``(group_labels, padded_size)`` tuples.
    """
    by_size: Dict[int, List[str]] = {}
    for c in labels:
        N = pad_to_shape(n_bins[c]) if ladder else pad_to_bucket(
            n_bins[c], bucket)
        by_size.setdefault(N, []).append(c)
    return [(v, k) for k, v in sorted(by_size.items())]


@dataclass
class ContactBatch:
    """Padded per-chromosome dense contact matrices.

    Attributes
    ----------
    labels : chromosome labels, order of the batch axis.
    data   : float array ``[C, N, N]``; rows/cols >= n_bins[i] are zero.
    n_bins : int array ``[C]`` of true matrix sizes.
    """

    labels: List[str]
    data: np.ndarray
    n_bins: np.ndarray

    @classmethod
    def from_dict(cls, matrices: Mapping[str, np.ndarray],
                  labels: Sequence[str] | None = None,
                  bucket: int = 128,
                  dtype=np.float32) -> "ContactBatch":
        labels = list(labels) if labels is not None else list(matrices.keys())
        for c in labels:
            sh = matrices[c].shape
            if len(sh) != 2 or sh[0] != sh[1]:
                raise ValueError(
                    f"ContactBatch needs square matrices; {c!r} is {sh}")
        sizes = [matrices[c].shape[0] for c in labels]
        N = pad_to_bucket(max(sizes), bucket)
        data = np.zeros((len(labels), N, N), dtype=dtype)
        for i, c in enumerate(labels):
            m = matrices[c]
            data[i, : m.shape[0], : m.shape[1]] = m
        return cls(labels, data, np.asarray(sizes, dtype=np.int32))

    def to_dict(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, c in enumerate(self.labels):
            n = int(self.n_bins[i])
            out[c] = np.asarray(self.data[i, :n, :n])
        return out

    def __len__(self):
        return len(self.labels)

    @property
    def padded_size(self) -> int:
        return self.data.shape[-1]
