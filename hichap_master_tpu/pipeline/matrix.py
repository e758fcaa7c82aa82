"""Contact-matrix construction: traditional and haplotype-resolved.

Drivers with the same outputs as the reference's
``TraditionalMatrixConstruction`` (HiCHap/matrixBuilding.py:617-717) and
``HaplotypeMatrixConstruction`` (matrixBuilding.py:1641-1861):

  * ``<prefix>Multi.cool`` / ``Merged_Multi.cool`` — traditional counts,
    ICE-balanced (weights stored like ``cooler balance --ignore-diags 1``,
    cis-only for intra-chromosome resolutions);
  * ``<prefix>Traditional_Multi.cool`` — traditional counts built from the
    five allelic bed classes;
  * ``<prefix>UnImputated_Haplotype_Multi.cool`` — both-side haplotype counts;
  * ``<prefix>Imputated_Haplotype_Multi.cool`` — imputed + two-step-corrected
    float matrices (no balance weights: counts already corrected);
  * ``<prefix>Imputated_Gap.npz`` — per-resolution gap-bin arrays;
  * ``Merged_*`` variants summing replicates before correction.

All binning and correction runs on-device; the host only parses beds and
moves finished matrices to HDF5.  Bugs fixed vs the reference (see
DIVERGENCES.md): the P_P inter-imputation stale-neighborhood branch, the R2
crossed chromosome offsets, and the single-replicate missing-kwarg crash
(matrixBuilding.py:1676-1683).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.contacts import bucket_groups, pad_to_shape
from ..core.genome import Genome
from ..io.bedio import (
    TAG_BOTH,
    TAG_R1,
    bed_prefix,
    discover_allelic_beds,
    iter_allelic_bed,
    iter_valid_bed,
)
from ..io.cooler import CoolerReader, write_cooler
from ..io.native import gw_accumulator
from ..ops.balance import ice_balance
from ..ops.binning import (
    bin_genomewide,
    bin_genomewide_bins,
    bin_genomewide_single_triangle_bins,
    bin_intra,
    bin_intra_single_side,
    pad_chunk,
    stream_chunks,
)
from ..ops.correct import (
    genomewide_alpha,
    genomewide_alpha_margins,
    genomewide_correction,
    two_step_correction,
)
from ..ops.imputation import disk_offsets, impute_inter_chunk
from ..ops.sparse_impute import (SparseU, disk_row_intervals,
                                 sparse_impute_vote_rowptr)
from ..utils.logging import get_logger
from ..utils.profiling import add as profiling_add, stage

log = get_logger(__name__)

CHUNK = 1 << 19

# Above this genome-wide bin count the dense [S, S] form stops being
# reasonable (at 65,536 bins it is already 16 GB f32 — one full chip) and
# the pipeline switches to the block-sparse layout (ops/sparse.py).  This
# is what makes true genome-wide 10 kb matrices (hg19 ≈ 304k bins, ~343 GB
# dense) constructible: memory is O(nnz), the size of the output cooler.
DENSE_GW_MAX_BINS = int(os.environ.get("HICHAP_DENSE_GW_MAX_BINS", "65536"))


def _rle_sorted(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique keys + run lengths of an already-sorted key array."""
    if keys.size == 0:
        return keys, np.zeros(0, np.float64)
    starts = np.r_[0, np.flatnonzero(np.diff(keys)) + 1]
    runs = np.diff(np.r_[starts, keys.size]).astype(np.float64)
    return keys[starts], runs


def _merge_sorted_counts(keys, cnts, nk, nc):
    """Merge (nk, nc) into the sorted unique (keys, cnts) accumulator.

    ``nk`` must be sorted-unique.  Matched keys add in place; the rest
    insert by vectorized copy.  This replaces re-running np.unique over
    the whole accumulation (a full argsort of O(total) keys per compaction
    — measured 204 s of the 50M-pair e2e stream at 10 kb, vs sorting only
    the 16M-key pending block and merging in O(n))."""
    if keys.size == 0:
        # copies, NOT views: __add__ with an empty left side would
        # otherwise alias the right accumulator's arrays, and a later
        # in-place "+=" merge on the sum silently corrupts it
        return nk.copy(), nc.copy()
    idx = np.searchsorted(keys, nk)
    inb = np.minimum(idx, keys.size - 1)
    match = keys[inb] == nk
    # nk is unique, so matched target positions are distinct: fancy += safe
    cnts[idx[match]] += nc[match]
    if match.all():
        return keys, cnts
    ins_k, ins_c, pos = nk[~match], nc[~match], idx[~match]
    out_k = np.empty(keys.size + ins_k.size, keys.dtype)
    out_c = np.empty(out_k.size, np.float64)
    tgt = pos + np.arange(ins_k.size)
    keep = np.ones(out_k.size, bool)
    keep[tgt] = False
    out_k[keep] = keys
    out_c[keep] = cnts
    out_k[tgt] = ins_k
    out_c[tgt] = ins_c
    return out_k, out_c


class SparseGW:
    """Genome-wide contact accumulator in upper-triangle COO key space.

    Host memory stays O(unique pixels) — the same order as the cooler
    this will be written to.  Two backends, identical outputs:

    * native (default when ``libhicio.so`` builds): an open-addressing
      C++ hash (io/native.gw_accumulator) — O(1) per occurrence, one
      sort of the unique survivors at ``coo()``;
    * numpy fallback (``HICHAP_NATIVE_GWACC=0`` or no compiler):
      ``self.keys`` maintained sorted-unique; each compaction sorts ONLY
      the pending block and searchsorted-merges it in.

    Matches ``bin_genomewide`` semantics (symmetric count; diagonal
    counted once; out-of-bounds bins dropped like XLA scatter)."""

    def __init__(self, S: int, compact_every: int = 1 << 24):
        self.S = S
        self._nat = gw_accumulator()
        self._intra_margins = None
        self.keys = np.zeros(0, np.int64)
        self.cnts = np.zeros(0, np.float64)
        self._pend: List[np.ndarray] = []
        self._pend_n = 0
        self._compact_every = compact_every

    def add(self, b1: np.ndarray, b2: np.ndarray) -> None:
        # XLA drops out-of-bounds scatter updates in the dense path;
        # mirror that (a >=S bin would otherwise crash the cooler writer)
        ok = (b1 >= 0) & (b1 < self.S) & (b2 >= 0) & (b2 < self.S)
        b1, b2 = b1[ok], b2[ok]
        lo = np.minimum(b1, b2).astype(np.int64)
        hi = np.maximum(b1, b2).astype(np.int64)
        keys = lo * self.S + hi
        self._intra_margins = None
        if self._nat is not None:
            self._nat.add(keys)
            return
        self._pend.append(keys)
        self._pend_n += lo.size
        if self._pend_n >= self._compact_every:
            self._compact()

    def _compact(self) -> None:
        if not self._pend:
            return
        nk, nc = _rle_sorted(np.sort(np.concatenate(self._pend)))
        self.keys, self.cnts = _merge_sorted_counts(
            self.keys, self.cnts, nk, nc)
        self._pend, self._pend_n = [], 0

    def _items(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted-unique (keys, counts) snapshot (non-destructive)."""
        if self._nat is not None:
            return self._nat.export()
        self._compact()
        return self.keys, self.cnts

    def coo(self):
        if self._nat is not None:
            return self._nat.export_coo(self.S)
        keys, cnts = self._items()
        return keys // self.S, keys % self.S, cnts

    def __add__(self, other):
        if not isinstance(other, SparseGW):  # sum() starts from 0
            if other == 0:
                return self
            return NotImplemented
        assert self.S == other.S
        out = SparseGW(self.S)
        k1, c1 = self._items()
        k2, c2 = other._items()
        if out._nat is not None:
            out._nat.add(k1, c1)
            out._nat.add(k2, c2)
        else:
            out.keys, out.cnts = _merge_sorted_counts(
                k1.copy(), c1.copy(), k2, c2)
        return out

    __radd__ = __add__


class SparseDirectedGW:
    """Directed genome-wide COO accumulator (general (row, col) increments).

    The haplotype Imputated matrix is *asymmetric*: single-side intra
    contacts and inter disk-vote winners land at their literal (row, col)
    (one triangle each, matrixBuilding.py:1295-1301); the symmetric
    UnImputated base folds in via ``add_symmetric``.  Same two backends
    as ``SparseGW`` (native hash / numpy merge-compaction) — host memory
    stays O(unique pixels)."""

    def __init__(self, S: int, compact_every: int = 1 << 24):
        self.S = S
        self._nat = gw_accumulator()
        self._intra_margins = None
        self.keys = np.zeros(0, np.int64)
        self.cnts = np.zeros(0, np.float64)
        self._pend: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._compact_every = compact_every

    def add_directed(self, r: np.ndarray, c: np.ndarray,
                     w: np.ndarray | None = None) -> None:
        # mirror XLA's drop of out-of-bounds scatter updates (dense parity)
        r = np.asarray(r, np.int64)
        c = np.asarray(c, np.int64)
        ok = (r >= 0) & (r < self.S) & (c >= 0) & (c < self.S)
        r, c = r[ok], c[ok]
        keys = r * self.S + c
        self._intra_margins = None
        w = np.ones(r.size) if w is None else np.asarray(w, np.float64)[ok]
        if self._nat is not None:
            self._nat.add(keys, w)
            return
        self._pend.append((keys, w))
        self._pend_n += r.size
        if self._pend_n >= self._compact_every:
            self._compact()

    def add_symmetric(self, rows, cols, vals) -> None:
        """Fold an upper-triangle symmetric COO in (both orientations,
        diagonal once)."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        off = rows != cols
        self._intra_margins = None
        if self._nat is not None:
            self._nat.add(rows * self.S + cols, vals)
            self._nat.add(cols[off] * self.S + rows[off], vals[off])
            return
        self._pend.append((rows * self.S + cols, vals))
        self._pend.append((cols[off] * self.S + rows[off], vals[off]))
        self._pend_n += rows.size + int(off.sum())
        if self._pend_n >= self._compact_every:
            self._compact()

    def _compact(self) -> None:
        if not self._pend:
            return
        pk = np.concatenate([k for k, _ in self._pend])
        pw = np.concatenate([w for _, w in self._pend])
        order = np.argsort(pk)  # weighted: sort must carry the weights
        sk = pk[order]
        starts = (np.r_[0, np.flatnonzero(np.diff(sk)) + 1]
                  if sk.size else np.zeros(0, np.intp))
        nk = sk[starts]
        nc = np.add.reduceat(pw[order], starts) if sk.size else pw
        self.keys, self.cnts = _merge_sorted_counts(
            self.keys, self.cnts, nk, nc)
        self._pend, self._pend_n = [], 0

    def _items(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted-unique (keys, counts) snapshot (non-destructive)."""
        if self._nat is not None:
            return self._nat.export()
        self._compact()
        return self.keys, self.cnts

    def coo(self):
        if self._nat is not None:
            return self._nat.export_coo(self.S)
        keys, cnts = self._items()
        return keys // self.S, keys % self.S, cnts

    def sum(self) -> float:
        if self._nat is not None:
            return self._nat.total()
        self._compact()
        return float(self.cnts.sum())

    def __add__(self, other):
        if not isinstance(other, SparseDirectedGW):
            if other == 0:  # sum() starts from 0
                return self
            return NotImplemented
        assert self.S == other.S
        out = SparseDirectedGW(self.S)
        k1, c1 = self._items()
        k2, c2 = other._items()
        if out._nat is not None:
            out._nat.add(k1, c1)
            out._nat.add(k2, c2)
        else:
            out.keys, out.cnts = _merge_sorted_counts(
                k1.copy(), c1.copy(), k2, c2)
        return out

    __radd__ = __add__


def _gw_is_sparse(genome: Genome, res: int) -> bool:
    return genome.total_bins(res) > DENSE_GW_MAX_BINS


# --------------------------------------------------------------- binning
def _offsets_array(genome: Genome, res: int) -> np.ndarray:
    offs = genome.bin_offsets(res)
    return np.asarray([offs[c][0] for c in genome.labels], dtype=np.int64)


# Host-bincount binning policy: np.bincount over flattened bin pairs runs
# O(cells), a device scatter-add O(contacts).  The host path wins only
# when the target is DENSE relative to the contact count — the crossover
# (cells per contact) was set on the first accelerator and is not
# measured on the H100 — and must also fit host memory.
# HICHAP_HOST_BINCOUNT=0 forces the device scatter path.
_HOST_BINCOUNT_CELLS = 1 << 28
_HOST_BINCOUNT_CELLS_PER_CONTACT = 8


def _host_bincount_ok(cells: int, contacts: int) -> bool:
    return (os.environ.get("HICHAP_HOST_BINCOUNT", "1") != "0"
            and cells <= _HOST_BINCOUNT_CELLS
            and cells <= _HOST_BINCOUNT_CELLS_PER_CONTACT * max(contacts, 1))


def _sym_from_counts(C: np.ndarray) -> np.ndarray:
    """Symmetric matrix from directed counts, diagonal counted once
    (matrixBuilding.py:588-592 semantics)."""
    M = (C + np.swapaxes(C, -1, -2)).astype(np.float32)
    d = np.arange(C.shape[-1])
    M[..., d, d] -= C[..., d, d]
    return M


def accumulate_genomewide(c1, p1, c2, p2, genome: Genome, res: int,
                          acc: np.ndarray | None = None) -> np.ndarray:
    S = genome.total_bins(res)
    if _host_bincount_ok(S * S, len(c1)):
        offs = _offsets_array(genome, res)
        b1 = p1 // res + offs[c1]
        b2 = p2 // res + offs[c2]
        # XLA drops out-of-bounds scatter updates; mirror that here
        ok = (b1 >= 0) & (b1 < S) & (b2 >= 0) & (b2 < S)
        C = np.bincount(b1[ok].astype(np.int64) * S + b2[ok],
                        minlength=S * S).reshape(S, S)
        M = _sym_from_counts(C)
        return M if acc is None else np.asarray(acc) + M
    offsets = jnp.asarray(_offsets_array(genome, res))
    dev = jnp.zeros((S, S), jnp.float32) if acc is None else jnp.asarray(acc)
    for (cc1, pp1, cc2, pp2), valid in stream_chunks([c1, p1, c2, p2], CHUNK):
        dev = bin_genomewide(dev, jnp.asarray(cc1), jnp.asarray(pp1),
                             jnp.asarray(cc2), jnp.asarray(pp2), offsets,
                             jnp.asarray(valid), res)
    return np.asarray(dev)


def accumulate_intra(c1, p1, c2, p2, genome: Genome, res: int,
                     init: Mapping[str, np.ndarray] | None = None,
                     tags=None) -> Dict[str, np.ndarray]:
    """Per-chromosome intra matrices, bucketed by padded size.

    With ``tags`` given (R1/R2 int codes), contacts accumulate into a single
    triangle per the single-side rule; otherwise symmetric increments.
    """
    nb = {c: genome.n_bins(c, res) for c in genome.labels}
    out: Dict[str, np.ndarray] = {}
    label_idx = {c: i for i, c in enumerate(genome.labels)}
    intra_sel = c1 == c2
    for group, N in bucket_groups(genome.labels, nb):
        gpos = np.full(len(genome.labels), -1, np.int32)
        for gi, c in enumerate(group):
            gpos[label_idx[c]] = gi
        sel = intra_sel & (gpos[c1] >= 0)
        gc = gpos[c1[sel]]
        gp1 = p1[sel]
        gp2 = p2[sel]
        cells = len(group) * N * N
        if tags is None and _host_bincount_ok(cells, int(sel.sum())):
            b1 = gp1 // res
            b2 = gp2 // res
            # XLA drops out-of-bounds scatter updates; mirror that here
            ok = (b1 >= 0) & (b1 < N) & (b2 >= 0) & (b2 < N)
            gci, b1, b2 = gc[ok], b1[ok], b2[ok]
            C = np.bincount((gci.astype(np.int64) * N + b1) * N + b2,
                            minlength=cells).reshape(len(group), N, N)
            M = _sym_from_counts(C)
            for gi, c in enumerate(group):
                m = M[gi, : nb[c], : nb[c]]
                prev = init.get(c) if init is not None else None
                if prev is not None:
                    m = m.copy()
                    m[: prev.shape[0], : prev.shape[1]] += prev
                out[c] = m
            continue
        dev = jnp.zeros((len(group), N, N), jnp.float32)
        if init is not None:
            base = np.zeros((len(group), N, N), np.float32)
            for gi, c in enumerate(group):
                m = init.get(c)
                if m is not None:
                    base[gi, : m.shape[0], : m.shape[1]] = m
            dev = jnp.asarray(base)
        if tags is None:
            for (a, b, d), valid in stream_chunks([gc, gp1, gp2], CHUNK):
                dev = bin_intra(dev, jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(a), jnp.asarray(d),
                                jnp.asarray(valid), res)
        else:
            gt = tags[sel]
            for (a, b, d, t), valid in stream_chunks([gc, gp1, gp2, gt], CHUNK):
                dev = bin_intra_single_side(
                    dev, jnp.asarray(a), jnp.asarray(b), jnp.asarray(a),
                    jnp.asarray(d), jnp.asarray(t == TAG_R1),
                    jnp.asarray(valid), res)
        host = np.asarray(dev)
        for gi, c in enumerate(group):
            out[c] = host[gi, : nb[c], : nb[c]]
    return out


class _ChunkBuffer:
    """Buffers columnar rows and emits fixed-size padded chunks.

    The jitted binning kernels compile once per (chunk, dtype) shape;
    padding every small streamed slice to ``chunk`` wastes scatter work,
    so rows accumulate here until a full chunk exists (padding waste is
    bounded by one chunk per *stream*, not per producer call)."""

    def __init__(self, ncols: int, emit, chunk: int = CHUNK):
        self._cols: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        self._n = 0
        self._emit = emit
        self._chunk = chunk

    def add(self, *cols) -> None:
        n = len(cols[0])
        if n == 0:
            return
        for acc, a in zip(self._cols, cols):
            acc.append(np.asarray(a))
        self._n += n
        if self._n >= self._chunk:
            self._drain(keep_tail=True)

    def _drain(self, keep_tail: bool) -> None:
        cols = [c[0] if len(c) == 1 else np.concatenate(c)
                for c in self._cols]
        stop = (self._n // self._chunk) * self._chunk if keep_tail else self._n
        for s in range(0, stop, self._chunk):
            sl = [a[s : s + self._chunk] for a in cols]
            padded, valid = pad_chunk(sl, self._chunk)
            self._emit(padded, valid)
        self._cols = [[a[stop:]] for a in cols]
        self._n -= stop

    def close(self) -> None:
        if self._n:
            self._drain(keep_tail=False)
        self._cols = [[] for _ in self._cols]
        self._n = 0


class _GWAcc:
    """Streaming genome-wide accumulator with three storage regimes.

    * ``sparse`` — COO key space (``SparseGW`` / ``SparseDirectedGW``) past
      ``DENSE_GW_MAX_BINS``: O(nnz) host memory, the layout the cooler is
      written in;
    * ``host`` — dense [S, S] f32 with periodic np.bincount flushes (wins
      for small, dense targets).  Streaming means the contact count is
      unknown up front, so unlike ``_host_bincount_ok`` (which sees the
      whole array) this gates on the grid size alone — a short stream
      into a near-cap grid pays one oversized bincount flush, which is
      bounded by ``_HOST_BINCOUNT_CELLS`` (~1 GB f32 + a 2 GB int64
      temp) and still beats per-chunk device scatters over a slow link;
    * ``dev`` — device [S, S] f32 with chunked XLA scatter-adds
      (``HICHAP_HOST_BINCOUNT=0``).

    ``add_sym`` is the symmetric diagonal-once rule (matrixBuilding.py:
    588-592); ``add_directed`` the literal single-triangle rule of the
    haplotype single-side/imputation increments (matrixBuilding.py:
    1295-1301)."""

    def __init__(self, S: int, sparse: bool, directed: bool = False):
        self.S = S
        if sparse:
            self.mode = "sparse"
            self.acc: SparseGW | SparseDirectedGW = (
                SparseDirectedGW(S) if directed else SparseGW(S))
        elif (os.environ.get("HICHAP_HOST_BINCOUNT", "1") != "0"
              and S * S <= _HOST_BINCOUNT_CELLS):
            self.mode = "host"
            self.host = np.zeros(S * S, np.float32)
            self._pend: List[np.ndarray] = []
            self._pend_n = 0
        else:
            self.mode = "dev"
            self.dev = jnp.zeros((S, S), jnp.float32)
            self._sym_buf = _ChunkBuffer(2, self._emit_sym)
            self._dir_buf = _ChunkBuffer(2, self._emit_dir)

    # -- device emitters ---------------------------------------------------
    def _emit_sym(self, padded, valid) -> None:
        b1, b2 = padded
        self.dev = bin_genomewide_bins(self.dev, jnp.asarray(b1),
                                       jnp.asarray(b2), jnp.asarray(valid))

    def _emit_dir(self, padded, valid) -> None:
        r, c = padded
        self.dev = bin_genomewide_single_triangle_bins(
            self.dev, jnp.asarray(r), jnp.asarray(c), jnp.asarray(valid))

    # -- host key push -----------------------------------------------------
    def _push(self, keys: np.ndarray) -> None:
        self._pend.append(keys)
        self._pend_n += keys.size
        if self._pend_n >= 1 << 24:
            self._host_flush()

    def _host_flush(self) -> None:
        if not self._pend:
            return
        keys = np.concatenate(self._pend)
        self.host += np.bincount(keys, minlength=self.S * self.S)
        self._pend, self._pend_n = [], 0

    def _inb(self, b1, b2):
        b1 = np.asarray(b1, np.int64)
        b2 = np.asarray(b2, np.int64)
        ok = (b1 >= 0) & (b1 < self.S) & (b2 >= 0) & (b2 < self.S)
        return b1[ok], b2[ok]

    # -- producers ---------------------------------------------------------
    def add_sym(self, b1: np.ndarray, b2: np.ndarray) -> None:
        if self.mode == "sparse":
            self.acc.add(b1, b2)
        elif self.mode == "host":
            b1, b2 = self._inb(b1, b2)
            off = b1 != b2
            self._push(b1 * self.S + b2)
            self._push(b2[off] * self.S + b1[off])
        else:
            self._sym_buf.add(b1, b2)

    def add_directed(self, r: np.ndarray, c: np.ndarray) -> None:
        if self.mode == "sparse":
            self.acc.add_directed(r, c)
        elif self.mode == "host":
            r, c = self._inb(r, c)
            self._push(r * self.S + c)
        else:
            self._dir_buf.add(r, c)

    def finish(self):
        """→ np.ndarray [S, S] (dense modes) or the sparse accumulator."""
        if self.mode == "sparse":
            return self.acc
        if self.mode == "host":
            self._host_flush()
            return self.host.reshape(self.S, self.S)
        self._sym_buf.close()
        self._dir_buf.close()
        return np.asarray(self.dev)


class _IntraAcc:
    """Streaming per-chromosome intra accumulator with the same outputs as
    ``accumulate_intra`` ([G, N, N] buckets per padded-size group).

    Two backends:

    * ``host`` (default) — group-cell keys (group offset + g*N*N + r*N + c)
      into the native hash accumulator (numpy bincount-flush fallback),
      densified once at ``finish``.  Streaming ingestion is host work;
      keeping it off the device avoids shipping every chunk up AND the
      [G, N, N] buckets back down (~2 GB of round-trip for a 50M-pair
      run).
    * ``device`` (``HICHAP_HOST_INTRA=0``) — chunked XLA scatter-adds into
      device buckets (wins only when the host→device link is fast and the
      stream is long enough to hide transfers).

    Both drop out-of-bounds bins the way XLA scatter does, so outputs are
    identical."""

    def __init__(self, genome: Genome, res: int, single_side: bool = False):
        self.res = res
        self.single = single_side
        self.nb = {c: genome.n_bins(c, res) for c in genome.labels}
        self.groups = bucket_groups(genome.labels, self.nb)
        label_idx = {c: i for i, c in enumerate(genome.labels)}
        self.gpos: List[np.ndarray] = []
        for group, _N in self.groups:
            pos = np.full(len(genome.labels), -1, np.int32)
            for k, c in enumerate(group):
                pos[label_idx[c]] = k
            self.gpos.append(pos)
        self.host_mode = os.environ.get("HICHAP_HOST_INTRA", "1") != "0"
        if self.host_mode:
            cells = [len(group) * N * N for group, N in self.groups]
            self._cell_off = np.concatenate(
                [[0], np.cumsum(cells)]).astype(np.int64)
            # every chromosome lives in exactly one (group, slot): flat
            # per-label base offset and padded width let add() build keys
            # in ONE vectorized pass instead of a per-group mask loop
            self._base = np.full(len(genome.labels), -1, np.int64)
            self._width = np.ones(len(genome.labels), np.int64)
            for gi, (group, N) in enumerate(self.groups):
                for k, c in enumerate(group):
                    li = label_idx[c]
                    self._base[li] = self._cell_off[gi] + k * (N * N)
                    self._width[li] = N
            self._acc = gw_accumulator()
            self._flat: np.ndarray | None = None
            self._flat_done: np.ndarray | None = None
            self._pend: List[np.ndarray] = []
            self._pend_n = 0
            return
        self.dev: List[jnp.ndarray] = []
        self.bufs: List[_ChunkBuffer] = []
        for group, N in self.groups:
            self.dev.append(jnp.zeros((len(group), N, N), jnp.float32))
            gi = len(self.dev) - 1
            self.bufs.append(_ChunkBuffer(4 if single_side else 3,
                                          self._make_emit(gi)))

    def _make_emit(self, gi: int):
        def emit(padded, valid):
            vj = jnp.asarray(valid)
            if self.single:
                a, b, d, t = padded
                self.dev[gi] = bin_intra_single_side(
                    self.dev[gi], jnp.asarray(a), jnp.asarray(b),
                    jnp.asarray(a), jnp.asarray(d),
                    jnp.asarray(t == TAG_R1), vj, self.res)
            else:
                a, b, d = padded
                self.dev[gi] = bin_intra(
                    self.dev[gi], jnp.asarray(a), jnp.asarray(b),
                    jnp.asarray(a), jnp.asarray(d), vj, self.res)
        return emit

    # ------------------------------------------------------- host backend
    # Deliberately NOT the same policy as _GWAcc's host mode: that one
    # serves small DENSE genome-wide targets where plain bincount into
    # the eager [S*S] array beats hashing every occurrence (measured r2
    # policy); group-cell space here is large and sparse-ish, so the
    # native hash wins and bincount is only the no-compiler fallback.
    def _push(self, keys: np.ndarray) -> None:
        if self._acc is not None:
            self._acc.add(keys)
            return
        self._pend.append(keys)
        self._pend_n += keys.size
        if self._pend_n >= 1 << 26:
            self._host_flush()

    def _host_flush(self) -> None:
        if not self._pend:
            return
        keys = np.concatenate(self._pend)
        if self._flat is None:
            self._flat = np.zeros(int(self._cell_off[-1]), np.float32)
        self._flat += np.bincount(keys, minlength=self._flat.size)
        self._pend, self._pend_n = [], 0

    def add(self, c1, p1, c2, p2, tags=None) -> None:
        intra = c1 == c2
        if self.host_mode:
            self._flat_done = None
            a = (np.asarray(p1)[intra] // self.res).astype(np.int64)
            b = (np.asarray(p2)[intra] // self.res).astype(np.int64)
            ci = np.asarray(c1)[intra]
            width = self._width[ci]
            # XLA scatter drops out-of-bounds updates; mirror it
            ok = (a >= 0) & (a < width) & (b >= 0) & (b < width)
            a, b, ci, width = a[ok], b[ok], ci[ok], width[ok]
            base = self._base[ci]
            if self.single:
                r1 = tags[intra][ok] == TAG_R1
                r = np.where(r1, a, b)
                c = np.where(r1, b, a)
                self._push(base + r * width + c)
            else:
                self._push(base + a * width + b)
                off = a != b
                self._push(base[off] + b[off] * width[off] + a[off])
            return
        for gi in range(len(self.groups)):
            pos = self.gpos[gi]
            sel = intra & (pos[c1] >= 0)
            if not sel.any():
                continue
            cols = [pos[c1[sel]], p1[sel], p2[sel]]
            if self.single:
                cols.append(tags[sel])
            self.bufs[gi].add(*cols)

    def _finish_flat(self) -> np.ndarray:
        """The concatenated group-cell array (host mode only; memoized —
        finish() and finish_plus() may both need it)."""
        if self._flat_done is not None:
            return self._flat_done
        if self._acc is not None:
            keys, cnts = self._acc.export()
            flat = np.zeros(int(self._cell_off[-1]), np.float32)
            flat[keys] = cnts  # keys unique: assignment fill
        else:
            self._host_flush()
            flat = (self._flat if self._flat is not None
                    else np.zeros(int(self._cell_off[-1]), np.float32))
        self._flat_done = flat
        return flat

    def _views(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for gi, (group, N) in enumerate(self.groups):
            blk = flat[self._cell_off[gi]:self._cell_off[gi + 1]]
            host = blk.reshape(len(group), N, N)
            for k, c in enumerate(group):
                n = self.nb[c]
                out[c] = host[k, :n, :n]
        return out

    def finish(self) -> Dict[str, np.ndarray]:
        if self.host_mode:
            return self._views(self._finish_flat())
        out: Dict[str, np.ndarray] = {}
        for gi, (group, _N) in enumerate(self.groups):
            self.bufs[gi].close()
            host = np.asarray(self.dev[gi])
            for k, c in enumerate(group):
                n = self.nb[c]
                out[c] = host[k, :n, :n]
        return out

    def finish_plus(self, other: "_IntraAcc") -> Dict[str, np.ndarray]:
        """Per-chromosome views of (self + other) — one contiguous flat
        add when both are host-mode (the per-chromosome ``m + delta``
        adds walked ~2x 194M strided elements per haplotype side)."""
        if self.host_mode and other.host_mode:
            return self._views(self._finish_flat() + other._finish_flat())
        a, b = self.finish(), other.finish()
        return {c: a[c] + b[c] for c in a}


def build_traditional_stream(files: Sequence[str], genome: Genome,
                             whole_res: Sequence[int],
                             local_res: Sequence[int]):
    """Single streaming pass over the valid beds updating every resolution's
    accumulators per chunk (no full-file load; reference holds all matrices
    in RAM the same way, matrixBuilding.py:549-565).

    Uses the buffered accumulators (``_GWAcc``/``_IntraAcc``): small per-
    block group slices coalesce into full device chunks instead of padding
    each one to CHUNK, and small dense genome-wide targets accumulate by
    host bincount with zero device traffic."""
    offs = {res: _offsets_array(genome, res) for res in whole_res}
    twhole = {res: _GWAcc(genome.total_bins(res), _gw_is_sparse(genome, res))
              for res in whole_res}
    tlocal = {res: _IntraAcc(genome, res) for res in local_res}

    total = 0
    for c1, p1, c2, p2 in iter_valid_bed(files, genome):
        total += len(c1)
        for res in whole_res:
            o = offs[res]
            twhole[res].add_sym(p1 // res + o[c1], p2 // res + o[c2])
        for res in local_res:
            tlocal[res].add(c1, p1, c2, p2)

    whole: Dict[int, np.ndarray | SparseGW] = {
        res: acc.finish() for res, acc in twhole.items()}
    local = {res: tlocal[res].finish() for res in local_res}
    return whole, local, total


# ------------------------------------------------------------ balancing
def _write_weights(path: str, genome: Genome, res: int, cis_only: bool) -> None:
    """ICE-balance a written cooler group in place (``cooler balance`` parity:
    --ignore-diags 1, and --cis-only for intra-chromosome resolutions)."""
    with stage(f"matrix.ice.{res}.{'cis' if cis_only else 'gw'}"):
        _write_weights_inner(path, genome, res, cis_only)


def _write_weights_inner(path: str, genome: Genome, res: int,
                         cis_only: bool) -> None:
    r = CoolerReader(path, res)
    if cis_only:
        from ..ops.balance import ice_balance_batch

        # bucket chromosomes by padded size and balance each bucket in ONE
        # vmapped dispatch: per-chromosome ice_balance compiled a fresh
        # executable per distinct [P, P] shape (~20 shapes for hg19); the
        # 512-bucketed batch shapes match the
        # rest of the suite, so they're usually already cached.
        nb = {c: int(r.chrom_offset[i + 1] - r.chrom_offset[i])
              for i, c in enumerate(r.chromnames)}
        per_label = {}
        # ladder grouping: these buckets feed compiled balance programs,
        # and per-program compile+load dwarfs the padded-FLOP waste
        for group, N in bucket_groups(r.chromnames, nb, ladder=True):
            # bound the batch's device footprint; split oversized buckets
            max_g = max(1, (1 << 32) // (8 * N * N))
            for s in range(0, len(group), max_g):
                sub = group[s : s + max_g]
                ms, ns = [], []
                for c in sub:
                    Mj, n = r.matrix_device(c, padded=N)
                    ms.append(Mj)
                    ns.append(n)
                wb, _ = ice_balance_batch(jnp.stack(ms),
                                          jnp.asarray(ns, jnp.int32))
                wb = np.asarray(wb)
                for gi, c in enumerate(sub):
                    per_label[c] = wb[gi, : ns[gi]]
        weights = np.concatenate([per_label[c] for c in r.chromnames])
    elif genome.total_bins(res) > DENSE_GW_MAX_BINS:
        # hybrid genome-wide balance (the dense [S, S] form would be
        # hundreds of GB at 10 kb): banded mass stays in dense tiles,
        # scattered inter-chromosomal pixels in sorted COO with a
        # prefix-sum marginal — O(nnz) memory for REAL data, where the
        # pure tile layout would touch ~every off-band tile
        from ..ops.sparse_hybrid import hybrid_from_coo, ice_balance_hybrid

        with stage(f"matrix.ice.{res}.gw.fetch"):
            b1, b2, v = r.pixels_coo()
            # raw integer counts ride the wire as uint16 (hybrid_from_coo
            # detects the range); cast to f32 happens on device.  Cooler
            # pixels are unique (i, j) pairs, so tile fill is assignment,
            # not accumulation — cuts the 1-core host build ~25x at 30M px.
            h = hybrid_from_coo(b1, b2, v, r.nbins, assume_unique=True)
        with stage(f"matrix.ice.{res}.gw.balance"):
            w, _ = ice_balance_hybrid(h)
            weights = np.asarray(w)[: r.nbins]
    else:
        with stage(f"matrix.ice.{res}.gw.fetch"):
            Mj, S = r.genomewide_device()
            jax.block_until_ready(Mj)
        with stage(f"matrix.ice.{res}.gw.balance"):
            w, _ = ice_balance(Mj, jnp.asarray(S))
            weights = np.asarray(w)[:S]
    r.set_weights(weights)


# ---------------------------------------------------- traditional driver
def traditional_matrix_construction(
    out_path: str, rep_paths: Sequence[str], genome_size: str,
    whole_res: Sequence[int], local_res: Sequence[int],
    chroms: Sequence[str] = ("#", "X"), balance: bool = True,
) -> Dict[str, str]:
    genome = Genome.from_file(genome_size, chroms)
    cooler_dir = os.path.join(out_path, "Cooler")
    os.makedirs(cooler_dir, exist_ok=True)

    whole_res = list(whole_res or [])
    local_res = list(local_res or [])
    rep_whole: List[Dict[int, np.ndarray]] = []
    rep_local: List[Dict[int, Dict[str, np.ndarray]]] = []
    coolers = []

    for rep in rep_paths:
        files = [os.path.join(rep, f) for f in sorted(os.listdir(rep))
                 if f.endswith("_Valid.bed")]
        if not files:
            raise FileNotFoundError(f"no *_Valid.bed under {rep}")
        prefix = bed_prefix(files)
        with stage("matrix.binning"):
            whole, local, total = build_traditional_stream(
                files, genome, whole_res, local_res)
        log.log(21, "replicate %s: %d valid pairs", prefix, total)
        rep_whole.append(whole)
        rep_local.append(local)

        path = os.path.join(cooler_dir, prefix + "Multi.cool")
        with stage("matrix.write_cooler"):
            _write_traditional_cooler(path, genome, whole, local)
        coolers.append(path)

    merged = os.path.join(cooler_dir, "Merged_Multi.cool")
    if len(rep_paths) == 1:
        # one replicate: the merged cooler is byte-identical to the
        # replicate cooler — copy the file instead of re-summing and
        # re-writing ~1 GB of HDF5 (matrixBuilding.py:689-695 merges via
        # cooler.merge_coolers even for one input)
        import shutil

        if os.path.exists(merged):
            os.remove(merged)
        with stage("matrix.merged_copy"):
            shutil.copyfile(coolers[0], merged)
    else:
        whole_m = {res: sum(w[res] for w in rep_whole) for res in whole_res}
        local_m = {
            res: {c: sum(l[res][c] for l in rep_local)
                  for c in genome.labels}
            for res in local_res
        }
        with stage("matrix.write_cooler"):
            _write_traditional_cooler(merged, genome, whole_m, local_m)
    coolers.append(merged)

    if balance:
        with stage("matrix.balance"):
            for res in whole_res:
                _write_weights(merged, genome, res, cis_only=False)
            for res in local_res:
                _write_weights(merged, genome, res, cis_only=True)
            if len(rep_paths) == 1:
                # identical pixels → identical weights: share instead of
                # re-running every balance on the copy
                _copy_weights(merged, coolers[0],
                              list(whole_res) + list(local_res))
            else:
                for path in coolers[:-1]:
                    for res in whole_res:
                        _write_weights(path, genome, res, cis_only=False)
                    for res in local_res:
                        _write_weights(path, genome, res, cis_only=True)
    return {"coolers": coolers, "merged": merged}


def _copy_weights(src: str, dst: str, res_list: Sequence[int]) -> None:
    for res in res_list:
        CoolerReader(dst, res).set_weights(
            CoolerReader(src, res).bins_weight())


def _write_traditional_cooler(path, genome, whole, local):
    if os.path.exists(path):
        os.remove(path)
    for res, M in whole.items():
        if isinstance(M, SparseGW):
            write_cooler(path, genome, res, {}, genomewide_coo=M.coo(),
                         dtype="int", metadata={"onlyIntra": "False"})
        else:
            write_cooler(path, genome, res, {}, genomewide=M, dtype="int",
                         metadata={"onlyIntra": "False"})
    for res, mats in local.items():
        write_cooler(path, genome, res, mats, dtype="int",
                     metadata={"onlyIntra": "True"})


# ------------------------------------------------------ haplotype driver
# Chunk size (rows) for the streamed imputation votes: the per-row work is
# O(|disk rows| * log nnz) searches (sparse) or an O(|disk|) gather (dense),
# so vote chunks are smaller than binning chunks.
VOTE_CHUNK = 1 << 17


def build_haplotype_datasets(
    bed_path: str, genome: Genome, whole_res: Sequence[int],
    local_res: Sequence[int], imputation_region: int = 10_000_000,
    imputation_min: int = 2, imputation_ratio: float = 0.9,
):
    """One replicate: all matrices of the haplotype pipeline.

    Returns dict with keys Tradition_Whole/Tradition_Local/UnImputated_*/
    Imputated_* mirroring the reference's DataSets (matrixBuilding.py:
    1044-1638).  Whole-genome matrices are np arrays up to
    ``DENSE_GW_MAX_BINS`` bins and block-sparse accumulators past it
    (``SparseGW`` for the symmetric Tradition/UnImputated counts,
    ``SparseDirectedGW`` for the asymmetric Imputated counts) — this is
    what takes diploid genome-wide construction to 10 kb (hg19 ≈ 607k
    haplotype bins, ~1.4 TB dense), past the reference's wholeRes >= 2 Mb
    practical limit (README.md:312-318).

    Ingestion streams: three passes over the bed files via the chunked
    reader (bounded host memory, matrixBuilding.py:1081-1094 design
    point) — (1) all five classes → traditional, (2) M_M/P_P/M_P/P_M →
    un-imputed + single-side intra increments, (3) M_M/P_P single-side
    inter → the imputation disk vote against the completed un-imputed
    matrix (dense gather kernel ``impute_inter_chunk`` or the sorted-COO
    range-query kernel ``sparse_impute_vote``).
    """
    beds = discover_allelic_beds(bed_path)
    prefix = bed_prefix([f for v in beds.values() for f in v])
    hap = genome.haplotype()
    nc = len(genome.labels)
    whole_res = list(whole_res or [])
    local_res = list(local_res or [])

    offs_by_res = {res: _offsets_array(hap, res) for res in whole_res}
    base_offs = {res: _offsets_array(genome, res) for res in whole_res}

    # ---- pass 1: traditional matrices from all five classes (cols 0-3) ---
    all_files = [f for k in ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")
                 for f in beds[k]]
    twhole = {res: _GWAcc(genome.total_bins(res), _gw_is_sparse(genome, res))
              for res in whole_res}
    tlocal = {res: _IntraAcc(genome, res) for res in local_res}
    with stage("matrix.hap.pass1_traditional"):
        for c1, p1, c2, p2 in iter_allelic_bed(all_files, genome,
                                               with_tag=False):
            for res in whole_res:
                offs = base_offs[res]
                twhole[res].add_sym(p1 // res + offs[c1],
                                    p2 // res + offs[c2])
            for res in local_res:
                tlocal[res].add(c1, p1, c2, p2)
        tradition_whole = {res: twhole[res].finish() for res in whole_res}
        tradition_local = {res: tlocal[res].finish() for res in local_res}

    # ---- pass 2: haplotype matrices --------------------------------------
    uwhole = {res: _GWAcc(hap.total_bins(res), _gw_is_sparse(hap, res))
              for res in whole_res}
    ulocal = {res: {"M": _IntraAcc(genome, res), "P": _IntraAcc(genome, res)}
              for res in local_res}
    # single-side increments accumulate separately and fold in afterwards
    # (pure addition, so this equals the reference's in-place order)
    swhole = {res: _GWAcc(hap.total_bins(res), _gw_is_sparse(hap, res),
                          directed=True)
              for res in whole_res}
    slocal = {res: {"M": _IntraAcc(genome, res, single_side=True),
                    "P": _IntraAcc(genome, res, single_side=True)}
              for res in local_res}

    with stage("matrix.hap.pass2_haplotype"):
      for cls, with_tag, h1, h2 in (("M_M", True, 0, 0), ("P_P", True, 1, 1),
                                    ("M_P", False, 0, 1), ("P_M", False, 1, 0)):
        side = "M" if h1 == 0 else "P"
        for part in iter_allelic_bed(beds[cls], genome, with_tag=with_tag):
            if with_tag:
                c1, p1, c2, p2, tag = part
                both = tag == TAG_BOTH
                bc1, bp1, bc2, bp2 = c1[both], p1[both], c2[both], p2[both]
            else:
                c1, p1, c2, p2 = part
                bc1, bp1, bc2, bp2 = c1, p1, c2, p2
            for res in whole_res:
                offs = offs_by_res[res]
                uwhole[res].add_sym(bp1 // res + offs[bc1 + h1 * nc],
                                    bp2 // res + offs[bc2 + h2 * nc])
            if with_tag:
                for res in local_res:
                    ulocal[res][side].add(bc1, bp1, bc2, bp2)
                single = ~both
                s_c1, s_p1 = c1[single], p1[single]
                s_c2, s_p2, s_tag = c2[single], p2[single], tag[single]
                intra = s_c1 == s_c2
                for res in whole_res:
                    offs = offs_by_res[res]
                    b1 = s_p1[intra] // res + offs[s_c1[intra] + h1 * nc]
                    b2 = s_p2[intra] // res + offs[s_c2[intra] + h1 * nc]
                    r1 = s_tag[intra] == TAG_R1
                    swhole[res].add_directed(np.where(r1, b1, b2),
                                             np.where(r1, b2, b1))
                for res in local_res:
                    slocal[res][side].add(s_c1[intra], s_p1[intra],
                                          s_c2[intra], s_p2[intra],
                                          tags=s_tag[intra])

    with stage("matrix.hap.locals_finish"):
        unimp_whole = {res: uwhole[res].finish() for res in whole_res}
        side_local = {res: {p: ulocal[res][p].finish() for p in ("M", "P")}
                      for res in local_res}
        unimp_local = {
            res: {p + c: m for p in ("M", "P")
                  for c, m in side_local[res][p].items()}
            for res in local_res
        }
        imp_local = {}
        for res in local_res:
            lib = {}
            for p in ("M", "P"):
                both = ulocal[res][p].finish_plus(slocal[res][p])
                for c, m in both.items():
                    lib[p + c] = m
            imp_local[res] = lib

    # ---- pass 3: inter-chromosome disk vote against the completed U ------
    state: Dict[int, dict] = {}
    any_vote = False
    with stage("matrix.hap.vote_setup"):
      for res in whole_res:
        U = unimp_whole[res]
        L = imputation_region // res
        st: dict = {"sparse": isinstance(U, SparseGW)}
        di_np, dj_np = disk_offsets(L) if L >= 1 else (
            np.zeros(0, np.int32), np.zeros(0, np.int32))
        if st["sparse"]:
            rows, cols, vals = U.coo()
            st["acc"] = swhole[res].acc
            st["base_coo"] = (rows, cols, vals)
            if di_np.size and rows.size:
                st["su"] = SparseU(rows, cols, vals, hap.total_bins(res))
                ri, lo, hi = disk_row_intervals(L)
                st["disk"] = tuple(jnp.asarray(a) for a in (ri, lo, hi))
                st["L"] = L
        else:
            st["dev"] = jnp.asarray(U + swhole[res].finish())
            if di_np.size:
                st["U"] = jnp.asarray(U)
                st["disk"] = (jnp.asarray(di_np), jnp.asarray(dj_np))
                st["L"] = L
        if "L" in st:
            any_vote = True

            def _emit(padded, valid, st=st, mn=float(imputation_min),
                      rt=float(imputation_ratio)):
                import time as _time

                rk, cs, cc = padded
                if st["sparse"]:
                    su = st["su"]
                    ri, lo, hi = st["disk"]
                    t0 = _time.perf_counter()
                    hit, tgt = sparse_impute_vote_rowptr(
                        su.scols, su.cum32, su.row_ptr, jnp.asarray(rk),
                        jnp.asarray(cs), jnp.asarray(cc), jnp.asarray(valid),
                        ri, lo, hi, jnp.int32(su.S), st["L"], mn, rt,
                        su.row_iters)
                    hit = np.asarray(hit)
                    tgt = np.asarray(tgt)
                    # device/host split of the vote wall (VERDICT r4 item 3:
                    # is pass3 host-sort or device-dispatch bound?)
                    profiling_add("matrix.hap.pass3.device",
                                  _time.perf_counter() - t0)
                    t0 = _time.perf_counter()
                    st["acc"].add_directed(rk[hit], tgt[hit])
                    profiling_add("matrix.hap.pass3.host_acc",
                                  _time.perf_counter() - t0)
                else:
                    di, dj = st["disk"]
                    st["dev"] = impute_inter_chunk(
                        st["dev"], st["U"], jnp.asarray(rk), jnp.asarray(cs),
                        jnp.asarray(cc), jnp.asarray(valid), di, dj,
                        st["L"], mn, rt)

            st["buf"] = _ChunkBuffer(
                3, _emit, CHUNK if not st["sparse"] else VOTE_CHUNK)
        state[res] = st

    if any_vote:
      with stage("matrix.hap.pass3_vote"):
        for cls, base in (("M_M", 0), ("P_P", nc)):
            other = nc if base == 0 else -nc
            for c1, p1, c2, p2, tag in iter_allelic_bed(beds[cls], genome,
                                                        with_tag=True):
                inter = (tag != TAG_BOTH) & (c1 != c2)
                if not inter.any():
                    continue
                ic1, ip1 = c1[inter], p1[inter]
                ic2, ip2 = c2[inter], p2[inter]
                r1 = tag[inter] == TAG_R1
                for res in whole_res:
                    st = state[res]
                    if "L" not in st:
                        continue
                    offs = offs_by_res[res]
                    # known side: mate1 when R1 else mate2; candidates on
                    # the unknown side's own chromosome (reference offset
                    # bug fixed, DIVERGENCES.md).
                    known = np.where(r1, ip1 // res + offs[ic1 + base],
                                     ip2 // res + offs[ic2 + base])
                    unk_c = np.where(r1, ic2, ic1)
                    unk_p = np.where(r1, ip2, ip1)
                    st["buf"].add(known,
                                  unk_p // res + offs[unk_c + base],
                                  unk_p // res + offs[unk_c + base + other])

    imp_whole = {}
    for res in whole_res:
        st = state[res]
        if "buf" in st:
            st["buf"].close()
        if st["sparse"]:
            st["acc"].add_symmetric(*st["base_coo"])
            imp_whole[res] = st["acc"]
        else:
            imp_whole[res] = np.asarray(st["dev"])

    return {
        "prefix": prefix,
        "Tradition_Whole": tradition_whole,
        "Tradition_Local": tradition_local,
        "UnImputated_Whole": unimp_whole,
        "UnImputated_Local": unimp_local,
        "Imputated_Whole": imp_whole,
        "Imputated_Local": imp_local,
    }


def _sym_block_margins(T, s: int, e: int, bounds: np.ndarray | None = None):
    """(rowsum, row-nnz) of the intra block [s..e]x[s..e] of a symmetric
    genome-wide matrix stored dense (np [S, S]) or as ``SparseGW``.
    ``bounds`` (inclusive per-chromosome end bins) is required for the
    sparse form — it defines the intra blocks of the one-pass margins."""
    if isinstance(T, SparseGW):
        rs, nz = _gw_intra_margins_sym(T, bounds)
        return rs[s : e + 1], nz[s : e + 1]
    block = T[s : e + 1, s : e + 1]
    return block.sum(axis=1), (block != 0).sum(axis=1)


def _dir_block_rowsum(H, s: int, e: int, bounds: np.ndarray | None = None):
    """Literal row sums of the intra block of a (possibly asymmetric)
    genome-wide matrix stored dense or as ``SparseDirectedGW``."""
    if isinstance(H, SparseDirectedGW):
        return _gw_intra_margins_dir(H, bounds)[s : e + 1]
    return H[s : e + 1, s : e + 1].sum(axis=1)


def _gw_intra_margins_sym(T: SparseGW, bounds: np.ndarray):
    """Per-bin (rowsum, nnz) over INTRA blocks only of a symmetric
    upper-triangle sparse genome-wide matrix, in one bincount pass
    (memoized on the accumulator keyed by ``bounds`` — the
    per-chromosome masked scans this replaces re-walked the full pixel
    table ~70 times per correction)."""
    if bounds is None:
        raise ValueError("sparse intra margins need the chromosome bounds")
    cached = T._intra_margins
    if cached is not None and np.array_equal(cached[0], bounds):
        return cached[1]
    r, c, v = T.coo()
    ci_r = np.searchsorted(bounds, r, side="left")
    ci_c = np.searchsorted(bounds, c, side="left")
    intra = ci_r == ci_c
    ri, ci_, vi = r[intra], c[intra], v[intra]
    rs = np.bincount(ri, weights=vi, minlength=T.S)
    nz = np.bincount(ri, weights=(vi != 0).astype(np.float64),
                     minlength=T.S)
    off = ri != ci_
    rs += np.bincount(ci_[off], weights=vi[off], minlength=T.S)
    nz += np.bincount(ci_[off], weights=(vi[off] != 0).astype(np.float64),
                      minlength=T.S)
    T._intra_margins = (bounds, (rs, nz))
    return rs, nz


def _gw_intra_margins_dir(H: SparseDirectedGW, bounds: np.ndarray):
    """Per-bin literal row sums over INTRA blocks of an asymmetric sparse
    genome-wide matrix, one bincount pass (memoized keyed by bounds)."""
    if bounds is None:
        raise ValueError("sparse intra margins need the chromosome bounds")
    cached = H._intra_margins
    if cached is not None and np.array_equal(cached[0], bounds):
        return cached[1]
    r, c, v = H.coo()
    intra = (np.searchsorted(bounds, r, side="left")
             == np.searchsorted(bounds, c, side="left"))
    rs = np.bincount(r[intra], weights=v[intra], minlength=H.S)
    H._intra_margins = (bounds, rs)
    return rs


def correct_haplotype_datasets(data, genome: Genome,
                               whole_res: Sequence[int],
                               local_res: Sequence[int]):
    """Two-step corrections → (balanced_whole, balanced_local, gaps).

    Whole-genome entries past the dense cap come in as sparse accumulators
    and leave as corrected ``BlockMatrix`` tensors: the per-chromosome alpha
    evaluates from COO row margins (``genomewide_alpha_margins``) and the
    correction runs on the block-sparse asymmetric layout
    (``sparse_genomewide_correction``, dense-parity tested in
    tests/test_sparse.py) — matrixBuilding.py:857-901 semantics without
    ever materializing the [S, S] form.
    """
    hap = genome.haplotype()
    nc = len(genome.labels)

    balanced_whole = {}
    for res in whole_res:
        T = data["Tradition_Whole"][res]
        H = data["Imputated_Whole"][res]
        t_offs = genome.bin_offsets(res)
        h_offs = hap.bin_offsets(res)
        alphas = []
        if isinstance(H, SparseDirectedGW):
            t_bounds = np.asarray(
                [t_offs[c][1] for c in genome.labels], np.int64)
            h_bounds = np.asarray(
                [h_offs[c][1] for c in hap.labels], np.int64)
            for c in genome.labels:
                s, e = t_offs[c]
                n = e - s + 1
                N = pad_to_shape(n)
                trs, tnz = _sym_block_margins(T, s, e, bounds=t_bounds)
                ms, me = h_offs["M" + c]
                ps, pe = h_offs["P" + c]
                mrs = _dir_block_rowsum(H, ms, me, bounds=h_bounds)
                prs = _dir_block_rowsum(H, ps, pe, bounds=h_bounds)

                def _pad(v):
                    z = np.zeros(N, np.float32)
                    z[:n] = v
                    return jnp.asarray(z)

                a = genomewide_alpha_margins(_pad(trs), _pad(tnz), _pad(mrs),
                                             _pad(prs), jnp.asarray(n))
                alphas.append(np.asarray(a)[:n])
            alpha_full = np.concatenate(alphas)
            alpha_full = np.concatenate([alpha_full, alpha_full])
            # closed-form COO correction: the tile layout would allocate a
            # dense 128x128 block per occupied coordinate, and the imputed
            # diploid matrix's scattered inter pixels make that approach
            # dense-scale memory (measured ~37 GB at 26.6M pairs / 10 kb)
            from ..ops.sparse import genomewide_correction_coo

            balanced_whole[res] = genomewide_correction_coo(
                *H.coo(), alpha=alpha_full, n=H.S)
            continue
        for c in genome.labels:
            s, e = t_offs[c]
            n = e - s + 1
            N = pad_to_shape(n)
            tb = np.zeros((N, N), np.float32)
            tb[:n, :n] = T[s : e + 1, s : e + 1]
            ms, me = h_offs["M" + c]
            ps, pe = h_offs["P" + c]
            mb = np.zeros((N, N), np.float32)
            mb[:n, :n] = H[ms : me + 1, ms : me + 1]
            pb = np.zeros((N, N), np.float32)
            pb[:n, :n] = H[ps : pe + 1, ps : pe + 1]
            a = genomewide_alpha(jnp.asarray(tb), jnp.asarray(mb),
                                 jnp.asarray(pb), jnp.asarray(n))
            alphas.append(np.asarray(a)[:n])
        alpha_full = np.concatenate(alphas)
        alpha_full = np.concatenate([alpha_full, alpha_full])
        bal = genomewide_correction(jnp.asarray(H, jnp.float32),
                                    jnp.asarray(alpha_full, jnp.float32),
                                    jnp.asarray(H.shape[0]))
        balanced_whole[res] = np.asarray(bal)

    balanced_local = {}
    gaps = {}
    for res in local_res:
        tra = data["Tradition_Local"][res]
        happ = data["Imputated_Local"][res]
        out = {}
        gap_lib = {}
        for c in genome.labels:
            n = genome.n_bins(c, res)
            N = pad_to_shape(n)

            def _pad(m):
                z = np.zeros((N, N), np.float32)
                z[: m.shape[0], : m.shape[1]] = m
                return z

            nm, npm, gm, gp = two_step_correction(
                jnp.asarray(_pad(tra[c])), jnp.asarray(_pad(happ["M" + c])),
                jnp.asarray(_pad(happ["P" + c])), jnp.asarray(n))
            out["M" + c] = np.asarray(nm)[:n, :n]
            out["P" + c] = np.asarray(npm)[:n, :n]
            gap_lib["M" + c] = np.flatnonzero(np.asarray(gm)[:n])
            gap_lib["P" + c] = np.flatnonzero(np.asarray(gp)[:n])
        balanced_local[res] = out
        gaps[str(res)] = gap_lib
    return balanced_whole, balanced_local, gaps


def _write_hap_coolers(cooler_dir, prefix, genome, hap, data, balanced_whole,
                       balanced_local, gaps, whole_res, local_res):
    tradition = os.path.join(cooler_dir, prefix + "Traditional_Multi.cool")
    unimp = os.path.join(cooler_dir, prefix + "UnImputated_Haplotype_Multi.cool")
    imp = os.path.join(cooler_dir, prefix + "Imputated_Haplotype_Multi.cool")
    for p in (tradition, unimp, imp):
        if os.path.exists(p):
            os.remove(p)

    inter_md = {"onlyIntra": "False"}
    intra_md = {"onlyIntra": "True"}

    def _gw_kwargs(M, dtype):
        from ..ops.sparse import BlockMatrix, blocks_to_coo

        if isinstance(M, (SparseGW, SparseDirectedGW)):
            return {"genomewide_coo": M.coo(), "dtype": dtype}
        if isinstance(M, BlockMatrix):
            return {"genomewide_coo": blocks_to_coo(M), "dtype": dtype}
        if isinstance(M, tuple):  # corrected upper-triangle COO
            return {"genomewide_coo": M, "dtype": dtype}
        return {"genomewide": M, "dtype": dtype}

    for res in whole_res:
        write_cooler(tradition, genome, res, {}, metadata=inter_md,
                     **_gw_kwargs(data["Tradition_Whole"][res], "int"))
        write_cooler(unimp, hap, res, {}, metadata=inter_md,
                     **_gw_kwargs(data["UnImputated_Whole"][res], "int"))
        write_cooler(imp, hap, res, {}, metadata=inter_md,
                     **_gw_kwargs(balanced_whole[res], "float"))
    for res in local_res:
        write_cooler(tradition, genome, res, data["Tradition_Local"][res],
                     dtype="int", metadata=intra_md)
        write_cooler(unimp, hap, res, data["UnImputated_Local"][res],
                     dtype="int", metadata=intra_md)
        write_cooler(imp, hap, res, balanced_local[res], dtype="float",
                     metadata=intra_md)

    for res in whole_res:
        _write_weights(tradition, genome, res, cis_only=False)
    for res in local_res:
        _write_weights(tradition, genome, res, cis_only=True)

    gap_fil = os.path.join(cooler_dir, prefix + "Imputated_Gap.npz")
    np.savez(gap_fil, **{k: np.array(v, dtype=object) for k, v in gaps.items()})
    return {"tradition": tradition, "unimputated": unimp, "imputated": imp,
            "gap": gap_fil}


def haplotype_matrix_construction(
    out_path: str, rep_paths: Sequence[str], genome_size: str,
    whole_res: Sequence[int], local_res: Sequence[int],
    imputation_region: int = 10_000_000, imputation_min: int = 2,
    imputation_ratio: float = 0.9, chroms: Sequence[str] = ("#", "X"),
) -> Dict[str, Dict[str, str]]:
    genome = Genome.from_file(genome_size, chroms)
    hap = genome.haplotype()
    cooler_dir = os.path.join(out_path, "Cooler")
    os.makedirs(cooler_dir, exist_ok=True)
    whole_res = list(whole_res or [])
    local_res = list(local_res or [])

    # Hap_genomeSize next to the coolers (matrixBuilding.py:1551-1564).
    hap.write(os.path.join(cooler_dir, "Hap_genomeSize"))

    all_data = None
    out: Dict[str, Dict[str, str]] = {}
    for rep in rep_paths:
        with stage(f"matrix.build[{os.path.basename(rep.rstrip('/'))}]"):
            data = build_haplotype_datasets(
                rep, genome, whole_res, local_res, imputation_region,
                imputation_min, imputation_ratio)
        with stage("matrix.two_step_correction"):
            bw, bl, gaps = correct_haplotype_datasets(data, genome, whole_res,
                                                      local_res)
        with stage("matrix.cooler_write"):
            out[data["prefix"]] = _write_hap_coolers(
                cooler_dir, data["prefix"], genome, hap, data, bw, bl, gaps,
                whole_res, local_res)
        if all_data is None:
            all_data = data
        else:
            for k in ("Tradition_Whole", "UnImputated_Whole", "Imputated_Whole"):
                for res in whole_res:
                    all_data[k][res] = all_data[k][res] + data[k][res]
            for k in ("Tradition_Local", "UnImputated_Local", "Imputated_Local"):
                for res in local_res:
                    for c in all_data[k][res]:
                        all_data[k][res][c] = all_data[k][res][c] + data[k][res][c]

    if len(rep_paths) > 1:
        bw, bl, gaps = correct_haplotype_datasets(all_data, genome, whole_res,
                                                  local_res)
        out["Merged_"] = _write_hap_coolers(
            cooler_dir, "Merged_", genome, hap, all_data, bw, bl, gaps,
            whole_res, local_res)
    return out
