"""Cooler-format HDF5 persistence on the built-in HDF5 subset (io/hdf5.py).

The reference delegates to the ``cooler`` package (HiCHap/matrixBuilding.py:
100-303 ``NPZ2Cooler``); that package is not part of this framework's
dependency set, so we write the documented Cooler schema (format-version 3,
storage-mode symmetric-upper) ourselves.  Files written here are readable by
stock ``cooler``/``cooltools``, and we can read both our own files and
cooler-produced ones.

Layout parity with the reference:
  * multi-resolution files store one cooler group per resolution at the root,
    addressed as ``file.cool::<res>`` (NPZ2Cooler writes ``outfil::res``,
    matrixBuilding.py:200);
  * bin tables use cooler's ``binnify`` convention (ceil(length/res));
  * raw matrices store int32 counts, corrected matrices float64
    (matrixBuilding.py:195-198);
  * balancing weights live in ``bins/weight`` like ``cooler balance``.

Files this module writes are read back by ``io/hdf5.py`` alone.  A cooler
written by another tool may use HDF5 features outside that subset (stock
``cooler`` writes chunked, compressed pixel tables); those open through
h5py when it is installed, and fail with a clear message when it is not.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

from ..core.genome import Genome
from . import hdf5

_FORMAT = "HDF5::Cooler"
_FORMAT_VERSION = 3
_GEN = "hichap_master_tpu"

# Densify-on-host cap for device matrix fetches (bytes of the padded dense
# f32 square).  Below this, COO pixels are scattered into a dense host array
# (cooler pixels are unique -> pure assignment) and the *upper triangle* is
# shipped in the narrowest dtype that holds the counts, with cast+symmetrize
# on device.  Above it, pixels upload as COO and scatter on device.  The
# crossover between host densify and device scatter-add is not measured on
# the H100; the cap is kept as it was set for the first accelerator.
_DENSE_UPLOAD_MAX = int(os.environ.get(
    "HICHAP_DENSE_UPLOAD_MAX", str(512 << 20)))


_SYM_CAST_JIT = None


def _sym_cast_device(M_upper):
    """jit: upper-triangular [P,P] (narrow dtype) -> symmetric f32 on device.

    The jitted callable is created once (module cache) so each (shape, dtype)
    compiles exactly once per process.
    """
    global _SYM_CAST_JIT
    if _SYM_CAST_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def _k(Mu):
            Mf = Mu.astype(jnp.float32)
            return Mf + jnp.triu(Mf, 1).T

        _SYM_CAST_JIT = _k
    return _SYM_CAST_JIT(M_upper)


def _dense_device_sym(rows, cols, vals, P: int):
    """Dense symmetric [P,P] f32 on device from unique upper-tri pixels.

    Host-side assignment (no bincount — cooler pixel tables hold unique
    (bin1, bin2) pairs), then the narrowest exact wire dtype: uint16 for
    integer counts <= 65535, int32 for larger integers, float32 otherwise.
    Symmetrization runs on device so the wire carries the narrow dtype.
    """
    import jax.numpy as jnp

    if np.issubdtype(vals.dtype, np.floating):
        wire = np.float32
    else:
        vmax = int(vals.max()) if len(vals) else 0
        wire = np.uint16 if vmax <= np.iinfo(np.uint16).max else np.int32
    M_host = np.zeros((P, P), dtype=wire)
    # Pixel tables read from a conforming cooler are (bin1, bin2)-sorted,
    # so duplicate keys are adjacent — one O(nnz) compare guards the
    # assignment.  An UNSORTED table (nonconforming file) could hide
    # non-adjacent duplicates from that compare, so unsortedness itself
    # also routes to the accumulate path (review find).
    key = rows.astype(np.int64) * P + cols
    if len(key) > 1 and (bool(np.any(key[1:] == key[:-1]))
                         or not bool(np.all(key[1:] >= key[:-1]))):
        acc = np.zeros((P, P),
                       np.float64 if wire is np.float32 else np.int64)
        np.add.at(acc, (rows, cols), vals)
        M_host = acc.astype(np.float32)
    else:
        M_host[rows, cols] = vals.astype(wire, copy=False)
    return _sym_cast_device(jnp.asarray(M_host))


def _open(path: str, mode: str = "r"):
    """Open with the built-in HDF5 subset; fall back to h5py for files
    that other tools wrote with features outside it."""
    try:
        return hdf5.File(path, mode)
    except hdf5.Unsupported as e:
        try:
            import h5py
        except ImportError:
            raise RuntimeError(
                f"{path}: {e} is outside the HDF5 subset this package "
                "reads without h5py; install h5py to open this file") from e
        return h5py.File(path, mode)


def _uri(path_or_uri: str) -> Tuple[str, str]:
    if "::" in path_or_uri:
        path, grp = path_or_uri.split("::", 1)
        return path, "/" + grp.strip("/")
    return path_or_uri, "/"


def list_resolutions(path: str) -> List[int]:
    with _open(path, "r") as f:
        out = []
        for k in f.keys():
            try:
                out.append(int(k))
            except ValueError:
                continue
        return sorted(out)


def _sort_pixels(b1, b2, v, nbins: int):
    """(b1, b2)-sort a pixel table, skipping the sort when it is already
    ordered — the common case: ``SparseGW.coo()`` emits sorted keys, and
    per-chromosome blocks appended in label order are sorted by
    construction.  The check is one O(n) pass vs an O(n log n) lexsort of
    tens of millions of pixels on the 1-core host."""
    key = b1.astype(np.int64) * np.int64(max(nbins, 1)) + b2
    if key.size < 2 or bool(np.all(key[1:] >= key[:-1])):
        return b1, b2, v
    order = np.argsort(key, kind="stable")  # one composite-key argsort
    return b1[order], b2[order], v[order]


class CoolerWriter:
    """Write one cooler group from per-chromosome dense/sparse matrices."""

    def __init__(self, genome: Genome, res: int, dtype: str = "int"):
        self.genome = genome
        self.res = res
        self.count_dtype = np.int32 if dtype == "int" else np.float64

    # ---------------------------------------------------------------- bins
    def _bins(self):
        return self.genome.cooler_bin_table(self.res)

    def _chrom_offsets(self) -> np.ndarray:
        nb = [self.genome.cooler_n_bins(c, self.res) for c in self.genome.labels]
        return np.concatenate([[0], np.cumsum(nb)]).astype(np.int64)

    # -------------------------------------------------------------- pixels
    def pixels_from_dense(self, matrices: Mapping[str, np.ndarray],
                          inter: Mapping[Tuple[str, str], np.ndarray] | None = None):
        """Upper-triangle COO pixels with genome-wide bin ids.

        ``matrices[c]`` are intra-chromosome dense matrices (either matrix
        convention ``len//res+1`` or cooler convention; trimmed to the cooler
        bin count — the extra trailing bin is empty by construction).
        ``inter[(c1, c2)]`` optional cross blocks with c1 before c2.
        """
        offs = self._chrom_offsets()
        idx = {c: i for i, c in enumerate(self.genome.labels)}
        b1_all, b2_all, v_all = [], [], []
        for c, M in matrices.items():
            ci = idx[c]
            nb = self.genome.cooler_n_bins(c, self.res)
            Mt = np.asarray(M)[:nb, :nb]
            iu, ju = np.nonzero(Mt)  # filter beats np.triu's full copy
            keep = ju >= iu
            iu, ju = iu[keep], ju[keep]
            b1_all.append(iu + offs[ci])
            b2_all.append(ju + offs[ci])
            v_all.append(Mt[iu, ju])
        if inter:
            for (c1, c2), M in inter.items():
                ci, cj = idx[c1], idx[c2]
                if ci > cj:
                    ci, cj = cj, ci
                    M = np.asarray(M).T
                    c1, c2 = c2, c1
                n1 = self.genome.cooler_n_bins(c1, self.res)
                n2 = self.genome.cooler_n_bins(c2, self.res)
                Mt = np.asarray(M)[:n1, :n2]
                iu, ju = np.nonzero(Mt)
                b1_all.append(iu + offs[ci])
                b2_all.append(ju + offs[cj])
                v_all.append(Mt[iu, ju])
        if not b1_all:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, self.count_dtype))
        b1 = np.concatenate(b1_all)
        b2 = np.concatenate(b2_all)
        v = np.concatenate(v_all).astype(self.count_dtype)
        return _sort_pixels(b1, b2, v, int(offs[-1]))

    def pixels_from_genomewide(self, M: np.ndarray):
        """Pixels from one dense genome-wide matrix laid out in *matrix*
        bin convention (len//res+1 per chromosome, concatenated).

        One nonzero scan + upper-triangle filter feeding the COO exit
        path (which handles the matrix→cooler bin conversion), instead of
        per-chromosome-pair ``np.triu`` block copies — the block walk was
        a measured multi-second share of the e2e cooler write."""
        M = np.asarray(M)
        iu, ju = np.nonzero(M)
        keep = ju >= iu
        iu, ju = iu[keep], ju[keep]
        return self.pixels_from_genomewide_coo(iu, ju, M[iu, ju])

    def pixels_from_genomewide_coo(self, rows: np.ndarray, cols: np.ndarray,
                                   vals: np.ndarray):
        """Pixels from upper-triangle genome-wide COO in *matrix* bin
        convention — the block-sparse exit path that never materializes the
        dense matrix.  Converts matrix bin ids to cooler bin ids (dropping
        the empty trailing bin of chromosomes whose length is an exact
        multiple of the resolution)."""
        labels = self.genome.labels
        offs_m = self.genome.bin_offsets(self.res)
        starts_m = np.asarray([offs_m[c][0] for c in labels], np.int64)
        ends_m = np.asarray([offs_m[c][1] for c in labels], np.int64)
        nb_c = np.asarray(
            [self.genome.cooler_n_bins(c, self.res) for c in labels],
            np.int64)
        offs_c = self._chrom_offsets()

        def convert(g):
            ci = np.searchsorted(ends_m, g, side="left")
            local = g - starts_m[ci]
            ok = local < nb_c[ci]
            return offs_c[ci] + local, ok

        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        b1, ok1 = convert(rows)
        b2, ok2 = convert(cols)
        keep = ok1 & ok2 & (np.asarray(vals) != 0)
        b1, b2 = b1[keep], b2[keep]
        v = np.asarray(vals)[keep].astype(self.count_dtype)
        return _sort_pixels(b1, b2, v, int(offs_c[-1]))

    # --------------------------------------------------------------- write
    def write(self, path_or_uri: str, b1: np.ndarray, b2: np.ndarray,
              v: np.ndarray, weights: np.ndarray | None = None,
              metadata: dict | None = None, assembly: str = "unknown") -> None:
        path, grp_name = _uri(path_or_uri)
        mode = "a" if os.path.exists(path) else "w"
        chrom_ids, starts, ends = self._bins()
        n_bins = len(starts)
        offs = self._chrom_offsets()

        with _open(path, mode) as f:
            if grp_name in f and grp_name != "/":
                del f[grp_name]
            grp = f.require_group(grp_name)
            for k in list(grp.keys()):
                del grp[k]
            # the named-group branch above drops attrs with the group;
            # a root-group rewrite must clear them too or stale attrs
            # (old metadata JSON, old nnz/sum) survive onto the new table
            for k in list(grp.attrs.keys()):
                del grp.attrs[k]

            labels = np.array(self.genome.labels, dtype="S64")
            max_len = max(self.genome.sizes.values(), default=0)
            # stock cooler uses int32 coordinates (every real chromosome
            # fits); fall back to int64 for oversized synthetic genomes
            coord_t = np.int32 if max_len < 2**31 else np.int64
            lengths = np.array(
                [self.genome.sizes[c] for c in self.genome.labels],
                dtype=coord_t,
            )
            chroms = grp.create_group("chroms")
            chroms.create_dataset("name", data=labels)
            chroms.create_dataset("length", data=lengths)

            bins = grp.create_group("bins")
            bins.create_dataset(
                "chrom", data=chrom_ids.astype(np.int32),
            )
            # cooler stores bins/chrom as an HDF5 enum of chrom names; plain
            # int32 indices keep the same values and remain readable.
            bins.create_dataset("start", data=starts.astype(coord_t))
            bins.create_dataset("end", data=ends.astype(coord_t))
            if weights is not None:
                bins.create_dataset("weight", data=np.asarray(weights, np.float64))

            pixels = grp.create_group("pixels")
            pixels.create_dataset("bin1_id", data=b1.astype(np.int64))
            pixels.create_dataset("bin2_id", data=b2.astype(np.int64))
            pixels.create_dataset("count", data=v.astype(self.count_dtype))

            indexes = grp.create_group("indexes")
            indexes.create_dataset("chrom_offset", data=offs)
            bin1_offset = np.searchsorted(b1, np.arange(n_bins + 1), side="left")
            indexes.create_dataset("bin1_offset", data=bin1_offset.astype(np.int64))

            grp.attrs["format"] = _FORMAT
            grp.attrs["format-version"] = _FORMAT_VERSION
            grp.attrs["bin-size"] = self.res
            grp.attrs["bin-type"] = "fixed"
            grp.attrs["storage-mode"] = "symmetric-upper"
            grp.attrs["nchroms"] = len(labels)
            grp.attrs["nbins"] = n_bins
            grp.attrs["nnz"] = len(v)
            grp.attrs["sum"] = float(v.sum()) if len(v) else 0.0
            grp.attrs["generated-by"] = _GEN
            grp.attrs["genome-assembly"] = assembly
            if metadata:
                grp.attrs["metadata"] = json.dumps(metadata)


def write_cooler(path: str, genome: Genome, res: int,
                 matrices: Mapping[str, np.ndarray],
                 inter: Mapping[Tuple[str, str], np.ndarray] | None = None,
                 genomewide: np.ndarray | None = None,
                 genomewide_coo: Tuple[np.ndarray, np.ndarray, np.ndarray]
                 | None = None,
                 weights: np.ndarray | None = None,
                 dtype: str = "int", metadata: dict | None = None) -> str:
    """Write ``path::res``.  Either per-chrom ``matrices`` (+optional inter
    blocks), one dense ``genomewide`` matrix, or upper-triangle
    ``genomewide_coo`` (rows, cols, vals) in matrix bin convention."""
    w = CoolerWriter(genome, res, dtype)
    if genomewide_coo is not None:
        b1, b2, v = w.pixels_from_genomewide_coo(*genomewide_coo)
    elif genomewide is not None:
        b1, b2, v = w.pixels_from_genomewide(np.asarray(genomewide))
    else:
        b1, b2, v = w.pixels_from_dense(matrices, inter)
    uri = f"{path}::{res}"
    w.write(uri, b1, b2, v, weights=weights, metadata=metadata)
    return uri


class CoolerReader:
    """Read cooler groups written by us or by stock cooler."""

    def __init__(self, path_or_uri: str, res: int | None = None):
        path, grp = _uri(path_or_uri)
        if res is not None and grp == "/":
            grp = f"/{res}"
        self.path = path
        self.grp = grp
        with _open(path, "r") as f:
            g = f[self.grp]
            names = g["chroms/name"][:]
            self.chromnames: List[str] = [
                n.decode() if isinstance(n, bytes) else str(n) for n in names
            ]
            self.lengths = {
                c: int(l) for c, l in zip(self.chromnames, g["chroms/length"][:])
            }
            self.res = int(g.attrs["bin-size"])
            self.chrom_offset = g["indexes/chrom_offset"][:]
            self.nbins = int(g.attrs["nbins"])
            self.has_weights = "weight" in g["bins"]

    def genome(self, chroms: Sequence[str] = ()) -> Genome:
        """Genome registry of this cooler's chromosomes.

        NOTE: the registry normalizes labels through its own rules
        (``chr`` prefixes stripped, karyotype-sorted), which can differ
        from this FILE's chrom-table order/names (e.g. haplotype
        M1..P22 coolers, stock ``chr``-prefixed files).  For bin
        arithmetic against the pixel table use ``self.chromnames`` /
        ``self.chrom_offset``, which are always file-order."""
        return Genome(self.lengths, chroms or ())

    def bins_weight(self, label: str | None = None) -> np.ndarray:
        with _open(self.path, "r") as f:
            g = f[self.grp]
            w = g["bins/weight"][:]
        if label is None:
            return w
        ci = self.chromnames.index(label)
        s, e = self.chrom_offset[ci], self.chrom_offset[ci + 1]
        return w[s:e]

    def pixels_coo(self):
        """The whole pixel table as (bin1, bin2, count) in cooler bin ids —
        the block-sparse entry path (genome-wide matrices too large to
        densify)."""
        with _open(self.path, "r") as f:
            g = f[self.grp]
            return (g["pixels/bin1_id"][:], g["pixels/bin2_id"][:],
                    g["pixels/count"][:])

    def _row_slice(self, g, s, e):
        """Pixel index range covering bin1 in [s, e) via the bin1_offset
        index — avoids scanning the whole pixel table per fetch."""
        off = g["indexes/bin1_offset"]
        return int(off[s]), int(off[e])

    def _fetch_block(self, ci: int, cj: int) -> np.ndarray:
        s1, e1 = int(self.chrom_offset[ci]), int(self.chrom_offset[ci + 1])
        s2, e2 = int(self.chrom_offset[cj]), int(self.chrom_offset[cj + 1])
        n1, n2 = e1 - s1, e2 - s2
        out = np.zeros((n1, n2), dtype=np.float64)
        with _open(self.path, "r") as f:
            g = f[self.grp]
            lo, hi = self._row_slice(g, s1, e1)
            b1 = g["pixels/bin1_id"][lo:hi]
            b2 = g["pixels/bin2_id"][lo:hi]
            v = g["pixels/count"][lo:hi]
            m = (b2 >= s2) & (b2 < e2)
            out[b1[m] - s1, b2[m] - s2] = v[m]
            if ci == cj:
                out = np.triu(out) + np.triu(out, 1).T
            else:
                # symmetric-upper storage: the transposed block lives in
                # rows of chromosome cj
                lo, hi = self._row_slice(g, s2, e2)
                b1 = g["pixels/bin1_id"][lo:hi]
                b2 = g["pixels/bin2_id"][lo:hi]
                v = g["pixels/count"][lo:hi]
                m2 = (b2 >= s1) & (b2 < e1)
                out[b2[m2] - s1, b1[m2] - s2] = v[m2]
        return out

    def fetch_coo(self, label: str, keep_dtype: bool = False):
        """Intra-chromosome upper-triangle COO (rows, cols, vals), local
        bin ids — the cheap representation for host→device upload.

        ``keep_dtype=True`` returns counts in the stored dtype (int32 for
        raw coolers) so narrow-wire consumers can pick their own width."""
        ci = self.chromnames.index(label)
        s1, e1 = int(self.chrom_offset[ci]), int(self.chrom_offset[ci + 1])
        with _open(self.path, "r") as f:
            g = f[self.grp]
            lo, hi = self._row_slice(g, s1, e1)
            b1 = g["pixels/bin1_id"][lo:hi]
            b2 = g["pixels/bin2_id"][lo:hi]
            v = g["pixels/count"][lo:hi]
        m = (b2 >= s1) & (b2 < e1)
        v = v[m]
        if not keep_dtype:
            # corrected coolers store float64 counts; keep them (the loops
            # selection quantiles read these values — a f32 round-trip
            # shifted threshold-adjacent candidates).  Raw int32 counts are
            # exact in f32 and stay on the narrow wire.
            vt = (np.float64 if np.issubdtype(v.dtype, np.floating)
                  else np.float32)
            v = v.astype(vt)
        return (b1[m] - s1).astype(np.int32), (b2[m] - s1).astype(np.int32), v

    def matrix_device(self, label: str, padded: int | None = None,
                      balance: bool = False):
        """Dense symmetric matrix materialized ON DEVICE from the COO pixels
        (uploads ~nnz*12 bytes instead of N² — host↔device links are the
        bottleneck for big chromosomes).  Returns (jnp [P, P], n)."""
        import jax.numpy as jnp

        from ..core.contacts import pad_to_shape

        rows, cols, vals = self.fetch_coo(label, keep_dtype=True)
        ci = self.chromnames.index(label)
        n = int(self.chrom_offset[ci + 1] - self.chrom_offset[ci])
        P = padded or pad_to_shape(n)
        nnz = len(vals)
        if P * P * 4 <= _DENSE_UPLOAD_MAX:
            # densify host-side and upload dense; device scatter takes over
            # when the dense square is too big to ship (_DENSE_UPLOAD_MAX)
            M = _dense_device_sym(rows, cols, vals, P)
        else:
            # sparse (fine resolutions): COO upload beats shipping N² zeros;
            # nnz padded to a power of two so scatter graphs are reused.
            cap = 1 << max(nnz - 1, 1).bit_length()
            r = np.zeros(cap, np.int32)
            c = np.zeros(cap, np.int32)
            v = np.zeros(cap, np.float32)
            r[:nnz] = rows
            c[:nnz] = cols
            v[:nnz] = vals
            M = jnp.zeros((P, P), jnp.float32)
            r = jnp.asarray(r)
            c = jnp.asarray(c)
            v = jnp.asarray(v)
            M = M.at[r, c].add(v)
            M = M.at[c, r].add(jnp.where(r != c, v, 0.0))
        if balance:
            w = jnp.asarray(self.bins_weight(label), jnp.float32)
            w = jnp.pad(w, (0, P - n))
            M = M * w[:, None] * w[None, :]
        return M, n

    def genomewide_device(self, padded: int | None = None):
        """Dense genome-wide symmetric matrix on device from all pixels.
        Returns (jnp [S_pad, S_pad], S)."""
        import jax.numpy as jnp

        from ..core.contacts import pad_to_shape

        with _open(self.path, "r") as f:
            g = f[self.grp]
            b1 = g["pixels/bin1_id"][:]
            b2 = g["pixels/bin2_id"][:]
            v = g["pixels/count"][:]
        S = self.nbins
        P = padded or pad_to_shape(S)
        nnz = len(v)
        if P * P * 4 <= _DENSE_UPLOAD_MAX:
            # host densify + narrow-dtype upload (see _DENSE_UPLOAD_MAX)
            return _dense_device_sym(b1, b2, v, P), S
        cap = 1 << max(nnz - 1, 1).bit_length()
        r = np.zeros(cap, np.int64)
        c = np.zeros(cap, np.int64)
        w = np.zeros(cap, np.float32)
        r[:nnz] = b1
        c[:nnz] = b2
        w[:nnz] = v
        M = jnp.zeros((P, P), jnp.float32)
        rj, cj, wj = jnp.asarray(r), jnp.asarray(c), jnp.asarray(w)
        M = M.at[rj, cj].add(wj)
        M = M.at[cj, rj].add(jnp.where(rj != cj, wj, 0.0))
        return M, S

    def matrix(self, label: str, balance: bool = False) -> np.ndarray:
        ci = self.chromnames.index(label)
        M = self._fetch_block(ci, ci)
        if balance:
            w = self.bins_weight(label)
            M = M * w[:, None] * w[None, :]
        return M

    def matrix_between(self, label1: str, label2: str) -> np.ndarray:
        return self._fetch_block(
            self.chromnames.index(label1), self.chromnames.index(label2)
        )

    def set_weights(self, weights: np.ndarray) -> None:
        with _open(self.path, "a") as f:
            g = f[self.grp]
            if "weight" in g["bins"]:
                del g["bins"]["weight"]
            g["bins"].create_dataset("weight", data=np.asarray(weights, np.float64))
        self.has_weights = True
