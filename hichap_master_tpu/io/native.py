"""ctypes bindings for the native IO runtime (native/hicio.cpp).

Builds ``libhicio.so`` on first use with g++ (no pybind11 dependency) and
falls back to pure-Python implementations when a compiler is unavailable.
Provides the external-memory sorts the filtering layer leans on:

  * ``sort_file(in, out, mode)``  — mode "name" (whole-line lexicographic,
    the allelic merge-join order, filtering.py:451-499) or "hic_key"
    (chr1/strand1/pos1/chr2/strand2/pos2, the dedup order,
    filtering.py:77-108);
  * ``merge_sorted(paths, out, mode)`` — k-way merge of sorted files;
  * ``count_lines(path)``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import List, Optional, Sequence

from ..utils.logging import get_logger

log = get_logger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "hicio.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "libhicio.so")
_MODES = {"name": 0, "hic_key": 1}
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    # compile to a per-process temp and os.rename (atomic on POSIX):
    # spawn-pool workers all hit the first-use build concurrently, and a
    # worker dlopening a half-written .so would crash instead of falling
    # back
    tmp = f"{_SO}.build.{os.getpid()}"
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    except (subprocess.CalledProcessError, OSError) as e:
        err = getattr(e, "stderr", b"")
        log.warning("hicio build failed: %s",
                    err.decode()[:500] if err else repr(e))
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return _SO


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        log.warning("native hicio unavailable; using Python fallbacks")
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # torn/incompatible .so: fall back, don't crash
        log.warning("hicio load failed (%s); using Python fallbacks", e)
        return None
    lib.hicio_sort_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.hicio_sort_file.restype = ctypes.c_int
    lib.hicio_merge_sorted.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.hicio_merge_sorted.restype = ctypes.c_int
    lib.hicio_count_lines.argtypes = [ctypes.c_char_p]
    lib.hicio_count_lines.restype = ctypes.c_long
    lib.hicio_sam_sort_merge.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.c_int, ctypes.c_char_p]
    lib.hicio_sam_sort_merge.restype = ctypes.c_int
    lib.hicio_parse_valid_chunk.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.hicio_parse_valid_chunk.restype = ctypes.c_long
    lib.hicio_gwacc_new.argtypes = []
    lib.hicio_gwacc_new.restype = ctypes.c_void_p
    lib.hicio_gwacc_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int64]
    lib.hicio_gwacc_add.restype = ctypes.c_int
    lib.hicio_gwacc_size.argtypes = [ctypes.c_void_p]
    lib.hicio_gwacc_size.restype = ctypes.c_int64
    lib.hicio_gwacc_total.argtypes = [ctypes.c_void_p]
    lib.hicio_gwacc_total.restype = ctypes.c_double
    lib.hicio_gwacc_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.hicio_gwacc_export.restype = ctypes.c_int
    lib.hicio_gwacc_export_coo.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
    lib.hicio_gwacc_export_coo.restype = ctypes.c_int
    lib.hicio_gwacc_free.argtypes = [ctypes.c_void_p]
    lib.hicio_gwacc_free.restype = None
    lib.hicio_parse_allelic_chunk.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.hicio_parse_allelic_chunk.restype = ctypes.c_long
    lib.hicio_radix_sort_kv.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
    lib.hicio_radix_sort_kv.restype = ctypes.c_int
    lib.hicio_abed_open.argtypes = [ctypes.c_char_p]
    lib.hicio_abed_open.restype = ctypes.c_void_p
    lib.hicio_abed_rows.argtypes = [ctypes.c_void_p]
    lib.hicio_abed_rows.restype = ctypes.c_long
    lib.hicio_abed_name_width.argtypes = [ctypes.c_void_p]
    lib.hicio_abed_name_width.restype = ctypes.c_int
    lib.hicio_abed_n_labels.argtypes = [ctypes.c_void_p]
    lib.hicio_abed_n_labels.restype = ctypes.c_int
    lib.hicio_abed_label_bytes.argtypes = [ctypes.c_void_p]
    lib.hicio_abed_label_bytes.restype = ctypes.c_int
    lib.hicio_abed_labels.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hicio_abed_labels.restype = ctypes.c_int
    lib.hicio_abed_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 17
    lib.hicio_abed_export.restype = ctypes.c_int
    lib.hicio_abed_free.argtypes = [ctypes.c_void_p]
    lib.hicio_abed_free.restype = None
    _lib = lib
    return _lib


def load_allelic_bed(path: str):
    """One native pass over a 15/23-column allelic valid bed → typed
    columns: ``(cols, labels)`` where cols maps the aFiltering column
    numbers to numpy arrays (names as fixed-width ``S`` bytes, chroms as
    int32 codes into ``labels``, numerics as int64, the candidate tag as
    uint8 0/1/2) — see native/hicio.cpp ``hicio_abed_*``.  Returns None
    when the library is missing or the file violates the strict 15/23
    layout (caller falls back to the ragged-tolerant Python reader)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    h = lib.hicio_abed_open(path.encode())
    if not h:
        return None
    try:
        n = lib.hicio_abed_rows(h)
        if n < 0:
            return None
        w = max(1, lib.hicio_abed_name_width(h))
        names = np.zeros(n, dtype=f"S{w}")
        c1 = np.empty(n, np.int32)
        c8 = np.empty(n, np.int32)
        c15 = np.empty(n, np.int32)
        ints = {c: np.empty(n, np.int64)
                for c in (3, 5, 6, 7, 10, 12, 13, 14, 17, 19, 20, 21)}
        tag = np.empty(n, np.uint8)
        ptr = [names.ctypes.data, c1.ctypes.data, c8.ctypes.data,
               c15.ctypes.data] + [ints[c].ctypes.data
                                   for c in (3, 5, 6, 7, 10, 12, 13, 14,
                                             17, 19, 20, 21)] + \
              [tag.ctypes.data]
        if lib.hicio_abed_export(h, *ptr):
            return None
        nb = lib.hicio_abed_label_bytes(h)
        buf = ctypes.create_string_buffer(max(nb, 1))
        lib.hicio_abed_labels(h, buf)
        labels = [s.decode() for s in buf.raw[:nb].split(b"\0")[:-1]]
    finally:
        lib.hicio_abed_free(h)
    cols = {0: names, 1: c1, 8: c8, 15: c15, 22: tag, **ints}
    return cols, labels


def parse_allelic_chunk(buf: bytes, labels: Sequence[str], with_tag: bool):
    """Parse a complete-lines block of allelic-bed text → (c1, p1, c2,
    p2[, tag]) via the native scanner; None when the library is missing
    (caller falls back to the Python parser)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cap = buf.count(b"\n") + (0 if buf.endswith(b"\n") or not buf else 1)
    c1 = np.empty(cap, np.int32)
    p1 = np.empty(cap, np.int64)
    c2 = np.empty(cap, np.int32)
    p2 = np.empty(cap, np.int64)
    tag = np.empty(cap, np.int8)
    arr = (ctypes.c_char_p * len(labels))(*[l.encode() for l in labels])
    n = lib.hicio_parse_allelic_chunk(
        buf, len(buf), arr, len(labels), int(with_tag),
        c1.ctypes.data_as(ctypes.c_void_p), p1.ctypes.data_as(ctypes.c_void_p),
        c2.ctypes.data_as(ctypes.c_void_p), p2.ctypes.data_as(ctypes.c_void_p),
        tag.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    out = (c1[:n], p1[:n], c2[:n], p2[:n])
    return out + (tag[:n],) if with_tag else out


def radix_sort_kv(keys, vals) -> bool:
    """In-place radix sort of parallel (int64 keys >= 0, float64 vals) by
    key.  Returns False when the native library is unavailable (caller
    falls back to numpy)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    assert keys.dtype == np.int64 and vals.dtype == np.float64
    assert keys.flags["C_CONTIGUOUS"] and vals.flags["C_CONTIGUOUS"]
    rc = lib.hicio_radix_sort_kv(
        keys.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p), keys.size)
    return rc == 0


class GwAccumulator:
    """Native genome-wide key accumulator (int64 pixel key → f64 count).

    Open-addressing hash in C++ (native/hicio.cpp hicio_gwacc_*): O(1)
    amortized per occurrence vs the numpy sort+merge compaction's
    O(log n), which dominated the e2e matrix-stage stream.  ``export``
    returns the unique keys sorted ascending with their counts,
    non-destructively.  Construct via ``gw_accumulator()`` which returns
    None when the native library is unavailable (callers keep the numpy
    fallback)."""

    __slots__ = ("_lib", "_h", "_coo_cache", "_kv_cache")

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.hicio_gwacc_new()
        if not self._h:
            raise MemoryError("hicio_gwacc_new failed")
        # export memoization: consumers (per-chromosome margin loops,
        # repeated cooler writes) call coo()/export() many times between
        # adds; the radix export of tens of millions of pixels is seconds,
        # so cache it and invalidate on the next add
        self._coo_cache = None  # (S, rows, cols, cnts)
        self._kv_cache = None   # (keys, cnts)

    def add(self, keys, weights=None) -> None:
        import numpy as np

        k = np.ascontiguousarray(keys, np.int64)
        if k.size == 0:
            return
        self._coo_cache = None
        self._kv_cache = None
        wp = None
        if weights is not None:
            w = np.ascontiguousarray(weights, np.float64)
            assert w.size == k.size
            wp = w.ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.hicio_gwacc_add(
            self._h, k.ctypes.data_as(ctypes.c_void_p), wp, k.size)
        if rc != 0:
            raise MemoryError("hicio_gwacc_add allocation failure")

    def size(self) -> int:
        return int(self._lib.hicio_gwacc_size(self._h))

    def total(self) -> float:
        return float(self._lib.hicio_gwacc_total(self._h))

    def export(self):
        import numpy as np

        if self._kv_cache is not None:
            return self._kv_cache
        n = self.size()
        keys = np.empty(n, np.int64)
        cnts = np.empty(n, np.float64)
        rc = self._lib.hicio_gwacc_export(
            self._h, keys.ctypes.data_as(ctypes.c_void_p),
            cnts.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise MemoryError("hicio_gwacc_export allocation failure")
        self._kv_cache = (keys, cnts)
        return keys, cnts

    def export_coo(self, S: int):
        """Sorted (rows, cols, counts) with rows = key // S, cols = key % S
        computed natively in the export pass."""
        import numpy as np

        if self._coo_cache is not None and self._coo_cache[0] == S:
            return self._coo_cache[1:]
        n = self.size()
        rows = np.empty(n, np.int64)
        cols = np.empty(n, np.int64)
        cnts = np.empty(n, np.float64)
        rc = self._lib.hicio_gwacc_export_coo(
            self._h, S, rows.ctypes.data_as(ctypes.c_void_p),
            cols.ctypes.data_as(ctypes.c_void_p),
            cnts.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise MemoryError("hicio_gwacc_export_coo failure")
        self._coo_cache = (S, rows, cols, cnts)
        return rows, cols, cnts

    def __del__(self):
        h, self._h = self._h, None
        if h:
            self._lib.hicio_gwacc_free(h)


def gw_accumulator() -> Optional[GwAccumulator]:
    """A native accumulator, or None (library missing or
    ``HICHAP_NATIVE_GWACC=0``) — callers fall back to the numpy path."""
    if os.environ.get("HICHAP_NATIVE_GWACC", "1") == "0":
        return None
    lib = get_lib()
    if lib is None:
        return None
    try:
        return GwAccumulator(lib)
    except MemoryError:
        return None


def parse_valid_chunk(buf: bytes, labels: Sequence[str]):
    """Parse a complete-lines block of valid-bed text → (c1, p1, c2, p2)
    numpy columns via the native scanner (one pass, no per-field Python
    objects).

    Returns None when the native library is unavailable (caller falls
    back to the Python parser)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cap = buf.count(b"\n") + (0 if buf.endswith(b"\n") or not buf else 1)
    c1 = np.empty(cap, np.int32)
    p1 = np.empty(cap, np.int64)
    c2 = np.empty(cap, np.int32)
    p2 = np.empty(cap, np.int64)
    arr = (ctypes.c_char_p * len(labels))(*[l.encode() for l in labels])
    n = lib.hicio_parse_valid_chunk(
        buf, len(buf), arr, len(labels),
        c1.ctypes.data_as(ctypes.c_void_p), p1.ctypes.data_as(ctypes.c_void_p),
        c2.ctypes.data_as(ctypes.c_void_p), p2.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    return c1[:n], p1[:n], c2[:n], p2[:n]


def _py_key6(line: str):
    f = line.split("\t")
    return (f[1], int(f[2]), int(f[3]), f[8], int(f[9]), int(f[10]))


def sort_file(in_path: str, out_path: str, mode: str = "name") -> None:
    lib = get_lib()
    if lib is not None:
        rc = lib.hicio_sort_file(in_path.encode(), out_path.encode(),
                                 _MODES[mode])
        if rc == 0:
            return
        log.warning("hicio_sort_file rc=%d; Python fallback", rc)
    with open(in_path) as f:
        # normalize like the native getline path: a truncated final line
        # without its newline would otherwise concatenate with the next
        # record in the sorted output
        lines = [ln if ln.endswith("\n") else ln + "\n" for ln in f]
    if mode == "name":
        lines.sort()
    else:
        lines.sort(key=_py_key6)
    with open(out_path, "w") as f:
        f.writelines(lines)


def merge_sorted(paths: Sequence[str], out_path: str,
                 mode: str = "name") -> None:
    for p in paths:
        if not os.path.exists(p):
            # the native merge treats an unopenable stream as EMPTY and
            # would silently drop that run's records
            raise FileNotFoundError(p)
    lib = get_lib()
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        rc = lib.hicio_merge_sorted(arr, len(paths), out_path.encode(),
                                    _MODES[mode])
        if rc == 0:
            return
    import heapq

    key = (lambda l: l) if mode == "name" else _py_key6
    files = [open(p) for p in paths]
    with open(out_path, "w") as out:
        for line in heapq.merge(*files, key=key):
            out.write(line if line.endswith("\n") else line + "\n")
    for f in files:
        f.close()


def sam_sort_merge(paths: Sequence[str], out_path: str) -> None:
    """Merge SAM bodies from several files (headers dropped), globally
    name-sorted, stable in (file, line) order — the ``samtools merge -n``
    analogue (bamProcess.py:730,1498).  External-memory in the native
    path; the Python fallback sorts in memory."""
    lib = get_lib()
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        rc = lib.hicio_sam_sort_merge(arr, len(paths), out_path.encode())
        if rc == 0:
            return
        log.warning("hicio_sam_sort_merge rc=%d; Python fallback", rc)
    lines: List[str] = []
    for p in paths:
        with open(p) as f:
            lines.extend((l if l.endswith("\n") else l + "\n")
                         for l in f if l and l[0] != "@")
    lines.sort(key=lambda l: l.split("\t", 1)[0])
    with open(out_path, "w") as out:
        out.writelines(lines)


def count_lines(path: str) -> int:
    lib = get_lib()
    if lib is not None:
        n = lib.hicio_count_lines(path.encode())
        if n >= 0:
            return int(n)
    with open(path) as f:
        return sum(1 for _ in f)
