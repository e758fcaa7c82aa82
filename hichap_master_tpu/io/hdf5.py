"""Minimal HDF5 reader and writer for the files this package writes.

Covers the subset of the format a cooler file needs: a version-0
superblock, version-1 object headers, groups indexed by a symbol table
(v1 B-tree, symbol-table nodes, local heap), contiguous datasets of
little-endian integers, floats and fixed-length strings, and attributes
holding numbers or strings (strings as variable-length UTF-8 in a global
heap).  h5py writes these same structures by default, so files from either
side read on the other.

Changes to an existing file are copy-on-write: new raw data, and the
metadata of every group on the path to a change, are appended; the
superblock is rewritten last to point at the new root.  Raw data is never
copied.  Space held by deleted objects is not reclaimed (as with h5py
without a repack).

Structures outside the subset (chunked or filtered datasets, version-2
object headers, link-message groups, newer superblocks) raise
``Unsupported``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _NODE_K = 4, 16            # library defaults: 8 links per SNOD
_SB_SIZE = 96
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
_HEAP_FREE_NULL = 1                 # local heap: "no free block"
_GCOL_MIN = 4096                    # the library reads 4 KiB collections

# object header message types
_M_NIL, _M_SPACE, _M_LINFO, _M_TYPE = 0x00, 0x01, 0x02, 0x03
_M_LINK, _M_LAYOUT, _M_FILTER, _M_ATTR = 0x06, 0x08, 0x0B, 0x0C
_M_CONT, _M_STAB = 0x10, 0x11
_UNSUPPORTED_MSGS = {_M_LINFO: "link-message group", _M_LINK: "link message",
                     _M_FILTER: "filtered dataset"}

_VLEN_STR = "vlen-str"


class Unsupported(Exception):
    """The file uses an HDF5 feature outside this module's subset."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


# ------------------------------------------------------------- datatypes
def _encode_dtype(dt: Union[np.dtype, str]) -> bytes:
    if dt == _VLEN_STR:
        # class 9, string, null-terminated, UTF-8; base type: 1-byte uint
        return (struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0x00, 16)
                + struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8))
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, dt.itemsize * 8)
    if dt == np.float64:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8, 0, 64,
                           52, 11, 0, 52, 1023)
    if dt == np.float32:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32,
                           23, 8, 0, 23, 127)
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)
    raise TypeError(f"no HDF5 encoding for dtype {dt}")


def _decode_dtype(b: bytes, off: int = 0):
    cls = b[off] & 0x0F
    bits = b[off + 1]
    size = struct.unpack_from("<I", b, off + 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    if cls == 9 and bits & 0x0F == 1:
        return _VLEN_STR
    raise Unsupported(f"HDF5 datatype class {cls}")


def _to_file_dtype(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, order="C")    # keeps 0-d scalars 0-d
    if a.dtype.kind in "iuf" and a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    _encode_dtype(a.dtype)          # raises on an unsupported dtype
    return a


# ------------------------------------------------------------ dataspaces
def _encode_space(shape: Tuple[int, ...]) -> bytes:
    if not shape:
        return struct.pack("<BBBBI", 1, 0, 0, 0, 0)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBBI", 1, len(shape), 1, 0, 0) + dims + dims


def _decode_space(b: bytes) -> Tuple[int, ...]:
    if b[0] != 1:
        raise Unsupported(f"dataspace version {b[0]}")
    return tuple(struct.unpack_from(f"<{b[1]}Q", b, 8))


# --------------------------------------------------------------- objects
class Attrs(dict):
    """Attribute dict of a group or dataset; edits mark the owner dirty."""

    def __init__(self, owner, items=()):
        super().__init__(items)
        self._owner = owner

    def __setitem__(self, key, value):
        self._owner._dirty = True
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._owner._dirty = True
        super().__delitem__(key)


class Dataset:
    """A contiguous dataset; slicing reads from the open file."""

    def __init__(self, file: "File", dtype: np.dtype, shape, addr: int,
                 hdr: Optional[int] = None, attrs=()):
        self._file = file
        self.dtype = dtype
        self.shape = tuple(shape)
        self._addr = addr
        self._hdr = hdr
        self._dirty = hdr is None
        self.attrs = Attrs(self, attrs)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of a scalar dataset")
        return self.shape[0]

    def _read(self, start: int, count: int) -> np.ndarray:
        row = self.shape[1:]
        out = np.empty((count,) + row, self.dtype)
        if out.nbytes:
            fh = self._file._fh
            fh.seek(self._addr + start * out.itemsize * int(np.prod(row)))
            if fh.readinto(out.reshape(-1).view(np.uint8)) != out.nbytes:
                raise EOFError(f"{self._file.path}: dataset truncated")
        return out

    def __getitem__(self, key):
        """``[:]``, ``[a:b]`` or ``[i]`` along the first axis."""
        n = len(self)
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            if step != 1:
                raise IndexError("strided dataset reads are not supported")
            return self._read(start, max(stop - start, 0))
        i = int(key)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"index {key} out of range for length {n}")
        return self._read(i, 1)[0]


class Group:
    """A group: named children and attributes."""

    def __init__(self, file: "File", hdr: Optional[int] = None,
                 stab: Tuple[int, int] = (_UNDEF, _UNDEF), attrs=()):
        self._file = file
        self._hdr = hdr
        self._stab = stab           # (B-tree, local heap) addresses
        self._dirty = hdr is None
        self._children: Dict[str, Union["Group", Dataset]] = {}
        self.attrs = Attrs(self, attrs)

    # ------------------------------------------------------------ lookup
    def _walk(self, path: str, create: bool = False):
        node = self._file._root if path.startswith("/") else self
        parts = [p for p in path.split("/") if p]
        for part in parts:
            if not isinstance(node, Group):
                raise KeyError(path)
            if part not in node._children:
                if not create:
                    raise KeyError(path)
                node._add(part, Group(self._file))
            node = node._children[part]
        return node

    def __getitem__(self, path: str):
        return self._walk(path)

    def __contains__(self, path: str) -> bool:
        try:
            self._walk(path)
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return list(self._children)

    # ------------------------------------------------------------- edits
    def _parent_and_name(self, path: str):
        head, _, name = path.rstrip("/").rpartition("/")
        if not name:
            raise ValueError(f"bad object name {path!r}")
        parent = self._walk(head or ("/" if path.startswith("/") else ""),
                            create=True)
        return parent, name

    def _add(self, name: str, obj) -> None:
        self._file._check_writable()
        if name in self._children:
            raise ValueError(f"object {name!r} already exists")
        self._children[name] = obj
        self._dirty = True

    def require_group(self, path: str) -> "Group":
        self._file._check_writable()
        node = self._walk(path, create=True)
        if not isinstance(node, Group):
            raise TypeError(f"{path!r} is a dataset")
        return node

    def create_group(self, path: str) -> "Group":
        parent, name = self._parent_and_name(path)
        g = Group(self._file)
        parent._add(name, g)
        return g

    def create_dataset(self, path: str, data) -> Dataset:
        parent, name = self._parent_and_name(path)
        a = _to_file_dtype(np.asarray(data))
        addr = self._file._append_raw(a)
        ds = Dataset(self._file, a.dtype, a.shape, addr)
        parent._add(name, ds)
        return ds

    def __delitem__(self, path: str) -> None:
        self._file._check_writable()
        parent, name = self._parent_and_name(path)
        if name not in parent._children:
            raise KeyError(path)
        del parent._children[name]
        parent._dirty = True


# ------------------------------------------------------------------ file
class File(Group):
    """An HDF5 file opened for reading (``"r"``), appending (``"a"``,
    created when missing) or writing anew (``"w"``)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "a", "w"):
            raise ValueError(f"mode {mode!r}")
        self.path = path
        self.mode = mode
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        if mode == "w" or (mode == "a" and not os.path.exists(path)):
            self._fh = open(path, "w+b")
            self._fh.write(b"\0" * _SB_SIZE)
            super().__init__(self)
        else:
            self._fh = open(path, "rb" if mode == "r" else "r+b")
            try:
                hdr = self._read_superblock()
                root = self._read_object(hdr)
            except BaseException:
                self._fh.close()
                raise
            if not isinstance(root, Group):
                raise Unsupported("root object is not a group")
            super().__init__(self, root._hdr, root._stab, root.attrs)
            self._children = root._children
            self._dirty = False
        self._root = self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(commit=exc_type is None)

    def close(self, commit: bool = True) -> None:
        if self._fh.closed:
            return
        try:
            if commit and self.mode != "r":
                self._commit()
        finally:
            self._fh.close()

    def _check_writable(self) -> None:
        if self.mode == "r":
            raise PermissionError(f"{self.path} is open read-only")

    # ----------------------------------------------------------- reading
    def _pread(self, addr: int, n: int) -> bytes:
        self._fh.seek(addr)
        b = self._fh.read(n)
        if len(b) != n:
            raise EOFError(f"{self.path}: read past end of file at {addr}")
        return b

    def _read_superblock(self) -> int:
        sb = self._pread(0, _SB_SIZE)
        if sb[:8] != _SIG:
            raise OSError(f"{self.path} is not an HDF5 file")
        if sb[8] != 0:
            raise Unsupported(f"superblock version {sb[8]}")
        if sb[13] != 8 or sb[14] != 8:
            raise Unsupported("offset/length sizes other than 8 bytes")
        if struct.unpack_from("<Q", sb, 24)[0] != 0:
            raise Unsupported("non-zero base address")
        return struct.unpack_from("<Q", sb, 56 + 8)[0]

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        head = self._pread(addr, 16)
        if head[:4] == b"OHDR":
            raise Unsupported("version-2 object header")
        version, _, nmsgs, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise Unsupported(f"object header version {version}")
        chunks, out = [(addr + 16, size)], []
        while chunks and len(out) < nmsgs:
            caddr, csize = chunks.pop(0)
            buf, p = self._pread(caddr, csize), 0
            while p + 8 <= csize and len(out) < nmsgs:
                mtype, msize = struct.unpack_from("<HH", buf, p)
                data = buf[p + 8:p + 8 + msize]
                if mtype == _M_CONT:
                    chunks.append(struct.unpack_from("<QQ", data))
                elif mtype in _UNSUPPORTED_MSGS:
                    raise Unsupported(_UNSUPPORTED_MSGS[mtype])
                out.append((mtype, data))
                p += 8 + msize
        return out

    def _read_object(self, addr: int):
        msgs = self._messages(addr)
        attrs = {}
        for mtype, data in msgs:
            if mtype == _M_ATTR:
                name, value = self._decode_attr(data)
                attrs[name] = value
        by_type = {t: d for t, d in msgs if t != _M_ATTR}
        if _M_STAB in by_type:
            btree, heap = struct.unpack_from("<QQ", by_type[_M_STAB])
            g = Group(self, addr, (btree, heap), attrs)
            for name, child in self._read_stab(btree, heap):
                g._children[name] = self._read_object(child)
            g._dirty = False
            return g
        if _M_LAYOUT not in by_type:
            raise Unsupported(f"object at {addr} is neither group nor dataset")
        lay = by_type[_M_LAYOUT]
        if lay[0] != 3 or lay[1] != 1:
            raise Unsupported("non-contiguous dataset layout")
        data_addr = struct.unpack_from("<Q", lay, 2)[0]
        dtype = _decode_dtype(by_type[_M_TYPE])
        if dtype == _VLEN_STR:
            raise Unsupported("variable-length string dataset")
        shape = _decode_space(by_type[_M_SPACE])
        ds = Dataset(self, dtype, shape, data_addr, addr, attrs)
        ds._dirty = False
        return ds

    def _read_stab(self, btree: int, heap: int):
        h = self._pread(heap, 32)
        if h[:4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap at {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", h, 8)
        names = self._pread(data_addr, size)
        out = []

        def walk(node: int):
            t = self._pread(node, 24)
            if t[:4] != b"TREE" or t[4] != 0:
                raise OSError(f"{self.path}: bad group B-tree at {node}")
            if t[5] != 0:
                raise Unsupported("multi-level group B-tree")
            used = struct.unpack_from("<H", t, 6)[0]
            body = self._pread(node + 24, 8 + used * 16)
            for i in range(used):
                child = struct.unpack_from("<Q", body, 8 + i * 16)[0]
                sn = self._pread(child, 8)
                if sn[:4] != b"SNOD":
                    raise OSError(f"{self.path}: bad symbol node at {child}")
                n = struct.unpack_from("<H", sn, 6)[0]
                ents = self._pread(child + 8, n * 40)
                for j in range(n):
                    noff, oh = struct.unpack_from("<QQ", ents, j * 40)
                    end = names.index(b"\0", noff)
                    out.append((names[noff:end].decode(), oh))

        walk(btree)
        return out

    def _decode_attr(self, b: bytes):
        if b[0] != 1:
            raise Unsupported(f"attribute message version {b[0]}")
        nsz, tsz, ssz = struct.unpack_from("<HHH", b, 2)
        p = 8
        name = b[p:p + nsz].rstrip(b"\0").decode()
        p += _pad8(nsz)
        dtype = _decode_dtype(b, p)
        p += _pad8(tsz)
        shape = _decode_space(b[p:p + ssz])
        p += _pad8(ssz)
        count = int(np.prod(shape)) if shape else 1
        if dtype == _VLEN_STR:
            vals = []
            for i in range(count):
                n, coll, idx = struct.unpack_from("<IQI", b, p + 16 * i)
                vals.append(self._gheap(coll)[idx][:n].decode())
            return name, vals[0] if not shape else np.array(vals, object)
        arr = np.frombuffer(b, dtype, count, p).reshape(shape)
        return name, arr[()] if not shape else arr.copy()

    def _gheap(self, addr: int) -> Dict[int, bytes]:
        if addr not in self._gheaps:
            head = self._pread(addr, 16)
            if head[:4] != b"GCOL":
                raise OSError(f"{self.path}: bad global heap at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            buf, p, objs = self._pread(addr, size), 16, {}
            while p + 16 <= size:
                idx, _, osize = struct.unpack_from("<HHxxxxQ", buf, p)
                if idx == 0:
                    break
                objs[idx] = buf[p + 16:p + 16 + osize]
                p += 16 + _pad8(osize)
            self._gheaps[addr] = objs
        return self._gheaps[addr]

    # ----------------------------------------------------------- writing
    def _append_raw(self, a: np.ndarray) -> int:
        if a.nbytes == 0:
            return _UNDEF
        end = self._fh.seek(0, 2)
        addr = _pad8(end)
        self._fh.write(b"\0" * (addr - end))
        self._fh.write(a.reshape(-1).view(np.uint8).data)
        return addr

    def _commit(self) -> None:
        def stale(node) -> bool:
            if isinstance(node, Group):
                kids = [stale(c) for c in node._children.values()]
                node._dirty = node._dirty or any(kids)
            return node._dirty

        if not stale(self):
            return
        base = _pad8(self._fh.seek(0, 2))
        out = bytearray()

        def alloc(blob: bytes) -> int:
            addr = base + len(out)
            out.extend(_padded(blob))
            return addr

        strings: List[str] = []

        def collect(node) -> None:
            if node._dirty:
                strings.extend(v for v in node.attrs.values()
                               if isinstance(v, str))
            for c in getattr(node, "_children", {}).values():
                collect(c)

        collect(self)
        str_ref: Dict[str, Tuple[int, int]] = {}
        if strings:
            objs, idx_of = bytearray(), {}
            for s in dict.fromkeys(strings):
                raw = s.encode()
                idx_of[s] = len(idx_of) + 1
                objs += struct.pack("<HHxxxxQ", idx_of[s], 0, len(raw))
                objs += _padded(raw)
            size = max(_GCOL_MIN, 16 + len(objs) + 16)
            free = size - 16 - len(objs)
            gcol = alloc(b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + objs
                         + struct.pack("<HHxxxxQ", 0, 0, free)
                         + b"\0" * (free - 16))
            str_ref = {s: (gcol, i) for s, i in idx_of.items()}

        def attr_msg(name: str, value) -> bytes:
            if isinstance(value, str):
                dt, shape = _VLEN_STR, ()
                coll, idx = str_ref[value]
                data = struct.pack("<IQI", len(value.encode()), coll, idx)
            else:
                arr = _to_file_dtype(np.asarray(value))
                if arr.dtype.kind not in "iufS":
                    raise TypeError(f"attribute {name!r}: {arr.dtype}")
                dt, shape, data = arr.dtype, arr.shape, arr.tobytes()
            nb, tb, sb = name.encode() + b"\0", _encode_dtype(dt), \
                _encode_space(shape)
            return (struct.pack("<BBHHH", 1, 0, len(nb), len(tb), len(sb))
                    + _padded(nb) + _padded(tb) + _padded(sb) + data)

        def header(msgs: List[Tuple[int, int, bytes]]) -> int:
            body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), fl)
                            + _padded(d) for t, fl, d in msgs)
            return alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                     len(body)) + body)

        def write(node) -> None:
            if not node._dirty:
                return
            attrs = [(_M_ATTR, 0, attr_msg(k, v)) for k, v in
                     node.attrs.items()]
            if isinstance(node, Dataset):
                layout = struct.pack("<BBQQ", 3, 1, node._addr,
                                     int(np.prod(node.shape))
                                     * node.dtype.itemsize)
                node._hdr = header(
                    [(_M_SPACE, 0, _encode_space(node.shape)),
                     (_M_TYPE, 1, _encode_dtype(node.dtype)),
                     (0x05, 1, struct.pack("<BBBBI", 2, 2, 2, 1, 0)),
                     (_M_LAYOUT, 0, layout)] + attrs)
            else:
                for c in node._children.values():
                    write(c)
                node._stab = write_stab(node)
                node._hdr = header(
                    [(_M_STAB, 0, struct.pack("<QQ", *node._stab))] + attrs)
            node._dirty = False

        def entry(noff: int, node) -> bytes:
            if isinstance(node, Group):
                return struct.pack("<QQIIQQ", noff, node._hdr, 1, 0,
                                   *node._stab)
            return struct.pack("<QQII16x", noff, node._hdr, 0, 0)

        def write_stab(g: Group) -> Tuple[int, int]:
            items = sorted(g._children.items(), key=lambda kv: kv[0].encode())
            heap, offs = bytearray(8), []
            for name, _ in items:
                offs.append(len(heap))
                heap += _padded(name.encode() + b"\0")
            per = 2 * _LEAF_K
            nodes = [items[i:i + per] for i in range(0, len(items), per)]
            if len(nodes) > 2 * _NODE_K:
                raise Unsupported(f"group with more than "
                                  f"{2 * _NODE_K * per} members")
            heap_addr = alloc(b"HEAP\0\0\0\0" + struct.pack(
                "<QQQ", len(heap), _HEAP_FREE_NULL, base + len(out) + 32)
                + bytes(heap))
            keys, kids = [0], []
            for k, chunk in enumerate(nodes):
                first = k * per
                ents = b"".join(entry(offs[first + j], node)
                                for j, (_, node) in enumerate(chunk))
                kids.append(alloc((b"SNOD\x01\0" + struct.pack(
                    "<H", len(chunk)) + ents).ljust(_SNOD_SIZE, b"\0")))
                keys.append(offs[first + len(chunk) - 1])
            body = struct.pack("<Q", keys[0]) + b"".join(
                struct.pack("<QQ", c, k) for c, k in zip(kids, keys[1:]))
            tree = (b"TREE\0\0" + struct.pack("<HQQ", len(kids), _UNDEF,
                                              _UNDEF) + body)
            return alloc(tree.ljust(_TREE_SIZE, b"\0")), heap_addr

        write(self)
        self._fh.seek(base)
        self._fh.write(bytes(out))
        eof = base + len(out)
        sb = (_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
              + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
              + struct.pack("<QQIIQQ", 0, self._hdr, 1, 0, *self._stab))
        self._fh.seek(0)
        self._fh.write(sb)
        self._fh.flush()
