"""A reader and a writer of the HDF5 subset the dataset files use, in NumPy
and the standard library (the machine with the card has no h5py).

What ``asr_study_tpu/data/dataset_parser.py`` writes through h5py, and what
this module reads:

- superblock version 0 (8-byte offsets and lengths);
- groups stored as symbol tables: a version-1 B-tree of symbol-table nodes
  (``SNOD``) whose names live in a local heap;
- version-1 object headers, with continuation blocks;
- datasets with contiguous or chunked storage (a version-1 B-tree index,
  no filter), layout message version 3;
- little-endian fixed-point and IEEE float32/float64 types, variable-length
  sequences and variable-length strings, whose data sit in global-heap
  collections;
- attributes in the object header (message versions 1 to 3).

Anything else is refused with :class:`H5Unsupported`, naming what was met
(a filter such as gzip, a superblock of version 2 or more as
``libver="latest"`` writes, a big-endian type, a message flagged "must
understand" that this module does not know, ...): it never returns data
it cannot vouch for.

:class:`Writer` writes superblock-0 files of the same layout: groups as
symbol tables, fixed-type datasets contiguous, variable-length datasets as
16-byte heap references with the rows in global-heap collections.  h5py
reads these files as it reads its own.  Rows can be streamed: a
variable-length row goes into the current heap collection, which is
written out once it holds about a MiB or 65,535 objects (the index is 16
bits), and a contiguous dataset can be appended to row block by row block
while nothing else is written.

Reads go through ``os.pread``, one call for a run of contiguous rows or
for one heap object, so a reader is safe to share between threads.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF

# object header message types
MSG_NIL = 0x00
MSG_DATASPACE = 0x01
MSG_LINK_INFO = 0x02
MSG_DATATYPE = 0x03
MSG_FILL_OLD = 0x04
MSG_FILL = 0x05
MSG_LINK = 0x06
MSG_EXTERNAL = 0x07
MSG_LAYOUT = 0x08
MSG_GROUP_INFO = 0x0A
MSG_FILTERS = 0x0B
MSG_ATTRIBUTE = 0x0C
MSG_COMMENT = 0x0D
MSG_MTIME_OLD = 0x0E
MSG_CONTINUATION = 0x10
MSG_SYMBOL_TABLE = 0x11
MSG_MTIME = 0x12
MSG_BTREE_K = 0x13
MSG_DRIVER_INFO = 0x14
MSG_ATTRIBUTE_INFO = 0x15
MSG_REFCOUNT = 0x16
# messages that carry nothing this reader needs
_IGNORED = {MSG_NIL, MSG_COMMENT, MSG_MTIME_OLD, MSG_MTIME, MSG_BTREE_K,
            MSG_DRIVER_INFO, MSG_REFCOUNT}
_NEW_STYLE = {MSG_LINK_INFO: "link info", MSG_LINK: "link",
              MSG_GROUP_INFO: "group info"}
FLAG_SHARED = 0x02
FLAG_MUST_UNDERSTAND = 0x80

_FILTER_NAMES = {1: "gzip (deflate)", 2: "shuffle", 3: "fletcher32",
                 4: "szip", 5: "nbit", 6: "scaleoffset", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumeration", 10: "array"}

# a variable-length element: sequence length, global heap collection
# address, object index in the collection
VLEN_REF = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
HEAP_MAX_OBJECTS = 65535         # heap object indices are 16 bits; 0 is free
HEAP_MIN_SIZE = 4096             # the library reads a collection's first 4 KiB
HEAP_TARGET = 1 << 20            # the writer starts a new collection past this
_COLLECTION_READ_WHOLE = 1 << 20


class H5Unsupported(ValueError):
    """The file uses an HDF5 feature outside the subset this module reads."""


def _align8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------

class DType:
    """A parsed datatype.

    ``kind``: ``"fixed"`` (``np_dtype`` set: integers and floats),
    ``"vlen"`` (a sequence of ``base``) or ``"vlen_str"`` (``charset``)."""

    def __init__(self, kind: str, np_dtype=None, base=None,
                 charset: int = 0):
        self.kind = kind
        self.np_dtype = np_dtype
        self.base = base
        self.charset = charset

    @property
    def is_vlen(self) -> bool:
        return self.kind in ("vlen", "vlen_str")

    @property
    def storage(self) -> np.dtype:
        """The dtype of one stored element."""
        return VLEN_REF if self.is_vlen else self.np_dtype

    def __repr__(self) -> str:
        if self.kind == "fixed":
            return f"DType({self.np_dtype})"
        if self.kind == "vlen":
            return f"DType(vlen {self.base!r})"
        return f"DType({self.kind}, charset={self.charset})"


def _parse_dtype(buf: bytes, pos: int = 0) -> Tuple[DType, int]:
    """A datatype message at ``buf[pos:]`` -> (DType, bytes used)."""
    b0 = buf[pos]
    cls, version = b0 & 0x0F, b0 >> 4
    bits = buf[pos + 1] | buf[pos + 2] << 8 | buf[pos + 3] << 16
    (size,) = struct.unpack_from("<I", buf, pos + 4)
    if version not in (1, 2, 3):
        raise H5Unsupported(f"datatype message version {version}")
    if cls == 0:                                   # fixed-point
        if bits & 1:
            raise H5Unsupported("big-endian integer type")
        off, prec = struct.unpack_from("<HH", buf, pos + 8)
        if off != 0 or prec != 8 * size or size not in (1, 2, 4, 8):
            raise H5Unsupported(f"integer of {size} bytes with bit offset "
                                f"{off} and precision {prec}")
        kind = "i" if bits & 0x08 else "u"
        return DType("fixed", np.dtype(f"<{kind}{size}")), 12
    if cls == 1:                                   # floating point
        if bits & 0x41:
            raise H5Unsupported("big-endian (or VAX-order) float type")
        props = struct.unpack_from("<HHBBBBI", buf, pos + 8)
        ieee = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
        if ieee.get(size) != props or (bits >> 8) & 0xFF != 8 * size - 1:
            raise H5Unsupported(f"float of {size} bytes that is not IEEE "
                                f"754 little-endian: {props}")
        return DType("fixed", np.dtype(f"<f{size}")), 20
    if cls == 9:                                   # variable-length
        base, used = _parse_dtype(buf, pos + 8)
        if bits & 0x0F == 1:
            return DType("vlen_str", charset=(bits >> 8) & 0x0F), 8 + used
        if bits & 0x0F != 0:
            raise H5Unsupported(f"variable-length type {bits & 0x0F}")
        if base.kind != "fixed":
            raise H5Unsupported(f"variable-length sequence of {base!r}")
        return DType("vlen", base=base), 8 + used
    raise H5Unsupported(f"datatype class {_TYPE_CLASSES.get(cls, cls)}")


def _encode_dtype(dt) -> bytes:
    """np.dtype (little-endian int or float), ``"vlen_str"`` (UTF-8) or
    ``("vlen", np.dtype)`` -> a version-1 datatype message."""
    if isinstance(dt, tuple):
        base = _encode_dtype(dt[1])
        return struct.pack("<BBBBI", 0x19, 0, 0, 0, VLEN_REF.itemsize) + base
    if isinstance(dt, str) and dt == "vlen_str":
        # a sequence of type 1 (string), null-terminated, UTF-8, over one
        # unsigned byte: what h5py writes for string_dtype("utf-8")
        char = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0,
                           VLEN_REF.itemsize) + char
    dt = np.dtype(dt)
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        exp = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * dt.itemsize - 1,
                           0, dt.itemsize, 0, 8 * dt.itemsize, exp[0], exp[1],
                           0, exp[2], exp[3])
    raise ValueError(f"the writer has no datatype for {dt}")


def _parse_dataspace(buf: bytes) -> Tuple[int, ...]:
    """-> the shape (``()`` for a scalar)."""
    version, rank, flags = buf[0], buf[1], buf[2]
    if version != 1:
        raise H5Unsupported(f"dataspace message version {version} (written "
                            "by libver='latest' or newer)")
    if flags & 0x02:
        raise H5Unsupported("dataspace with a permutation index")
    return struct.unpack_from(f"<{rank}Q", buf, 8)


def _encode_dataspace(shape: Tuple[int, ...]) -> bytes:
    """A version-1 simple dataspace (no max dims; a scalar has rank 0)."""
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(
        f"<{len(shape)}Q", *shape)


def _filter_names(buf: bytes) -> List[str]:
    version, n = buf[0], buf[1]
    pos = 8 if version == 1 else 2
    names = []
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", buf, pos)
        names.append(_FILTER_NAMES.get(fid, f"filter id {fid}"))
        if version == 1 or fid >= 256:
            name_len, _, n_vals = struct.unpack_from("<HHH", buf, pos + 2)
            name_len = _align8(name_len) if version == 1 else name_len
            pos += 8 + name_len
        else:
            _, n_vals = struct.unpack_from("<HH", buf, pos + 2)
            pos += 6
        pos += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
    return names


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Layout:
    def __init__(self, cls: str, addr: int = UNDEF, size: int = 0,
                 chunk: Tuple[int, ...] = ()):
        self.cls = cls          # "contiguous" | "chunked"
        self.addr = addr
        self.size = size        # contiguous: bytes
        self.chunk = chunk      # chunk dims, element size excluded


def _parse_layout(buf: bytes) -> _Layout:
    version, cls = buf[0], buf[1]
    if version != 3:
        raise H5Unsupported(f"data layout message version {version}; this "
                            "reader takes version 3")
    if cls == 1:
        addr, size = struct.unpack_from("<QQ", buf, 2)
        return _Layout("contiguous", addr, size)
    if cls == 2:
        rank = buf[2]
        (addr,) = struct.unpack_from("<Q", buf, 3)
        dims = struct.unpack_from(f"<{rank}I", buf, 11)
        return _Layout("chunked", addr, chunk=dims[:-1])
    raise H5Unsupported(f"data layout class {cls} "
                        f"({'compact' if cls == 0 else 'virtual'})")


def _parse_fill(buf: bytes, old: bool) -> Optional[bytes]:
    """A fill value message (``old``: the pre-1.6 one) -> the fill value's
    bytes, None when there is none (zeros)."""
    if old:
        (n,) = struct.unpack_from("<I", buf, 0)
        return bytes(buf[4: 4 + n]) if n else None
    version, defined = buf[0], buf[3]
    if version not in (1, 2):
        raise H5Unsupported(f"fill value message version {version}")
    if not defined:
        return None
    (n,) = struct.unpack_from("<I", buf, 4)
    return bytes(buf[8: 8 + n]) if n else None


class _Header:
    """The messages of one object, as (type, flags, data) in file order."""

    def __init__(self, f: "File", addr: int):
        pre = f._read(addr, 16)
        if pre[:4] == b"OHDR":
            raise H5Unsupported("version-2 object header (written by "
                                "libver='latest' or newer)")
        version, nmesgs, size = pre[0], *struct.unpack_from("<H4xI", pre, 2)
        if version != 1:
            raise H5Unsupported(f"object header version {version}")
        self.messages: List[Tuple[int, int, bytes]] = []
        chunks = [(addr + 16, size)]
        while chunks and len(self.messages) < nmesgs:
            start, length = chunks.pop(0)
            raw = f._read(start, length)
            pos = 0
            while pos + 8 <= length and len(self.messages) < nmesgs:
                mtype, msize, flags = struct.unpack_from("<HHB", raw, pos)
                data = raw[pos + 8: pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", data, 0))
                self.messages.append((mtype, flags, data))

    def get(self, mtype: int) -> Optional[bytes]:
        for t, _, d in self.messages:
            if t == mtype:
                return d
        return None


class File:
    """Read-only HDF5 file::

        with File("d.h5") as f:
            for split in f:                       # names in byte order
                grp = f[split]
                shapes = grp["shapes"][:]         # np.ndarray
                row = grp["inputs"][3]            # a vlen float32 row
                vocab = grp.attrs["vocab"]        # str
    """

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._heaps: Dict[int, Dict[int, Tuple[int, int]]] = {}
        try:
            self._size = os.fstat(self._fd).st_size
            sb = self._read(0, 96) if self._size >= 96 else b""
            if sb[:8] != SIGNATURE:
                raise H5Unsupported(
                    f"{path}: no HDF5 signature at offset 0 (a user block, "
                    "or not an HDF5 file)")
            if sb[8] != 0:
                raise H5Unsupported(
                    f"{path}: superblock version {sb[8]} (written by "
                    "libver='latest' or another newer format); this reader "
                    "takes version 0")
            if sb[13] != 8 or sb[14] != 8:
                raise H5Unsupported(f"{path}: offsets of {sb[13]} and "
                                    f"lengths of {sb[14]} bytes")
            base, _, eof, _ = struct.unpack_from("<QQQQ", sb, 24)
            if base != 0:
                raise H5Unsupported(f"{path}: base address {base}")
            if eof > self._size:
                raise H5Unsupported(f"{path}: truncated (end of file at "
                                    f"{eof}, the file has {self._size} "
                                    "bytes)")
            (root,) = struct.unpack_from("<Q", sb, 56 + 8)
            self._root = Group(self, "/", root)
        except BaseException:
            os.close(self._fd)
            raise

    # -- raw access ---------------------------------------------------------
    def _read(self, addr: int, n: int) -> bytes:
        if addr == UNDEF or addr + n > self._size:
            raise H5Unsupported(f"{self.path}: read of {n} bytes at {addr} "
                                f"past the end ({self._size})")
        out = os.pread(self._fd, n, addr)
        if len(out) != n:
            raise OSError(f"{self.path}: short read at {addr}")
        return out

    def _collection(self, addr: int) -> Dict[int, Tuple[int, int]]:
        """Global heap collection at ``addr`` -> {index: (address, size)}."""
        objs = self._heaps.get(addr)
        if objs is not None:
            return objs
        hdr = self._read(addr, 16)
        if hdr[:4] != b"GCOL" or hdr[4] != 1:
            raise H5Unsupported(f"{self.path}: no global heap collection at "
                                f"{addr}")
        (size,) = struct.unpack_from("<Q", hdr, 8)
        whole = self._read(addr, size) if size <= _COLLECTION_READ_WHOLE \
            else None
        objs = {}
        pos = 16
        while pos + 16 <= size:
            head = whole[pos: pos + 16] if whole is not None else \
                self._read(addr + pos, 16)
            idx, _, osize = struct.unpack_from("<HH4xQ", head, 0)
            if idx == 0:                 # the free space: the rest
                break
            objs[idx] = (addr + pos + 16, osize)
            pos += 16 + _align8(osize)
        self._heaps[addr] = objs
        return objs

    def _heap_object(self, addr: int, idx: int, need: int) -> bytes:
        try:
            obj_addr, size = self._collection(addr)[idx]
        except KeyError:
            raise H5Unsupported(f"{self.path}: heap collection {addr} has no "
                                f"object {idx}") from None
        if size < need:
            raise H5Unsupported(f"{self.path}: heap object {addr}:{idx} has "
                                f"{size} bytes, {need} needed")
        return self._read(obj_addr, need)

    def _object(self, name: str, addr: int):
        hdr = _Header(self, addr)
        if hdr.get(MSG_SYMBOL_TABLE) is not None:
            return Group(self, name, addr, hdr)
        if hdr.get(MSG_LAYOUT) is not None:
            return Dataset(self, name, hdr)
        for t in _NEW_STYLE:
            if hdr.get(t) is not None:
                raise H5Unsupported(
                    f"{name}: a group stored with {_NEW_STYLE[t]} messages "
                    "(libver='latest' or track_order=True); this reader "
                    "takes symbol-table groups")
        raise H5Unsupported(f"{name}: neither a symbol-table group nor a "
                            "dataset")

    # -- the root group's interface ------------------------------------------
    @property
    def attrs(self) -> dict:
        return self._root.attrs

    def __getitem__(self, name: str):
        return self._root[name]

    def __contains__(self, name: str) -> bool:
        return name in self._root

    def __iter__(self) -> Iterator[str]:
        return iter(self._root)

    def keys(self) -> List[str]:
        return self._root.keys()

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _check_messages(name: str, hdr: _Header) -> None:
    """Refuse what would change the meaning of the data this reader
    returns."""
    for mtype, flags, data in hdr.messages:
        if flags & FLAG_SHARED:
            raise H5Unsupported(f"{name}: a shared message (type {mtype})")
        if mtype == MSG_FILTERS:
            raise H5Unsupported(
                f"{name}: filter pipeline ({', '.join(_filter_names(data))})"
                "; this reader takes unfiltered data only")
        if mtype == MSG_EXTERNAL:
            raise H5Unsupported(f"{name}: data in external files")
        if mtype == MSG_ATTRIBUTE_INFO:
            raise H5Unsupported(f"{name}: dense attribute storage "
                                "(libver='latest' or many attributes)")
        known = mtype in _IGNORED or mtype in (
            MSG_DATASPACE, MSG_DATATYPE, MSG_FILL_OLD, MSG_FILL, MSG_LAYOUT,
            MSG_ATTRIBUTE, MSG_CONTINUATION, MSG_SYMBOL_TABLE)
        if not known and flags & FLAG_MUST_UNDERSTAND:
            raise H5Unsupported(f"{name}: message type {mtype} flagged "
                                "'must understand', unknown to this reader")


def _read_attrs(f: File, name: str, hdr: _Header) -> dict:
    out = {}
    for mtype, _, buf in hdr.messages:
        if mtype != MSG_ATTRIBUTE:
            continue
        version = buf[0]
        nlen, tlen, slen = struct.unpack_from("<HHH", buf, 2)
        if version == 1:
            pos = 8
            pad = _align8
        elif version in (2, 3):
            if buf[1] & 0x03:
                raise H5Unsupported(f"{name}: attribute with a shared "
                                    "datatype or dataspace")
            pos = 8 if version == 2 else 9
            pad = int
        else:
            raise H5Unsupported(f"{name}: attribute message version "
                                f"{version}")
        aname = buf[pos: pos + nlen].split(b"\0", 1)[0].decode("utf-8")
        pos += pad(nlen)
        dt, _ = _parse_dtype(buf, pos)
        pos += pad(tlen)
        shape = _parse_dataspace(buf[pos: pos + slen])
        pos += pad(slen)
        n = int(np.prod(shape, dtype=np.int64))
        raw = np.frombuffer(buf, dt.storage, count=n, offset=pos)
        vals = _decode(f, dt, raw)
        out[aname] = vals[0] if shape == () else (
            np.array(vals, dtype=object).reshape(shape) if dt.is_vlen
            else vals.reshape(shape))
    return out


def _decode(f: File, dt: DType, raw: np.ndarray):
    """Stored elements -> values: the array itself for fixed types, a list
    of arrays or strings for variable-length ones."""
    if dt.kind == "fixed":
        return raw.astype(dt.np_dtype.newbyteorder("="), copy=False)
    out = []
    base = dt.base.np_dtype if dt.kind == "vlen" else np.dtype("u1")
    for n, addr, idx in zip(raw["len"].tolist(), raw["addr"].tolist(),
                            raw["idx"].tolist()):
        data = f._heap_object(addr, idx, n * base.itemsize) if n else b""
        if dt.kind == "vlen":
            out.append(np.frombuffer(data, base).astype(
                base.newbyteorder("="), copy=True))
        else:
            out.append(data.decode("utf-8" if dt.charset == 1 else "ascii"))
    return out


class Group:
    def __init__(self, f: File, name: str, addr: int,
                 hdr: Optional[_Header] = None):
        self.file = f
        self.name = name
        hdr = hdr or _Header(f, addr)
        _check_messages(name, hdr)
        st = hdr.get(MSG_SYMBOL_TABLE)
        if st is None:
            raise H5Unsupported(f"{name}: not a symbol-table group")
        btree, heap = struct.unpack_from("<QQ", st, 0)
        self.attrs = _read_attrs(f, name, hdr)
        names = self._heap_names(heap)
        self._links: Dict[str, int] = {}
        for off, addr in self._walk(btree, names):
            self._links[names(off)] = addr

    def _heap_names(self, addr: int):
        f = self.file
        hdr = f._read(addr, 32)
        if hdr[:4] != b"HEAP":
            raise H5Unsupported(f"{self.name}: no local heap at {addr}")
        size, _, data_addr = struct.unpack_from("<QQQ", hdr, 8)
        data = f._read(data_addr, size)

        def name(off: int) -> str:
            return data[off: data.index(b"\0", off)].decode("utf-8")
        return name

    def _walk(self, addr: int, names) -> Iterator[Tuple[int, int]]:
        f = self.file
        hdr = f._read(addr, 24)
        if hdr[:4] != b"TREE" or hdr[4] != 0:
            raise H5Unsupported(f"{self.name}: no group B-tree node at "
                                f"{addr}")
        level, n = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
        body = f._read(addr + 24, 16 * n + 8)
        for i in range(n):
            (child,) = struct.unpack_from("<Q", body, 16 * i + 8)
            if level:
                yield from self._walk(child, names)
                continue
            snod = f._read(child, 8)
            if snod[:4] != b"SNOD" or snod[4] != 1:
                raise H5Unsupported(f"{self.name}: no symbol node at "
                                    f"{child}")
            (count,) = struct.unpack_from("<H", snod, 6)
            ents = f._read(child + 8, 40 * count)
            for j in range(count):
                off, obj = struct.unpack_from("<QQ", ents, 40 * j)
                yield off, obj

    def keys(self) -> List[str]:
        return sorted(self._links, key=lambda s: s.encode("utf-8"))

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, name: str) -> bool:
        head, _, rest = name.strip("/").partition("/")
        if head not in self._links:
            return False
        return not rest or rest in self[head]

    def __getitem__(self, name: str):
        head, _, rest = name.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{self.name}: no member {head!r}; has "
                           f"{self.keys()}")
        obj = self.file._object(
            self.name.rstrip("/") + "/" + head, self._links[head])
        return obj[rest] if rest else obj


class Dataset:
    """One dataset: ``shape``, ``dtype`` (a :class:`DType`), ``attrs``;
    ``ds[i]``, ``ds[a:b]`` and ``ds[:]`` read along the first axis (a
    variable-length dataset gives a list of rows, or one row for an int);
    ``ds.rows(indices)`` reads rows at any indices."""

    def __init__(self, f: File, name: str, hdr: _Header):
        self.file = f
        self.name = name
        _check_messages(name, hdr)
        dt, ds, lay = (hdr.get(MSG_DATATYPE), hdr.get(MSG_DATASPACE),
                       hdr.get(MSG_LAYOUT))
        if dt is None or ds is None:
            raise H5Unsupported(f"{name}: dataset without a datatype or "
                                "dataspace message")
        self.dtype, _ = _parse_dtype(dt)
        self.shape = _parse_dataspace(ds)
        self._item = self.dtype.storage.itemsize
        self._layout = _parse_layout(lay)
        nbytes = int(np.prod(self.shape, dtype=np.int64)) * self._item
        if (self._layout.cls == "contiguous" and self._layout.addr != UNDEF
                and self._layout.size < nbytes):
            raise H5Unsupported(f"{name}: {self._layout.size} bytes of "
                                f"storage for {nbytes} bytes of data")
        fill = hdr.get(MSG_FILL)
        self._fill = (_parse_fill(fill, False) if fill is not None else
                      _parse_fill(hdr.get(MSG_FILL_OLD), True)
                      if hdr.get(MSG_FILL_OLD) is not None else None)
        self.attrs = _read_attrs(f, name, hdr)
        self._chunks = None

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"{self.name}: a scalar has no length")
        return self.shape[0]

    @property
    def _row_elems(self) -> int:
        return int(np.prod(self.shape[1:], dtype=np.int64))

    def _filled(self, n_elems: int) -> np.ndarray:
        out = np.zeros(n_elems, self.dtype.storage)
        if self._fill is not None and any(self._fill):
            if self.dtype.is_vlen or len(self._fill) != self._item:
                raise H5Unsupported(f"{self.name}: unallocated storage with "
                                    "a fill value this reader cannot apply")
            out[:] = np.frombuffer(self._fill, self.dtype.storage)[0]
        return out

    def _raw_rows(self, a: int, b: int) -> np.ndarray:
        """Stored elements of rows [a, b) (all of a scalar), flat."""
        lay = self._layout
        per = self._row_elems if self.shape else 1
        n = (b - a) * per
        if lay.cls == "contiguous":
            if lay.addr == UNDEF:
                return self._filled(n)
            data = self.file._read(lay.addr + a * per * self._item,
                                   n * self._item) if n else b""
            return np.frombuffer(data, self.dtype.storage)
        return self._chunked_rows(a, b).reshape(-1)

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        if self._chunks is None:
            self._chunks = {}
            if self._layout.addr != UNDEF:
                self._walk_chunks(self._layout.addr)
        return self._chunks

    def _walk_chunks(self, addr: int) -> None:
        f = self.file
        rank = len(self.shape) + 1
        hdr = f._read(addr, 24)
        if hdr[:4] != b"TREE" or hdr[4] != 1:
            raise H5Unsupported(f"{self.name}: no chunk B-tree node at "
                                f"{addr}")
        level, n = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
        ksize = 8 + 8 * rank
        body = f._read(addr + 24, n * (ksize + 8) + ksize)
        for i in range(n):
            k = i * (ksize + 8)
            size, mask = struct.unpack_from("<II", body, k)
            offs = struct.unpack_from(f"<{rank}Q", body, k + 8)
            (child,) = struct.unpack_from("<Q", body, k + ksize)
            if level:
                self._walk_chunks(child)
            else:
                if mask:
                    raise H5Unsupported(f"{self.name}: a chunk with filter "
                                        f"mask {mask:#x}")
                self._chunks[tuple(offs[:-1])] = (child, size, mask)

    def _chunked_rows(self, a: int, b: int) -> np.ndarray:
        shape = self.shape
        cdims = self._layout.chunk
        if len(cdims) != len(shape):
            raise H5Unsupported(f"{self.name}: chunk rank {len(cdims)} for "
                                f"a rank-{len(shape)} dataset")
        out = np.empty((b - a,) + tuple(shape[1:]), self.dtype.storage)
        if b <= a:
            return out
        index = self._chunk_index()
        c_bytes = int(np.prod(cdims, dtype=np.int64)) * self._item
        grid = [range(0, s, c) for s, c in zip(shape[1:], cdims[1:])]
        for r0 in range((a // cdims[0]) * cdims[0], b, cdims[0]):
            for rest in np.ndindex(*[len(g) for g in grid]):
                offs = (r0,) + tuple(g[i] for g, i in zip(grid, rest))
                hit = index.get(offs)
                if hit is None:
                    chunk = self._filled(c_bytes // self._item)
                else:
                    if hit[1] != c_bytes:
                        raise H5Unsupported(f"{self.name}: chunk of "
                                            f"{hit[1]} bytes, {c_bytes} "
                                            "expected")
                    chunk = np.frombuffer(self.file._read(hit[0], c_bytes),
                                          self.dtype.storage)
                chunk = chunk.reshape(cdims)
                lo, hi = max(a, r0), min(b, r0 + cdims[0])
                src = [slice(lo - r0, hi - r0)]
                dst = [slice(lo - a, hi - a)]
                for o, c, s in zip(offs[1:], cdims[1:], shape[1:]):
                    src.append(slice(0, min(c, s - o)))
                    dst.append(slice(o, o + min(c, s - o)))
                out[tuple(dst)] = chunk[tuple(src)]
        return out

    def read(self, a: int = 0, b: Optional[int] = None):
        """Rows [a, b) (a scalar's value when the dataset is a scalar)."""
        if not self.shape:
            vals = _decode(self.file, self.dtype, self._raw_rows(0, 1))
            return vals[0]
        n = self.shape[0]
        b = n if b is None else min(b, n)
        a = min(max(a, 0), b)
        raw = self._raw_rows(a, b)
        vals = _decode(self.file, self.dtype, raw)
        if self.dtype.is_vlen:
            return vals
        return vals.reshape((b - a,) + tuple(self.shape[1:]))

    def rows(self, indices) -> list:
        """Rows at ``indices`` (any order) -> a list, one read a run of
        consecutive indices."""
        idx = np.asarray(indices, np.int64)
        order = np.argsort(idx, kind="stable")
        out: list = [None] * len(idx)
        k = 0
        while k < len(order):
            e = k
            while e + 1 < len(order) and idx[order[e + 1]] <= \
                    idx[order[e]] + 1:
                e += 1
            lo, hi = int(idx[order[k]]), int(idx[order[e]]) + 1
            vals = self.read(lo, hi)
            for j in range(k, e + 1):
                out[order[j]] = vals[int(idx[order[j]]) - lo]
            k = e + 1
        return out

    def __getitem__(self, key):
        if key is Ellipsis or key == ():
            return self.read()
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise IndexError("only unit-step slices")
            n = self.shape[0]
            a, b, _ = key.indices(n)
            return self.read(a, max(a, b))
        if isinstance(key, (int, np.integer)):
            i = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"{self.name}: row {key} of {self.shape[0]}")
            return self.read(i, i + 1)[0]
        raise IndexError(f"unsupported index {key!r}")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_align8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


# fill value messages as h5py writes them (version 2, late allocation, a
# default fill value of size 0); variable-length types write on allocation
_FILL_DEFAULT = bytes([2, 2, 2, 1, 0, 0, 0, 0])
_FILL_VLEN = bytes([2, 2, 0, 1, 0, 0, 0, 0])
_GROUP_LEAF_K = 4
_GROUP_NODE_K = 16
_SNOD_SIZE = 8 + 2 * _GROUP_LEAF_K * 40
_BTREE_SIZE = 24 + 2 * _GROUP_NODE_K * 8 + (2 * _GROUP_NODE_K + 1) * 8


class _HeapObjects:
    """Global heap objects on their way to disk, one collection at a time.

    ``add(data)`` -> a ticket; ``ref(ticket)`` -> (collection address,
    index) once the collection is written (``flush``)."""

    def __init__(self, w: "Writer"):
        self._w = w
        self._parts: List[bytes] = []
        self._bytes = 16
        self._addrs: List[int] = []   # address of each written collection
        self._count = 0               # objects in the pending collection

    def add(self, data: bytes) -> Tuple[int, int]:
        if self._count == HEAP_MAX_OBJECTS or (
                self._count and self._bytes + 16 + len(data) > HEAP_TARGET):
            self.flush()
        self._count += 1
        n = len(data)
        self._parts.append(struct.pack("<HH4xQ", self._count, 1, n) + data
                           + b"\0" * (_align8(n) - n))
        self._bytes += 16 + _align8(n)
        return len(self._addrs), self._count

    def ref(self, ticket: Tuple[int, int]) -> Tuple[int, int]:
        return self._addrs[ticket[0]], ticket[1]

    def flush(self) -> None:
        if not self._count:
            return
        size = max(HEAP_MIN_SIZE, self._bytes)
        free = size - self._bytes
        if free >= 16:
            self._parts.append(struct.pack("<HH4xQ", 0, 0, free)
                               + b"\0" * (free - 16))
        elif free:
            self._parts.append(b"\0" * free)
        data = struct.pack("<4sB3xQ", b"GCOL", 1, size) + b"".join(
            self._parts)
        self._addrs.append(self._w._append(data))
        self._parts, self._bytes, self._count = [], 16, 0


class _VlenColumn:
    """A variable-length dataset being written: its rows go to the heap as
    they come; the 16-byte references are written with the group."""

    def __init__(self, heap: _HeapObjects, kind):
        self._heap = heap
        self.kind = kind              # "vlen_str" or ("vlen", np.dtype)
        self._rows: List[Tuple[int, Optional[Tuple[int, int]]]] = []

    def append(self, value) -> None:
        if self.kind == "vlen_str":
            data = str(value).encode("utf-8")
            n = len(data)
        else:
            arr = np.ascontiguousarray(value, self.kind[1]).reshape(-1)
            data, n = arr.tobytes(), arr.size
        self._rows.append((n, self._heap.add(data) if n else None))

    def references(self) -> np.ndarray:
        out = np.zeros(len(self._rows), VLEN_REF)
        for i, (n, ticket) in enumerate(self._rows):
            if ticket is not None:
                out[i] = (n, *self._heap.ref(ticket))
        return out


class _Stream:
    """A contiguous dataset appended to block by block (nothing else may
    be written meanwhile, so its rows stay back to back)."""

    def __init__(self, w: "Writer", dtype: np.dtype, row_shape):
        self._w = w
        self.dtype = np.dtype(dtype)
        self.row_shape = tuple(row_shape)
        self.addr = UNDEF
        self.rows = 0
        self._end = None

    def append(self, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, self.dtype)
        if block.shape[1:] != self.row_shape:
            raise ValueError(f"rows of shape {block.shape[1:]}, the dataset "
                             f"takes {self.row_shape}")
        if not block.size:
            return
        if self._end is not None and self._end != self._w._pos:
            raise RuntimeError("something was written between two blocks "
                               "of a contiguous stream")
        addr = self._w._append(block.tobytes(),
                               align=self.addr == UNDEF)
        if self.addr == UNDEF:
            self.addr = addr
        self._end = self._w._pos
        self.rows += block.shape[0]


class GroupWriter:
    """One group of a :class:`Writer`; ``attrs`` may be set until
    :meth:`Writer.close`."""

    def __init__(self, w: "Writer", name: str):
        self._w = w
        self.name = name
        self.attrs: Dict[str, object] = {}
        self._members: Dict[str, object] = {}

    def _add(self, name: str, obj):
        if name in self._members:
            raise ValueError(f"{self.name}: {name!r} exists")
        self._members[name] = obj
        return obj

    def create_dataset(self, name: str, data) -> None:
        """A fixed-type dataset, written now, contiguous."""
        arr = np.ascontiguousarray(data)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        addr = self._w._append(arr.tobytes()) if arr.size else UNDEF
        self._add(name, ("fixed", arr.dtype, arr.shape, addr))

    def stream_dataset(self, name: str, dtype, row_shape) -> _Stream:
        """A contiguous dataset whose rows are appended later
        (:meth:`_Stream.append`)."""
        return self._add(name, _Stream(self._w, dtype, row_shape))

    def vlen_dataset(self, name: str, dtype=None) -> _VlenColumn:
        """A variable-length dataset: of sequences of ``dtype``, or of UTF-8
        strings when ``dtype`` is None."""
        kind = "vlen_str" if dtype is None else ("vlen", np.dtype(dtype))
        return self._add(name, _VlenColumn(self._w._heap, kind))

    def _write(self) -> int:
        """Write the members' headers and the group's structures -> the
        group's object header address (the heap is flushed)."""
        w = self._w
        w._heap.flush()
        links = {}
        for name, obj in self._members.items():
            if isinstance(obj, tuple):
                _, dt, shape, addr = obj
                nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
                msgs = [_encode_dataspace(shape), _encode_dtype(dt),
                        _FILL_DEFAULT, addr, nbytes]
            elif isinstance(obj, _Stream):
                shape = (obj.rows,) + obj.row_shape
                nbytes = int(np.prod(shape, dtype=np.int64)) * \
                    obj.dtype.itemsize
                msgs = [_encode_dataspace(shape), _encode_dtype(obj.dtype),
                        _FILL_DEFAULT, obj.addr, nbytes]
            else:
                refs = obj.references()
                addr = w._append(refs.tobytes()) if len(refs) else UNDEF
                msgs = [_encode_dataspace((len(refs),)),
                        _encode_dtype(obj.kind), _FILL_VLEN, addr,
                        refs.nbytes]
            space, dtype, fill, addr, nbytes = msgs
            # contiguous layout (version 3); h5py reads packed inputs_flat
            # contiguous as well as chunked, so the writer never chunks
            layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
            links[name] = w._append(_object_header([
                _message(MSG_DATASPACE, space),
                _message(MSG_DATATYPE, dtype, flags=0x01),
                _message(MSG_FILL, fill, flags=0x01),
                _message(MSG_LAYOUT, layout),
            ]))
        return w._group(links, self.attrs)[0]


class Writer:
    """Write a superblock-0 HDF5 file::

        with Writer("d.h5") as w:
            g = w.group("train")
            g.create_dataset("shapes", shapes)             # written now
            rows = g.vlen_dataset("inputs", np.float32)    # streamed
            for feats in extracted:
                rows.append(feats.reshape(-1))
            g.attrs["vocab"] = "abc"
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(b"\0" * 96)          # the superblock, written last
        self._pos = 96
        self._heap = _HeapObjects(self)
        self._groups: Dict[str, GroupWriter] = {}

    def _append(self, data: bytes, align: bool = True) -> int:
        if align and self._pos % 8:
            pad = 8 - self._pos % 8
            self._f.write(b"\0" * pad)
            self._pos += pad
        addr = self._pos
        self._f.write(data)
        self._pos += len(data)
        return addr

    def group(self, name: str) -> GroupWriter:
        if "/" in name or name in self._groups or not name:
            raise ValueError(f"bad or repeated group name {name!r}")
        g = self._groups[name] = GroupWriter(self, name)
        return g

    def _attribute(self, name: str, value, ticket=None) -> bytes:
        """An attribute message; a string's heap object is ``ticket``."""
        bname = name.encode("utf-8") + b"\0"
        if isinstance(value, str):
            dt = _encode_dtype("vlen_str")
            ref = np.zeros(1, VLEN_REF)
            if ticket is not None:
                ref[0] = (len(value.encode("utf-8")),
                          *self._heap.ref(ticket))
            shape, raw = (), ref.tobytes()
        else:
            arr = np.asarray(value)
            if arr.dtype.kind not in "iuf":
                raise ValueError(f"attribute {name!r}: no type for "
                                 f"{arr.dtype}")
            arr = arr.astype(arr.dtype.newbyteorder("<"))
            dt, shape, raw = _encode_dtype(arr.dtype), arr.shape, \
                arr.tobytes()
        space = _encode_dataspace(shape)
        body = struct.pack("<BBHHH", 1, 0, len(bname), len(dt), len(space))
        for part in (bname, dt, space):
            body += part + b"\0" * (_align8(len(part)) - len(part))
        return _message(MSG_ATTRIBUTE, body + raw)

    def _group(self, links: Dict[str, int], attrs: dict
               ) -> Tuple[int, int, int]:
        """Local heap, B-tree and symbol nodes for ``links`` (name ->
        object header) and the group's object header -> (its address, the
        B-tree's, the local heap's)."""
        names = sorted(links, key=lambda s: s.encode("utf-8"))
        if len(names) > 2 * _GROUP_LEAF_K * 2 * _GROUP_NODE_K:
            raise ValueError(f"{len(names)} members: more than one B-tree "
                             "node holds")
        heap = b"\0" * 8
        offs = {}
        for n in names:
            offs[n] = len(heap)
            b = n.encode("utf-8") + b"\0"
            heap += b + b"\0" * (_align8(len(b)) - len(b))
        seg = self._append(heap)
        # free list head 1: the library's "no free block" on disk
        heap_addr = self._append(struct.pack("<4sB3xQQQ", b"HEAP", 0,
                                             len(heap), 1, seg))
        leaves = [names[i: i + 2 * _GROUP_LEAF_K]
                  for i in range(0, len(names), 2 * _GROUP_LEAF_K)] or [[]]
        children = []
        for leaf in leaves:
            node = struct.pack("<4sBBH", b"SNOD", 1, 0, len(leaf))
            for n in leaf:
                node += struct.pack("<QQI4x16x", offs[n], links[n], 0)
            children.append(self._append(node.ljust(_SNOD_SIZE, b"\0")))
        tree = struct.pack("<4sBBHQQ", b"TREE", 0, 0, len(children),
                           UNDEF, UNDEF)
        tree += struct.pack("<Q", 0)
        for leaf, child in zip(leaves, children):
            tree += struct.pack("<QQ", child, offs[leaf[-1]] if leaf else 0)
        btree = self._append(tree.ljust(_BTREE_SIZE, b"\0"))
        msgs = [_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree,
                                                       heap_addr))]
        tickets = {k: self._heap.add(v.encode("utf-8"))
                   for k, v in attrs.items() if isinstance(v, str) and v}
        self._heap.flush()
        msgs += [self._attribute(k, v, tickets.get(k))
                 for k, v in attrs.items()]
        return self._append(_object_header(msgs)), btree, heap_addr

    def close(self) -> None:
        if self._f is None:
            return
        self._heap.flush()
        links = {name: g._write() for name, g in self._groups.items()}
        root, btree, heap = self._group(links, {})
        eof = self._pos
        sb = SIGNATURE + struct.pack(
            "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _GROUP_LEAF_K,
            _GROUP_NODE_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, root, 1, btree, heap)
        self._f.seek(0)
        self._f.write(sb)
        self._f.close()
        self._f = None

    def abort(self) -> None:
        """Close without finishing (the file is left invalid)."""
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()
