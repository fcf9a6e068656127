"""Minimal HDF5 files without h5py (numpy and the standard library only).

The HDF5 counterpart of io/zarr_min.py. Where h5py is not installed,
io/writers.hdf5_backend() returns this module, which reads and writes the
part of the HDF5 format that h5py writes by default (libver "earliest"),
through the part of h5py's API that the port calls:

  * superblock version 0 or 1, 8-byte offsets and lengths, no user block;
  * symbol-table groups (a v1 B-tree of symbol-table nodes over a local
    heap), nested to any depth;
  * version 1 object headers, continuation blocks included;
  * datasets of little-endian integers, IEEE floats or h5py's complex
    compound {r, i}, in a contiguous layout (captures) or a chunked one
    indexed by a v1 B-tree (map stacks); a chunk missing from the B-tree
    reads as the fill value, and chunks filtered by deflate (filter 1) or
    shuffle (filter 2) are decoded on read;
  * attributes holding a numeric scalar or a 1-D numeric array.

Files written here have that same layout, so h5py opens them. A chunked
dataset allocates every chunk and writes its B-tree when it is created;
a write is then one pwrite a chunk, and an attribute update rewrites its
bytes in place. ``resize``, and writes into chunks missing from the B-tree
(h5py allocates chunks lazily), allocate at the end of the file; the next
``flush`` writes a fresh B-tree there and points the layout message at it
(the old tree stays as dead space). The superblock's end-of-file address
equals the file's size after every ``flush`` and ``close``.

Whatever else a file holds raises UnsupportedHDF5 naming the feature
(superblock v2/v3, v2 object headers, the newer chunk indexes, new-style
groups, other filters, big-endian or other datatypes): nothing is read
wrong silently. Reads are ``os.preadv`` calls on one descriptor, so a
background thread may read while the caller computes; ``read_direct``
reads a contiguous dataset's bytes straight into the caller's array.
"""

from __future__ import annotations

import itertools
import math
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = (1 << 64) - 1
_FREE_NULL = 1          # a local heap's empty free list
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32   # the v0 superblock's B-tree Ks
_ATTR_ROOM = 256        # NIL bytes a new dataset header keeps for attributes
_ALIGN = 8

# object header message types
_NIL, _SPACE, _LINFO, _DTYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _FILTERS, _ATTR, _CONT, _STAB = 0x6, 0x8, 0xB, 0xC, 0x10, 0x11
_AINFO = 0x15

_FLOATS = {   # size: (sign bit, exponent bit, exponent size, mantissa, bias)
    2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
    8: (63, 52, 11, 52, 1023)}
_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
            7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}


class UnsupportedHDF5(NotImplementedError):
    """A file feature that this subset does not read, where h5py would."""

    def __init__(self, feature: str):
        super().__init__(
            f"{feature} is not supported without h5py; install h5py or "
            "rewrite the file with h5py's default libver")


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _padded(n: int) -> int:
    return n + (-n % 8)


class _Msg:
    """One header message: its type, flags, data and the data's offset."""

    def __init__(self, mtype: int, flags: int, at: int, data: bytes):
        self.type, self.flags, self.at, self.data = mtype, flags, at, data


def _encode_header(msgs, room: int) -> bytes:
    """A v1 object header of ``msgs`` [(type, flags, data)], each padded to
    8 bytes, then a NIL message of ``room`` bytes (0: none)."""
    if room:
        msgs = list(msgs) + [(_NIL, 0, bytes(room - 8))]
    body = b"".join(struct.pack("<HHB3x", t, _padded(len(d)), fl) + _pad8(d)
                    for t, fl, d in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


class _Header:
    """A version 1 object header, its continuation blocks followed."""

    def __init__(self, f: "File", addr: int):
        self.file, self.addr = f, addr
        pre = f._read(addr, 16)
        if pre[:4] == b"OHDR":
            raise UnsupportedHDF5("a version 2 object header")
        if pre[0] != 1:
            raise UnsupportedHDF5(f"object header version {pre[0]}")
        self.nmsg, _refs, size = struct.unpack_from("<HII", pre, 2)
        self.msgs: list[_Msg] = []
        blocks = [(addr + 16, size)]
        while blocks:
            start, length = blocks.pop(0)
            buf = f._read(start, length)
            p = 0
            while p + 8 <= length:
                mtype, n, flags = struct.unpack_from("<HHB", buf, p)
                self.msgs.append(_Msg(mtype, flags, start + p + 8,
                                      bytes(buf[p + 8:p + 8 + n])))
                if mtype == _CONT:
                    blocks.append(struct.unpack_from("<QQ", buf, p + 8))
                p += 8 + n

    def find(self, mtype: int) -> list[_Msg]:
        return [m for m in self.msgs if m.type == mtype]

    def add(self, mtype: int, data: bytes) -> _Msg:
        """Write a message into a NIL message that has room for it."""
        data = _pad8(data)
        for i, m in enumerate(self.msgs):
            rest = len(m.data) - len(data)
            if m.type != _NIL or not (rest == 0 or rest >= 8):
                continue
            blob = struct.pack("<HHB3x", mtype, len(data), 0) + data
            new = [_Msg(mtype, 0, m.at, data)]
            if rest:
                blob += struct.pack("<HHB3x", _NIL, rest - 8, 0)
                new.append(_Msg(_NIL, 0, m.at + len(data) + 8,
                                bytes(rest - 8)))
                self.nmsg += 1
                self.file._write(self.addr + 2, struct.pack("<H", self.nmsg))
            self.file._write(m.at - 8, blob)
            self.msgs[i:i + 1] = new
            return new[0]
        raise NotImplementedError(
            f"hdf5_min: no room left in the object header at {self.addr} "
            "for a new message (h5py would add a continuation block)")

    def remove(self, m: _Msg) -> None:
        self.file._write(m.at - 8, struct.pack("<H", _NIL))
        m.type = _NIL


# -- datatypes and dataspaces -------------------------------------------------

def _encode_dtype(dt) -> bytes:
    dt = np.dtype(dt)
    if dt.kind == "c" and dt.itemsize in (8, 16):
        half = _encode_dtype(np.dtype(f"<f{dt.itemsize // 2}"))
        members = b"".join(
            _pad8(name + b"\0") + struct.pack("<IB3xI4x16x", off, 0, 0) + half
            for name, off in ((b"r", 0), (b"i", dt.itemsize // 2)))
        return struct.pack("<BHxI", 0x16, 2, dt.itemsize) + members
    if dt.kind == "f" and dt.itemsize in _FLOATS:
        sign, eloc, esize, msize, bias = _FLOATS[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, dt.itemsize,
                           0, 8 * dt.itemsize, eloc, esize, 0, msize, bias)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    raise NotImplementedError(f"hdf5_min writes no {dt} data (h5py does)")


def _decode_dtype(buf, p: int = 0):
    """(numpy dtype, bytes used) of the datatype message at ``buf[p:]``."""
    cv, b0, b1, _b2, size = struct.unpack_from("<BBBBI", buf, p)
    cls, ver = cv & 0x0F, cv >> 4
    if cls in (0, 1) and b0 & 1:
        raise UnsupportedHDF5("a big-endian datatype")
    if cls == 0:
        off, prec = struct.unpack_from("<HH", buf, p + 8)
        if size not in (1, 2, 4, 8) or off or prec != 8 * size:
            raise UnsupportedHDF5(f"a {prec}-bit integer at bit {off} of "
                                  f"{size} bytes")
        return np.dtype(f"<{'i' if b0 & 8 else 'u'}{size}"), 12
    if cls == 1:
        props = struct.unpack_from("<HHBBBBI", buf, p + 8)
        layout = _FLOATS.get(size)
        if (layout is None or b1 != layout[0] or (b0 & 0x30) != 0x20
                or props != (0, 8 * size, layout[1], layout[2], 0, layout[3],
                             layout[4])):
            raise UnsupportedHDF5(f"a non-IEEE {size}-byte float")
        return np.dtype(f"<f{size}"), 20
    if cls == 6:
        q, members = p + 8, []
        for _ in range(b0 | b1 << 8):
            if ver != 1:
                raise UnsupportedHDF5(f"compound datatype version {ver}")
            end = buf.index(b"\0", q)
            name = bytes(buf[q:end]).decode()
            q += _padded(end - q + 1)
            off = struct.unpack_from("<I", buf, q)[0]
            if buf[q + 4]:
                raise UnsupportedHDF5("an array member of a compound")
            q += 32
            mdt, used = _decode_dtype(buf, q)
            q += used
            members.append((name, off, mdt))
        if (size in (8, 16) and [m[0] for m in members] == ["r", "i"]
                and [m[1] for m in members] == [0, size // 2]
                and members[0][2] == members[1][2] == np.dtype(
                    f"<f{size // 2}")):
            return np.dtype(f"<c{size}"), q - p
        raise UnsupportedHDF5("a compound datatype other than h5py's "
                              "complex {r, i}")
    raise UnsupportedHDF5(f"datatype class {cls} "
                          f"({_CLASSES.get(cls, 'unknown')})")


def _encode_space(shape, maxshape=None) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is None:
        return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + dims
    return (struct.pack("<BBBB4x", 1, len(shape), 1, 0) + dims + struct.pack(
        f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape)))


def _decode_space(data):
    """(dims, maxdims with None for unlimited, offset of dims in data)."""
    ver, rank, flags = data[0], data[1], data[2]
    if ver == 1:
        p = 8
    elif ver == 2:
        if data[3] == 2:
            raise UnsupportedHDF5("a null dataspace")
        p = 4
    else:
        raise UnsupportedHDF5(f"dataspace version {ver}")
    dims = struct.unpack_from(f"<{rank}Q", data, p)
    maxd = (struct.unpack_from(f"<{rank}Q", data, p + 8 * rank)
            if flags & 1 else dims)
    return dims, tuple(None if m == UNDEF else m for m in maxd), p


def _normalize(key, shape):
    """Basic indexing as [(start, step, count, is_int)] per axis."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = (key[:i] + (slice(None),) * (len(shape) - len(key) + 1)
               + key[i + 1:])
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for {len(shape)} dimensions")
    key = key + (slice(None),) * (len(shape) - len(key))
    sel = []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("step must be >= 1")
            sel.append((start, step, len(range(start, stop, step)), False))
        elif isinstance(k, (int, np.integer)) and not isinstance(k, bool):
            i = int(k) + n if k < 0 else int(k)
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for {n}")
            sel.append((i, 1, 1, True))
        else:
            raise TypeError("hdf5_min reads and writes basic slices only, "
                            f"not {type(k).__name__}")
    return sel


def _chunk_parts(sel, chunks):
    """(chunk index, slices in the chunk, slices in the selection) of every
    chunk that the selection touches."""
    ranges = [range(s // c, (s + (n - 1) * st) // c + 1) if n else range(0)
              for (s, st, n, _), c in zip(sel, chunks)]
    for idx in itertools.product(*ranges):
        src, dst = [], []
        for (s, st, n, _), c, i in zip(sel, chunks, idx):
            lo = i * c
            k0 = max(0, -(-(lo - s) // st))
            k1 = min(n, -(-(lo + c - s) // st))
            if k0 >= k1:
                break
            src.append(slice(s + k0 * st - lo, s + (k1 - 1) * st - lo + 1, st))
            dst.append(slice(k0, k1))
        else:
            yield idx, tuple(src), tuple(dst)


# -- attributes ---------------------------------------------------------------

def _attr_parts(data):
    """(name, datatype, dataspace, offset of the value) of an attribute
    message's data."""
    ver = data[0]
    nlen, tlen, slen = struct.unpack_from("<HHH", data, 2)
    if ver == 1:
        p, pad = 8, _padded
    elif ver in (2, 3):
        if data[1] & 3:
            raise UnsupportedHDF5("an attribute with a shared datatype")
        p, pad = (8 if ver == 2 else 9), int
    else:
        raise UnsupportedHDF5(f"attribute message version {ver}")
    name = bytes(data[p:p + nlen - 1]).decode()
    p += pad(nlen)
    dt = data[p:p + tlen]
    p += pad(tlen)
    sp = data[p:p + slen]
    return name, dt, sp, p + pad(slen)


def _encode_attr(name: str, arr: np.ndarray) -> bytes:
    nm = name.encode() + b"\0"
    dt = _encode_dtype(arr.dtype)
    sp = _encode_space(arr.shape)
    return (struct.pack("<BxHHH", 1, len(nm), len(dt), len(sp))
            + _pad8(nm) + _pad8(dt) + _pad8(sp) + arr.tobytes())


class AttributeManager:
    """The ``.attrs`` of a group or dataset: each item is stored in its
    object header as it is set."""

    def __init__(self, obj):
        self._obj = obj

    def _messages(self):
        h = self._obj._header
        for m in h.find(_AINFO):
            fheap = struct.unpack_from("<Q", m.data, 2 + (2 if m.data[1] & 1
                                                          else 0))[0]
            if fheap != UNDEF:
                raise UnsupportedHDF5("dense attribute storage")
        return {_attr_parts(m.data)[0]: m for m in h.find(_ATTR)}

    def __getitem__(self, name: str):
        m = self._messages().get(name)
        if m is None:
            raise KeyError(f"no attribute {name!r}")
        _, dt, sp, voff = _attr_parts(m.data)
        dtype, _ = _decode_dtype(dt)
        dims, _, _ = _decode_space(sp)
        n = math.prod(dims)
        val = np.frombuffer(m.data, dtype, n, voff).reshape(dims).copy()
        return val[()] if not dims else val

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def __setitem__(self, name: str, value) -> None:
        self._obj.file._check_writable()
        arr = np.asarray(value)
        if arr.dtype.kind not in "iufc" or arr.ndim > 1:
            raise NotImplementedError(
                "hdf5_min writes attributes of a numeric scalar or a 1-D "
                f"numeric array only, not {arr.dtype} of shape {arr.shape}")
        arr = arr.astype(arr.dtype.newbyteorder("<"))
        data = _encode_attr(name, arr)
        h = self._obj._header
        old = self._messages().get(name)
        if old is not None:
            voff = _attr_parts(data)[3]
            if (len(old.data) == _padded(len(data))
                    and old.data[:voff] == data[:voff]):
                self._obj.file._write(old.at + voff, data[voff:])
                old.data = data[:voff] + _pad8(data[voff:])
                return
            h.remove(old)
        h.add(_ATTR, data)

    def keys(self):
        return list(self._messages())

    def __iter__(self):
        return iter(self.keys())


# -- groups and datasets ------------------------------------------------------

class Group:
    """A symbol-table group: ``g[path]``, ``create_group``,
    ``create_dataset``, ``keys()``, ``attrs``."""

    def __init__(self, f: "File", addr: int, name: str,
                 header: _Header | None = None):
        self.file, self.name = f, name
        self._header = header or _Header(f, addr)
        stab = self._header.find(_STAB)
        if not stab:
            if self._header.find(_LINFO) or self._header.find(_LINK):
                raise UnsupportedHDF5("a new-style group (compact or dense "
                                      "link storage)")
            raise OSError(f"{name}: object header holds no group")
        self._stab = stab[0]
        self._links = None      # name -> [header address, cache, scratch]
        self._children = {}
        self.attrs = AttributeManager(self)

    # reading
    def _links_map(self) -> dict:
        if self._links is None:
            self._links = {}
            btree, heap = struct.unpack_from("<QQ", self._stab.data)
            hh = self.file._read(heap, 32)
            if hh[:4] != b"HEAP":
                raise OSError(f"{self.name}: bad local heap at {heap}")
            dsize, _free, daddr = struct.unpack_from("<QQQ", hh, 8)
            names = self.file._read(daddr, dsize)
            for snod in self._snods(btree):
                buf = self.file._read(snod, 8 + 2 * self.file._leaf_k * 40)
                if buf[:4] != b"SNOD":
                    raise OSError(f"{self.name}: bad symbol node at {snod}")
                for i in range(struct.unpack_from("<H", buf, 6)[0]):
                    e = 8 + 40 * i
                    off, oh, cache = struct.unpack_from("<QQI", buf, e)
                    nm = bytes(names[off:names.index(b"\0", off)]).decode()
                    self._links[nm] = [oh, cache, bytes(buf[e + 24:e + 40])]
        return self._links

    def _snods(self, addr: int):
        node = self.file._read(addr, 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise OSError(f"{self.name}: bad group B-tree node at {addr}")
        level, n = node[5], struct.unpack_from("<H", node, 6)[0]
        body = self.file._read(addr + 24, 16 * n + 8)
        for i in range(n):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level:
                yield from self._snods(child)
            else:
                yield child

    def _child(self, name: str):
        if name not in self._children:
            links = self._links_map()
            if name not in links:
                raise KeyError(f"{name!r} not found in {self.name}")
            h = _Header(self.file, links[name][0])
            path = self.name.rstrip("/") + "/" + name
            cls = Dataset if h.find(_LAYOUT) else Group
            self._children[name] = cls(self.file, links[name][0], path, h)
        return self._children[name]

    def __getitem__(self, path: str):
        obj = self.file if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group):
                raise KeyError(f"{path!r}: {obj.name} is not a group")
            obj = obj._child(part)
        return obj

    def keys(self):
        return sorted(self._links_map())

    # writing
    def _parent_of(self, path: str):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"bad name {path!r}")
        g = self.file if path.startswith("/") else self
        for part in parts[:-1]:
            g = g._child(part) if part in g._links_map() else \
                g.create_group(part)
            if not isinstance(g, Group):
                raise ValueError(f"{g.name} is not a group")
        if parts[-1] in g._links_map():
            raise ValueError(f"name already exists: {path!r}")
        return g, parts[-1]

    def _link(self, name: str, obj) -> None:
        self._links_map()[name] = [obj._header.addr, 0, bytes(16)]
        self._children[name] = obj
        self.file._dirty_groups.add(self)

    def create_group(self, name: str) -> "Group":
        self.file._check_writable()
        parent, leaf = self._parent_of(name)
        addr = self.file._append(_encode_header([(_STAB, 0, bytes(16))], 0))
        g = Group(self.file, addr, parent.name.rstrip("/") + "/" + leaf)
        g._links = {}
        parent._link(leaf, g)
        return g

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       chunks=None, maxshape=None, **kwds) -> "Dataset":
        """h5py's create_dataset without filters or fill values: a
        contiguous dataset, or a chunked one when ``chunks`` is given (it
        must be, with ``maxshape``; None in maxshape is unlimited)."""
        self.file._check_writable()
        if kwds:
            raise NotImplementedError(f"hdf5_min writes no {sorted(kwds)} "
                                      "(h5py does)")
        if data is not None:
            data = np.asarray(data, dtype)
            shape = data.shape if shape is None else shape
        dtype = np.dtype(data.dtype if data is not None
                         else "f4" if dtype is None else dtype)
        shape = tuple(int(n) for n in shape)
        if chunks is None and maxshape is not None or chunks is True:
            raise NotImplementedError("hdf5_min does not guess chunks: give "
                                      "chunks= with maxshape=")
        parent, leaf = self._parent_of(name)
        maxshape = shape if maxshape is None else tuple(
            None if m is None else int(m) for m in maxshape)
        space = _encode_space(shape, maxshape)
        nbytes = math.prod(shape) * dtype.itemsize
        f = self.file
        if chunks is None:
            alloc = 2                                  # late, as h5py's
            layout = struct.pack("<BBQQ", 3, 1, f._alloc(nbytes), nbytes)
        else:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(shape) or min(chunks, default=1) < 1:
                raise ValueError(f"chunks {chunks} for shape {shape}")
            alloc = 3                                  # incremental
            layout = struct.pack(f"<BBBQ{len(chunks) + 1}I", 3, 2,
                                 len(chunks) + 1, UNDEF, *chunks,
                                 dtype.itemsize)
        fill = struct.pack("<BBBBI", 2, alloc, 2, 1, 0)
        addr = f._append(_encode_header(
            [(_SPACE, 0, space), (_DTYPE, 1, _encode_dtype(dtype)),
             (_FILL, 1, fill), (_LAYOUT, 0, layout)], _ATTR_ROOM))
        ds = Dataset(f, addr, parent.name.rstrip("/") + "/" + leaf)
        if chunks is not None:
            ds._allocate(itertools.product(*map(range, ds._grid())))
            ds._write_tree()
        parent._link(leaf, ds)
        if data is not None:
            ds[...] = data
        return ds

    def _write_links(self) -> None:
        """Write this group's local heap, symbol nodes and B-tree at the
        end of the file and point its symbol-table message at them."""
        f = self.file
        links = self._links_map()
        names = sorted(links, key=str.encode)
        per = 2 * f._leaf_k
        if len(names) > per * 2 * f._group_k:
            raise NotImplementedError(f"hdf5_min writes groups of at most "
                                      f"{per * 2 * f._group_k} links")
        heap, offs = bytearray(8), {}
        for nm in names:
            offs[nm] = len(heap)
            heap += _pad8(nm.encode() + b"\0")
        heap_addr = f._alloc(32 + len(heap))
        f._write(heap_addr, b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap), _FREE_NULL, heap_addr + 32) + heap)
        snods, keys = [], [0]
        for i in range(0, len(names), per):
            entries = b""
            for nm in names[i:i + per]:
                addr, cache, scratch = links[nm]
                child = self._children.get(nm)
                if isinstance(child, Group):
                    cache, scratch = 1, child._stab.data[:16]
                entries += struct.pack("<QQI4x16s", offs[nm], addr, cache,
                                       scratch)
            snods.append(f._append(b"SNOD" + struct.pack(
                "<BxH", 1, len(names[i:i + per])) + entries
                + bytes(40 * per - len(entries))))
            keys.append(offs[names[min(i + per, len(names)) - 1]])
        body = b"".join(struct.pack("<QQ", k, c)
                        for k, c in zip(keys, snods)) + struct.pack(
                            "<Q", keys[-1])
        size = 24 + (4 * f._group_k + 1) * 8
        btree = f._append(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods),
                                                UNDEF, UNDEF) + body
                          + bytes(size - 24 - len(body)))
        stab = struct.pack("<QQ", btree, heap_addr)
        f._write(self._stab.at, stab)
        self._stab.data = stab


class Dataset:
    """A contiguous or chunked dataset: ``.shape``, ``.dtype``,
    ``.chunks``, ``.maxshape``, ``len()``, basic slicing to read and write,
    ``read_direct``, ``resize``, ``attrs``."""

    def __init__(self, f: "File", addr: int, name: str,
                 header: _Header | None = None):
        self.file, self.name = f, name
        h = self._header = header or _Header(f, addr)
        for m in h.msgs:
            if m.flags & 2 and m.type in (_DTYPE, _SPACE, _FILL, _FILTERS):
                raise UnsupportedHDF5("a shared (committed) message")
        space, dtype, layout = (h.find(t) for t in (_SPACE, _DTYPE, _LAYOUT))
        self.dtype = _decode_dtype(dtype[0].data)[0]
        dims, self.maxshape, p = _decode_space(space[0].data)
        self.shape = tuple(dims)
        self._dims_at = space[0].at + p
        self._layout = layout[0]
        self.fillvalue = self._fill()
        self._filters = self._pipeline()
        lay = self._layout.data
        if lay[0] != 3:
            raise UnsupportedHDF5(
                f"layout message version {lay[0]}" + (
                    " (the newer chunk indexes)" if lay[0] == 4 else ""))
        if lay[1] == 1:
            self.chunks = None
            self._addr = struct.unpack_from("<Q", lay, 2)[0]
        elif lay[1] == 2:
            nd = lay[2]
            self._btree = struct.unpack_from("<Q", lay, 3)[0]
            self.chunks = struct.unpack_from(f"<{nd - 1}I", lay, 11)
            self._chunk_bytes = math.prod(self.chunks) * self.dtype.itemsize
            self._index = self._read_tree()
            self._tree_dirty = False
        else:
            raise UnsupportedHDF5({0: "the compact layout",
                                   3: "the virtual layout"}.get(
                                       lay[1], f"layout class {lay[1]}"))
        self.attrs = AttributeManager(self)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]

    def _fill(self):
        value = b""
        for m in self._header.find(_FILL):
            d = m.data
            if d[0] in (1, 2) and (d[0] == 1 or d[3]):
                n = struct.unpack_from("<I", d, 4)[0]
                value = d[8:8 + n]
            elif d[0] == 3 and d[1] & 0x20:
                n = struct.unpack_from("<I", d, 2)[0]
                value = d[6:6 + n]
        if not value:
            for m in self._header.find(_FILL_OLD):
                n = struct.unpack_from("<I", m.data)[0]
                value = m.data[4:4 + n]
        if not value:
            return self.dtype.type(0)
        if len(value) != self.dtype.itemsize:
            raise UnsupportedHDF5(f"a {len(value)}-byte fill value for "
                                  f"{self.dtype}")
        return np.frombuffer(value, self.dtype)[0]

    def _pipeline(self):
        filters = []
        for m in self._header.find(_FILTERS):
            d = m.data
            ver, p = d[0], (8 if d[0] == 1 else 2)
            for _ in range(d[1]):
                fid = struct.unpack_from("<H", d, p)[0]
                if ver == 1 or fid >= 256:
                    namelen = struct.unpack_from("<H", d, p + 2)[0]
                    p += 4
                else:
                    namelen, p = 0, p + 2
                nvals = struct.unpack_from("<H", d, p + 2)[0]
                p += 4 + (_padded(namelen) if ver == 1 else namelen)
                vals = struct.unpack_from(f"<{nvals}I", d, p)
                p += 4 * nvals + (4 if ver == 1 and nvals % 2 else 0)
                if fid not in (1, 2):
                    raise UnsupportedHDF5(
                        f"filter {fid} "
                        f"({_FILTER_NAMES.get(fid, 'unregistered')})")
                filters.append((fid, vals))
        return filters

    # chunk index
    def _grid(self):
        return [-(-n // c) for n, c in zip(self.shape, self.chunks)]

    def _read_tree(self) -> dict:
        index = {}
        nd = len(self.chunks) + 1
        ksize = 8 + 8 * nd

        def walk(addr):
            hdr = self.file._read(addr, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 1:
                raise OSError(f"{self.name}: bad chunk B-tree node at {addr}")
            level, n = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
            body = self.file._read(addr + 24, n * (ksize + 8) + ksize)
            for i in range(n):
                p = i * (ksize + 8)
                nbytes, mask = struct.unpack_from("<II", body, p)
                offs = struct.unpack_from(f"<{nd}Q", body, p + 8)
                child = struct.unpack_from("<Q", body, p + ksize)[0]
                if level:
                    walk(child)
                else:
                    index[tuple(o // c for o, c in zip(offs, self.chunks))] \
                        = (child, nbytes, mask)

        if self._btree != UNDEF:
            walk(self._btree)
        return index

    def _allocate(self, idxs) -> None:
        """Allocate chunks at the end of the file, one region for all."""
        idxs = [i for i in idxs if i not in self._index]
        if idxs and self._filters:
            raise NotImplementedError("hdf5_min writes no filtered chunks "
                                      "(h5py does)")
        if idxs:
            base = self.file._alloc(len(idxs) * self._chunk_bytes)
            for k, i in enumerate(idxs):
                self._index[i] = (base + k * self._chunk_bytes,
                                  self._chunk_bytes, 0)
            self._mark_tree()

    def _mark_tree(self) -> None:
        self._tree_dirty = True
        self.file._dirty_datasets.add(self)

    def _write_tree(self) -> None:
        """A fresh v1 B-tree of every allocated chunk, as deep as it needs,
        at the end of the file; the layout message points at its root."""
        f, nd = self.file, len(self.chunks) + 1
        per = 2 * f._chunk_k
        size = 24 + (per + 1) * (8 + 8 * nd) + per * 8

        def key(idx, nbytes=0, mask=0):
            return struct.pack(f"<II{nd}Q", nbytes, mask, *(
                i * c for i, c in zip(idx, self.chunks)), 0)

        items = [(key(i, nb, mk), key(tuple(v + 1 for v in i)), a)
                 for i, (a, nb, mk) in sorted(self._index.items())]
        root, level = UNDEF, 0
        while items:
            groups = [items[i:i + per] for i in range(0, len(items), per)]
            base = f._alloc(len(groups) * size)
            nodes = []
            for j, g in enumerate(groups):
                at = base + j * size
                body = b"".join(k + struct.pack("<Q", a) for k, _, a in g)
                f._write(at, b"TREE" + struct.pack(
                    "<BBHQQ", 1, level, len(g),
                    at - size if j else UNDEF,
                    at + size if j + 1 < len(groups) else UNDEF)
                    + body + g[-1][1])
                nodes.append((g[0][0], g[-1][1], at))
            if len(nodes) == 1:
                root = nodes[0][2]
                break
            items, level = nodes, level + 1
        f._write(self._layout.at + 3, struct.pack("<Q", root))
        self._btree = root
        self._tree_dirty = False

    def _unfilter(self, raw, mask: int):
        for k in reversed(range(len(self._filters))):
            if mask >> k & 1:
                continue
            fid, vals = self._filters[k]
            if fid == 1:
                raw = zlib.decompress(raw)
            else:
                size = vals[0] if vals else self.dtype.itemsize
                n = len(raw) // size * size
                b = np.frombuffer(raw, np.uint8)
                raw = (b[:n].reshape(size, -1).T.tobytes()
                       + bytes(b[n:]))
        return raw

    def _read_chunk(self, idx) -> np.ndarray:
        entry = self._index.get(idx)
        if entry is None:
            return np.full(self.chunks, self.fillvalue, self.dtype)
        addr, nbytes, mask = entry
        raw = self.file._read(addr, nbytes)
        if self._filters:
            raw = self._unfilter(raw, mask)
        if len(raw) != self._chunk_bytes:
            raise OSError(f"{self.name}: chunk {idx} holds {len(raw)} "
                          f"bytes, not {self._chunk_bytes}")
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    # slicing
    def __getitem__(self, key):
        sel = _normalize(key, self.shape)
        out = np.empty(tuple(n for _, _, n, _ in sel), self.dtype)
        squeeze = tuple(0 if is_int else slice(None)
                        for *_, is_int in sel)
        if out.size == 0:
            return out[squeeze]
        if self.chunks is not None:
            for idx, src, dst in _chunk_parts(sel, self.chunks):
                out[dst] = self._read_chunk(idx)[src]
        elif self._addr == UNDEF:
            out[...] = self.fillvalue
        elif not sel:
            out[()] = np.frombuffer(self.file._read(
                self._addr, self.dtype.itemsize), self.dtype)[0]
        else:
            (s, st, n, _), rest = sel[0], sel[1:]
            rows = (n - 1) * st + 1
            row = math.prod(self.shape[1:]) * self.dtype.itemsize
            block = np.frombuffer(self.file._read(
                self._addr + s * row, rows * row), self.dtype).reshape(
                    (rows,) + self.shape[1:])
            out[...] = block[(slice(None, None, st),) + tuple(
                slice(a, a + (m - 1) * b + 1, b) for a, b, m, _ in rest)]
        return out[squeeze]

    def read_direct(self, dest: np.ndarray, source_sel=None,
                    dest_sel=None) -> None:
        """h5py's ``read_direct``: ``dest[dest_sel] = self[source_sel]``,
        each selection a basic index (None: all of it), ``dest`` a
        C-contiguous writeable array (else TypeError, as a selection that
        does not broadcast to ``dest[dest_sel]``). A contiguous dataset of
        ``dest``'s dtype, read over whole rows into a C-contiguous part of
        ``dest`` of the selection's shape, is read straight into that
        memory; any other read goes through ``__getitem__``."""
        if not (isinstance(dest, np.ndarray) and dest.flags.c_contiguous
                and dest.flags.writeable):
            raise TypeError("Array must be C-contiguous and writable")
        key = ... if source_sel is None else source_sel
        where = ... if dest_sel is None else dest_sel
        sel = _normalize(key, self.shape)
        shape = tuple(n for _, _, n, is_int in sel if not is_int)
        out = dest[where]
        try:
            fits = np.broadcast_shapes(shape, out.shape) == out.shape
        except ValueError:
            fits = False
        if not fits:
            raise TypeError(f"Can't broadcast {shape} -> {out.shape}")
        if self._direct(sel, shape, out, dest):
            (s, *_), row = sel[0], math.prod(self.shape[1:])
            self.file._read_into(
                self._addr + s * row * self.dtype.itemsize,
                memoryview(out.reshape(-1).view(np.uint8)))
        else:
            dest[where] = self[key]

    def _direct(self, sel, shape, out: np.ndarray, dest: np.ndarray) -> bool:
        """Whether the selection ``sel`` (of ``shape``) is one run of the
        file's bytes that lands as it is stored in ``out``, a view of
        ``dest``'s memory."""
        return (self.chunks is None and self._addr != UNDEF and bool(sel)
                and out.size > 0 and out.shape == shape
                and out.dtype == self.dtype and out.flags.c_contiguous
                and (out is dest or np.may_share_memory(out, dest))
                and (sel[0][1] == 1 or sel[0][2] == 1)
                and all(a == 0 and b == 1 and m == n for (a, b, m, _), n
                        in zip(sel[1:], self.shape[1:])))

    def __array__(self, dtype=None, copy=None):
        full = self[...]
        return full if dtype is None else full.astype(dtype)

    def __setitem__(self, key, value) -> None:
        self.file._check_writable()
        sel = _normalize(key, self.shape)
        shape = tuple(n for _, _, n, _ in sel)
        squeezed = tuple(n for _, _, n, is_int in sel if not is_int)
        val = np.broadcast_to(np.asarray(value).astype(self.dtype, copy=False),
                              squeezed).reshape(shape)
        if val.size == 0:
            return
        if self.chunks is None:
            self._write_contiguous(sel, val)
            return
        for idx, src, dst in _chunk_parts(sel, self.chunks):
            whole = all(
                sl.start == 0 and sl.step == 1
                and sl.stop >= min(c, n - i * c)
                for sl, c, n, i in zip(src, self.chunks, self.shape, idx))
            if whole and all(sl.stop == c for sl, c in zip(src, self.chunks)):
                chunk = np.ascontiguousarray(val[dst])
            else:
                chunk = (np.zeros(self.chunks, self.dtype) if whole
                         else self._read_chunk(idx).copy())
                chunk[src] = val[dst]
            self._write_chunk(idx, chunk)

    def _write_chunk(self, idx, chunk: np.ndarray) -> None:
        if self._filters:
            raise NotImplementedError("hdf5_min writes no filtered chunks "
                                      "(h5py does)")
        self._allocate([idx])
        self.file._write(self._index[idx][0], chunk)

    def _write_contiguous(self, sel, val: np.ndarray) -> None:
        if self._addr == UNDEF:        # h5py allocates contiguous data late
            self._addr = self.file._alloc(self.size * self.dtype.itemsize)
            self.file._write(self._layout.at + 2,
                             struct.pack("<Q", self._addr))
        if not sel:
            self.file._write(self._addr, val)
            return
        (s, st, n, _), rest = sel[0], sel[1:]
        row = math.prod(self.shape[1:]) * self.dtype.itemsize
        if st == 1 and all(a == 0 and b == 1 and m == full for (a, b, m, _),
                           full in zip(rest, self.shape[1:])):
            self.file._write(self._addr + s * row, val)
            return
        rows = (n - 1) * st + 1                 # read, modify, write
        block = np.frombuffer(self.file._read(self._addr + s * row,
                                              rows * row), self.dtype)
        block = block.reshape((rows,) + self.shape[1:])
        block[(slice(None, None, st),) + tuple(
            slice(a, a + (m - 1) * b + 1, b) for a, b, m, _ in rest)] = val
        self.file._write(self._addr + s * row, block)

    def resize(self, size, axis: int | None = None) -> None:
        """h5py's resize: ``size`` is the new shape, or with ``axis`` the
        new length of that axis. New chunks are allocated at once."""
        self.file._check_writable()
        if self.chunks is None:
            raise TypeError("only chunked datasets can be resized")
        shape = list(self.shape)
        if axis is None:
            shape = [int(n) for n in size]
        else:
            shape[axis] = int(size)
        if len(shape) != len(self.shape) or any(
                n < 0 or (m is not None and n > m)
                for n, m in zip(shape, self.maxshape)):
            raise ValueError(f"cannot resize {self.shape} to {tuple(shape)} "
                             f"within maxshape {self.maxshape}")
        old = self._grid()
        self.shape = tuple(shape)
        grid = self._grid()
        for idx in [i for i in self._index
                    if any(v >= g for v, g in zip(i, grid))]:
            del self._index[idx]
            self._mark_tree()
        self._allocate(i for i in itertools.product(*map(range, grid))
                       if any(v >= g for v, g in zip(i, old)))
        self.file._write(self._dims_at, struct.pack(f"<{len(shape)}Q",
                                                    *shape))


class File(Group):
    """An HDF5 file: modes "r", "r+", "a" (read and write, created when
    missing) and "w" (created or truncated); a context manager, with
    ``flush`` and ``close``."""

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        if mode == "a":
            mode = "r+" if os.path.exists(path) else "w"
        flags = {"r": os.O_RDONLY, "r+": os.O_RDWR,
                 "w": os.O_RDWR | os.O_CREAT | os.O_TRUNC}.get(mode)
        if flags is None:
            raise ValueError(f"invalid mode {mode!r}")
        self.filename = path
        self.mode = "r" if mode == "r" else "r+"
        self._dirty_groups: set = set()
        self._dirty_datasets: set = set()
        self._fd = os.open(path, flags, 0o644)
        try:
            if mode in ("r", "r+"):
                root = self._open_superblock()
            else:
                root = self._new_superblock()
            super().__init__(self, root, "/")
            if mode not in ("r", "r+"):
                self._links = {}
                self._dirty_groups.add(self)
                self.flush()
        except BaseException:
            os.close(self._fd)
            self._fd = None
            raise

    def _open_superblock(self) -> int:
        head = self._read(0, 8)
        if head != SIGNATURE:
            size = os.fstat(self._fd).st_size
            at = 512
            while at + 8 <= size:
                if self._read(at, 8) == SIGNATURE:
                    raise UnsupportedHDF5("a user block before the "
                                          "superblock")
                at *= 2
            raise OSError(f"{self.filename}: not an HDF5 file (file "
                          "signature not found)")
        sb = self._read(0, 100)
        ver = sb[8]
        if ver not in (0, 1):
            raise UnsupportedHDF5(f"superblock version {ver}")
        if (sb[13], sb[14]) != (8, 8):
            raise UnsupportedHDF5(f"{sb[13]}-byte offsets and {sb[14]}-byte "
                                  "lengths")
        self._leaf_k, self._group_k = struct.unpack_from("<HH", sb, 16)
        self._chunk_k, p = _CHUNK_K, 24
        if ver == 1:
            self._chunk_k, p = struct.unpack_from("<H", sb, 24)[0], 28
        base, _free, eof, _drv = struct.unpack_from("<QQQQ", sb, p)
        if base:
            raise UnsupportedHDF5("a nonzero base address")
        self._eof_at, self._root_at = p + 16, p + 32
        size = os.fstat(self._fd).st_size
        if size < eof:
            raise OSError(f"{self.filename}: truncated file: its size "
                          f"{size} is below its end-of-file address {eof}")
        self._eof = self._stored_eof = eof
        if self.mode == "r+" and size > eof:
            os.ftruncate(self._fd, eof)
        return struct.unpack_from("<Q", sb, self._root_at + 8)[0]

    def _new_superblock(self) -> int:
        self._leaf_k, self._group_k, self._chunk_k = _LEAF_K, _GROUP_K, \
            _CHUNK_K
        self._eof_at, self._root_at = 40, 56
        self._eof, self._stored_eof = 0, None
        self._append(SIGNATURE + struct.pack(
            "<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _GROUP_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF) + bytes(40))
        root = self._append(_encode_header([(_STAB, 0, bytes(16))], 0))
        self._write(self._root_at, struct.pack("<QQI4x", 0, root, 1))
        return root

    # raw IO
    def _read(self, off: int, n: int) -> bytearray:
        out = bytearray(n)
        self._read_into(off, memoryview(out))
        return out

    def _read_into(self, off: int, view: memoryview) -> None:
        """Fill ``view`` (bytes) from the file at ``off``, one os.preadv
        after another until it is full; a read past the end raises."""
        n, got = len(view), 0
        while got < n:
            k = os.preadv(self._fd, [view[got:]], off + got)
            if k == 0:
                raise OSError(f"{self.filename}: {n} bytes at {off} run "
                              "past the end of the file")
            got += k

    def _write(self, off: int, data) -> None:
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        view, done = memoryview(data).cast("B"), 0
        while done < len(view):
            done += os.pwrite(self._fd, view[done:], off + done)

    def _alloc(self, n: int) -> int:
        """n zero bytes at the end of the file (aligned to 8 bytes)."""
        at = self._eof + (-self._eof % _ALIGN)
        self._eof = at + n
        os.ftruncate(self._fd, self._eof)
        return at

    def _append(self, data: bytes) -> int:
        at = self._alloc(len(data))
        self._write(at, data)
        return at

    def _check_writable(self) -> None:
        if self._fd is None:
            raise ValueError(f"{self.filename}: the file is closed")
        if self.mode == "r":
            raise PermissionError(f"{self.filename}: opened read-only")

    def flush(self) -> None:
        """Write what changed since the last flush: fresh chunk B-trees,
        the groups that gained links, the superblock's end-of-file."""
        if self._fd is None or self.mode == "r":
            return
        for ds in list(self._dirty_datasets):
            if ds._tree_dirty:
                ds._write_tree()
        self._dirty_datasets.clear()
        if self._dirty_groups:
            # a group caches its children's B-tree and heap: rewrite the
            # ancestors of every changed group too, the deepest first
            todo = set()
            for g in self._dirty_groups:
                parts = [p for p in g.name.split("/") if p]
                for k in range(len(parts) + 1):
                    todo.add("/" + "/".join(parts[:k]))
            for name in sorted(todo, key=lambda n: -n.count("/") - (n != "/")):
                self[name]._write_links()
            self._dirty_groups.clear()
            self._write(self._root_at + 24, self._stab.data[:16])
        if self._eof != self._stored_eof:
            self._write(self._eof_at, struct.pack("<Q", self._eof))
            self._stored_eof = self._eof

    def close(self) -> None:
        if self._fd is not None:
            try:
                self.flush()
            finally:
                os.close(self._fd)
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        # as h5py does, a file that is garbage-collected open is closed
        if getattr(self, "_fd", None) is not None:
            self.close()

    def __bool__(self) -> bool:
        return self._fd is not None
