"""The subset of HDF5 that binarized datasets are stored in, read and written with numpy.

A binarized set is one HDF5 file: the root group holds one group per item
(named by its number), and each item group one dataset per attribute.  The
JAX package and the reference write it through ``h5py`` at libhdf5's default
``libver="earliest"`` layout, and this module reads and writes exactly that
layout, so a set written by either side loads on the other:

* superblock version 0 (version 1 is read too), 8-byte offsets and lengths;
* groups as symbol tables: a version 1 B-tree of group nodes over symbol
  table nodes (``SNOD``), the link names in a local heap;
* version 1 object headers (continuation messages are followed); of their
  messages the dataspace, the datatype and a version 3 layout are read,
  compact or contiguous; the others (fill value, modification time, ...)
  carry nothing a reader of this subset needs;
* little-endian integers and floats of 1 to 8 bytes, and numpy ``bool``,
  which h5py stores as an enum ``FALSE = 0, TRUE = 1`` over int8.

Anything outside the subset (chunked or filtered storage, strings, the
newer group and header formats, big-endian types) raises
:class:`UnsupportedHDF5`.  The writer lays each node out as libhdf5 sizes
it (a group node holds up to 32 children, a symbol table node up to 8
links), fills the nodes in name order and writes the superblock last.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF       # the undefined address
HEAP_FREE_NULL = 1               # libhdf5's "no free block" in a local heap
LEAF_K = 4                       # a symbol table node holds 2 * LEAF_K links
NODE_K = 16                      # a group B-tree node holds 2 * NODE_K children
ENTRY_SIZE = 40                  # a symbol table entry
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + 2 * NODE_K * 8 + (2 * NODE_K + 1) * 8
SUPERBLOCK_SIZE = 96

MSG_NIL, MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x0, 0x1, 0x3, 0x5
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11

# libhdf5's IEEE layouts of a float message: (size, exponent location, exponent
# size, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class UnsupportedHDF5(ValueError):
    """The file holds something outside the subset this module reads."""


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class H5Reader:
    """Read access to a file of the subset: :meth:`links` lists a group,
    :meth:`read` loads a dataset.  Both take object header addresses; the
    root group's is :attr:`root`.  Reads go through a read-only memory map
    and share no position, so threads may read at once."""

    def __init__(self, path):
        self._file = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # an empty file cannot be mapped
            self._file.close()
            raise UnsupportedHDF5(f"{path}: not an HDF5 file") from None
        b = self._buf
        if b[:8] != SIGNATURE:
            self.close()
            raise UnsupportedHDF5(f"{path}: no HDF5 superblock at offset 0")
        version, offsets, lengths = b[8], b[13], b[14]
        if version not in (0, 1) or offsets != 8 or lengths != 8:
            self.close()
            raise UnsupportedHDF5(f"{path}: superblock version {version} with {offsets}-byte "
                                  f"offsets and {lengths}-byte lengths (the subset: version 0 "
                                  "or 1, 8 and 8)")
        entry = 56 + (4 if version == 1 else 0)  # the root group's symbol table entry
        self.root = self._u64(entry + 8)

    def close(self) -> None:
        if self._buf is not None:
            self._buf.close()
            self._buf = None
        self._file.close()

    def _u64(self, at: int) -> int:
        return struct.unpack_from("<Q", self._buf, at)[0]

    def _messages(self, addr: int) -> List[Tuple[int, int, int, int]]:
        """(type, flags, data offset, data size) of each message of the
        version 1 object header at ``addr``, continuation chunks followed."""
        b = self._buf
        if b[addr] != 1:
            raise UnsupportedHDF5(f"object header version {b[addr]} at {addr} (the subset: 1)")
        count, size = struct.unpack_from("<H", b, addr + 2)[0], struct.unpack_from(
            "<I", b, addr + 8)[0]
        chunks, out, seen = [(addr + 16, size)], [], 0
        while chunks and seen < count:
            p, length = chunks.pop(0)
            end = p + length
            while p + 8 <= end and seen < count:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                seen += 1
                if mtype == MSG_CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", b, p + 8))
                elif mtype != MSG_NIL:
                    if flags & 0x2:
                        raise UnsupportedHDF5(f"shared message of type {mtype:#x} at {addr}")
                    out.append((mtype, flags, p + 8, msize))
                p += 8 + msize
        return out

    # -- groups ---------------------------------------------------------------

    def links(self, addr: int) -> Dict[str, int]:
        """The links of the group whose object header is at ``addr``: name ->
        object header address, in name order."""
        table = [m for m in self._messages(addr) if m[0] == MSG_SYMBOL_TABLE]
        if not table:
            raise UnsupportedHDF5(f"the object at {addr} is not a symbol-table group")
        btree, heap = struct.unpack_from("<QQ", self._buf, table[0][2])
        if self._buf[heap:heap + 4] != b"HEAP":
            raise UnsupportedHDF5(f"no local heap at {heap}")
        names = self._u64(heap + 24)
        out: Dict[str, int] = {}
        self._walk(btree, names, out)
        return out

    def _walk(self, addr: int, names: int, out: Dict[str, int]) -> None:
        b = self._buf
        if b[addr:addr + 4] != b"TREE" or b[addr + 4] != 0:
            raise UnsupportedHDF5(f"no group B-tree node at {addr}")
        level, used = b[addr + 5], struct.unpack_from("<H", b, addr + 6)[0]
        for i in range(used):
            child = self._u64(addr + 24 + 16 * i + 8)
            if level > 0:
                self._walk(child, names, out)
                continue
            if b[child:child + 4] != b"SNOD":
                raise UnsupportedHDF5(f"no symbol table node at {child}")
            for j in range(struct.unpack_from("<H", b, child + 6)[0]):
                name_at, header = struct.unpack_from("<QQ", b, child + 8 + ENTRY_SIZE * j)
                start = names + name_at
                out[b[start:b.find(b"\0", start)].decode("utf-8")] = header

    # -- datasets -------------------------------------------------------------

    def read(self, addr: int) -> np.ndarray:
        """The dataset whose object header is at ``addr``, as a new array."""
        shape = dtype = layout = None
        for mtype, _, d, _ in self._messages(addr):
            if mtype == MSG_DATASPACE:
                shape = self._dataspace(d)
            elif mtype == MSG_DATATYPE:
                dtype, _ = self._datatype(d)
            elif mtype == MSG_LAYOUT:
                layout = self._layout(d)
            elif mtype == MSG_FILTERS:
                raise UnsupportedHDF5(f"filtered dataset at {addr}")
        if shape is None or dtype is None or layout is None:
            raise UnsupportedHDF5(f"the object at {addr} is not a dataset")
        count = int(np.prod(shape, dtype=np.int64))
        at, size = layout
        if count == 0 or at == UNDEF:  # nothing stored: the default fill, zeros
            return np.zeros(shape, dtype)
        storage = np.dtype(np.int8) if dtype == np.bool_ else dtype
        if size < count * storage.itemsize:
            raise UnsupportedHDF5(f"dataset at {addr}: {size} bytes stored for {count} "
                                  f"values of {storage}")
        raw = np.frombuffer(self._buf, storage, count, at).reshape(shape)
        return raw.astype(bool) if dtype == np.bool_ else raw.copy()

    def _dataspace(self, d: int) -> Tuple[int, ...]:
        b = self._buf
        version, rank = b[d], b[d + 1]
        if version == 1:
            dims_at = d + 8
        elif version == 2:
            if b[d + 3] == 2:
                raise UnsupportedHDF5("null dataspace")
            dims_at = d + 4
        else:
            raise UnsupportedHDF5(f"dataspace message version {version}")
        return struct.unpack_from(f"<{rank}Q", b, dims_at)

    def _datatype(self, d: int) -> Tuple[np.dtype, int]:
        """(numpy dtype, bytes the message takes) of the datatype at ``d``."""
        b = self._buf
        cls, bits0, size = b[d] & 0x0F, b[d + 1], struct.unpack_from("<I", b, d + 4)[0]
        if cls in (0, 1) and bits0 & 0x1:
            raise UnsupportedHDF5("big-endian datatype")
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", b, d + 8)
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                raise UnsupportedHDF5(f"integer of {size} bytes, {precision} bits at {offset}")
            return np.dtype(f"<{'i' if bits0 & 0x8 else 'u'}{size}"), 12
        if cls == 1:
            _, precision, exp_at, exp_size, _, mant_size, bias = struct.unpack_from(
                "<HHBBBBI", b, d + 8)
            if size not in _IEEE or _IEEE[size] != (exp_at, exp_size, mant_size, bias) \
                    or precision != 8 * size:
                raise UnsupportedHDF5(f"float of {size} bytes outside IEEE 754")
            return np.dtype(f"<f{size}"), 20
        if cls == 8:
            members = struct.unpack_from("<H", b, d + 1)[0]
            base, base_len = self._datatype(d + 8)
            p = d + 8 + base_len
            names = []
            for _ in range(members):
                end = b.find(b"\0", p)
                names.append(b[p:end].decode("utf-8"))
                p += (end - p) // 8 * 8 + 8  # null-terminated, padded to 8 bytes
            values = np.frombuffer(self._buf, base, members, p).tolist()
            p += members * base.itemsize
            if base == np.int8 and dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
                return np.dtype(np.bool_), p - d
            raise UnsupportedHDF5(f"enum {dict(zip(names, values))} over {base}")
        raise UnsupportedHDF5(f"datatype class {cls}")

    def _layout(self, d: int) -> Tuple[int, int]:
        """(address, bytes) of a dataset's raw data."""
        b = self._buf
        version, cls = b[d], b[d + 1]
        if version != 3:
            raise UnsupportedHDF5(f"layout message version {version}")
        if cls == 0:  # compact: the data sits in the message
            return d + 4, struct.unpack_from("<H", b, d + 2)[0]
        if cls == 1:
            return struct.unpack_from("<QQ", b, d + 2)
        raise UnsupportedHDF5("chunked dataset")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += bytes(-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype(dtype: np.dtype) -> bytes:
    """The datatype message h5py writes for ``dtype``."""
    if dtype == np.bool_:
        base = _datatype(np.dtype(np.int8))
        names = b"FALSE\0\0\0TRUE\0\0\0\0"
        return struct.pack("<BHxI", 0x18, 2, 1) + base + names + b"\0\1"
    if dtype.byteorder == ">" or dtype.itemsize not in (1, 2, 4, 8) or dtype.kind not in "iuf" \
            or (dtype.kind == "f" and dtype.itemsize == 1):
        raise UnsupportedHDF5(f"dtype {dtype} is outside the subset (little-endian int, uint "
                              "or float of 1-8 bytes, bool)")
    size = dtype.itemsize
    if dtype.kind == "f":
        exp_at, exp_size, mant_size, bias = _IEEE[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                           exp_at, exp_size, 0, mant_size, bias)
    return struct.pack("<BBxxIHH", 0x10, 0x08 if dtype.kind == "i" else 0, size, 0, 8 * size)


class H5Writer:
    """Writes a file of the subset: a root group of groups of datasets.
    :meth:`add_group` writes one group with its datasets at once;
    :meth:`close` writes the root group and the superblock."""

    def __init__(self, path):
        self.path = Path(path)
        self._file = open(self.path, "wb")
        self._file.write(bytes(SUPERBLOCK_SIZE))
        self._pos = SUPERBLOCK_SIZE
        self._root: Dict[str, Tuple[int, Tuple[int, int]]] = {}

    def _put(self, data: bytes) -> int:
        addr = self._pos
        data += bytes(-len(data) % 8)
        self._file.write(data)
        self._pos += len(data)
        return addr

    def add_group(self, name: str, datasets: Dict[str, np.ndarray]) -> None:
        if name in self._root:
            raise ValueError(f"group {name!r} is already in {self.path}")
        links = {k: (self._dataset(np.asarray(v)), None) for k, v in datasets.items()}
        self._root[name] = self._group(links)

    def _dataset(self, arr: np.ndarray) -> int:
        dtype = _datatype(arr.dtype)
        data = arr.astype(np.int8).tobytes() if arr.dtype == np.bool_ else arr.tobytes()  # C order
        at = self._put(data) if data else UNDEF
        rank = arr.ndim
        space = struct.pack(f"<BBBx4x{2 * rank}Q", 1, rank, 1 if rank else 0,
                            *arr.shape, *arr.shape)
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # the default fill, allocated late
        layout = struct.pack("<BBQQ", 3, 1, at, len(data))
        return self._put(_object_header([
            _message(MSG_DATASPACE, space), _message(MSG_DATATYPE, dtype, flags=1),
            _message(MSG_FILL, fill, flags=1), _message(MSG_LAYOUT, layout)]))

    def _group(self, links: Dict[str, Tuple[int, Optional[Tuple[int, int]]]]):
        """Write a symbol-table group of ``links`` (name -> (object header,
        (B-tree, heap) of a group or None)); -> (object header, (B-tree, heap))."""
        names = sorted(links, key=lambda n: n.encode("utf-8"))
        heap_data, offsets = bytearray(8), {}  # offset 0: the empty name
        for n in names:
            offsets[n] = len(heap_data)
            raw = n.encode("utf-8") + b"\0"
            heap_data += raw + bytes(-len(raw) % 8)
        heap = self._pos
        self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), HEAP_FREE_NULL,
                                        heap + 32) + bytes(heap_data))

        # symbol table nodes, up to 2 * LEAF_K links each, in name order
        children, keys = [], []
        for i in range(0, len(names), 2 * LEAF_K):
            part = names[i:i + 2 * LEAF_K]
            node = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(part)))
            for n in part:
                header, scratch = links[n]
                node += struct.pack("<QQII", offsets[n], header, 0 if scratch is None else 1, 0)
                node += struct.pack("<QQ", *scratch) if scratch is not None else bytes(16)
            children.append(self._put(bytes(node) + bytes(SNOD_SIZE - len(node))))
            keys.append(offsets[part[-1]])

        # B-tree levels, up to 2 * NODE_K children a node, until one node is left
        level = 0
        while True:
            parts = [range(i, min(i + 2 * NODE_K, len(children)))
                     for i in range(0, len(children), 2 * NODE_K)] or [range(0)]
            base = self._pos
            addrs = [base + j * TREE_SIZE for j in range(len(parts))]
            for j, part in enumerate(parts):
                left = addrs[j - 1] if j > 0 else UNDEF
                right = addrs[j + 1] if j + 1 < len(parts) else UNDEF
                node = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, level, len(part), left, right))
                node += struct.pack("<Q", keys[part[0] - 1] if part and part[0] > 0 else 0)
                for c in part:
                    node += struct.pack("<QQ", children[c], keys[c])
                self._put(bytes(node) + bytes(TREE_SIZE - len(node)))
            if len(parts) == 1:
                btree = addrs[0]
                break
            keys = [keys[part[-1]] for part in parts]
            children, level = addrs, level + 1

        header = self._put(_object_header([_message(MSG_SYMBOL_TABLE,
                                                    struct.pack("<QQ", btree, heap))]))
        return header, (btree, heap)

    def close(self) -> None:
        if self._file.closed:
            return
        header, (btree, heap) = self._group(self._root)
        superblock = SIGNATURE + struct.pack(
            "<BBBBBBBBHHIQQQQ", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0,
            0, UNDEF, self._pos, UNDEF) + struct.pack("<QQIIQQ", 0, header, 1, 0, btree, heap)
        self._file.seek(0)
        self._file.write(superblock)
        self._file.close()
