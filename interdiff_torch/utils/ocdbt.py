"""Read-only access to an OCDBT key-value store (tensorstore's "optionally
cooperative distributed B+tree", the store under every orbax save of the
JAX package) and to the zarr v2 arrays orbax keeps in it.  Only numpy and
the standard library; zstd through `utils/zstd.py`.

A store is a directory.  ``manifest.ocdbt`` holds the configuration and the
version tree; the newest version names the root of a B+tree whose nodes,
and the values too long to sit inline in a leaf, lie in data files named
relative to the store's root (an orbax save's top-level tree points into
``ocdbt.process_0/d/``).  Every manifest and node is

    magic (uint32 big-endian) | length (uint64 little-endian, of the whole
    encoding) | version (varint, 0) | compression (varint: 0 none, 1 zstd)
    | body (compressed as said) | crc32c (uint32 little-endian) of all
    bytes before it

with the manifest's magic ``0x0cdb3a2a`` and a node's ``0x0cdb20de``.  The
magics, lengths, versions and checksums are checked; a value read from a
data file has no checksum of its own in the format (a zarr chunk carries
its zstd frame's).  Integers are LEB128 varints; a table of data files and
a node's keys are prefix-compressed arrays, each field stored for all
entries before the next field.  Numbered manifests (``manifest_kind`` 1)
are not written by orbax and are refused.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from interdiff_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # offset and length of an empty tree's root


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every OCDBT encoding."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over one decoded body; every read past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after the end")


def _decode_envelope(raw: bytes, magic: int, what: str,
                     max_size: int = 1 << 34) -> bytes:
    """Check the header and checksum of one encoded manifest or node and
    return its body, decompressed."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes is too short")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, read "
                         f"{len(raw)}")
    want = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Reader(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} (reads 0)")
    body = head.data[head.pos:]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, max_size=max_size)
    raise ValueError(f"{what}: unknown compression {compression}")


def _data_file_table(r: _Reader) -> List[str]:
    """The prefix-compressed paths of the data files a node or manifest
    refers to, relative to the store's root (base path and relative path
    joined)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: where the base ends in each path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: bad data-file prefix")
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, common: bool):
    """A node's ``n`` prefix-compressed keys (and, in an interior node, the
    length of the key prefix each child's subtree shares)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    shared = r.varints(n) if common else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: bad key prefix")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, shared


class OcdbtStore:
    """The newest version of the OCDBT store at ``root``: ``list()`` its
    keys in order and ``read(key)`` a value (bytes; `KeyError` if absent).
    The whole tree is read once, at construction: the values' locations
    are kept, the values are read on demand."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        manifest = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"{self.root} is not an OCDBT store: no "
                                    "manifest.ocdbt")
        with open(manifest, "rb") as f:
            r = _Reader(_decode_envelope(f.read(), MANIFEST_MAGIC, manifest),
                        manifest)
        r.take(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind} (numbered "
                             "manifests are not read)")
        r.varint()  # max_inline_value_bytes
        self.max_node_bytes = r.varint()
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # the store's compression: zstd, then its level
            r.take(4)
        files = _data_file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = list(r.take(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(2 * n)  # tree bytes, indirect value bytes
        r.take(8 * n)  # commit times
        # older versions in version-tree nodes follow; the newest version
        # is always among the inline ones read above
        if not n:
            raise ValueError(f"{manifest}: no version")
        newest = max(range(n), key=generation.__getitem__)
        self._values: Dict[bytes, Tuple] = {}
        if offset[newest] != _MISSING:
            self._visit(files[file_id[newest]], offset[newest],
                        length[newest], height[newest], b"")
        if len(self._values) != num_keys[newest]:
            raise ValueError(f"{manifest}: the version holds "
                             f"{num_keys[newest]} keys, its tree "
                             f"{len(self._values)}")

    def _path(self, relative: str) -> str:
        path = os.path.normpath(os.path.join(self.root, relative))
        if os.path.commonpath([path, self.root]) != self.root:
            raise ValueError(f"data file {relative!r} lies outside "
                             f"{self.root}")
        return path

    def _read_file(self, relative: str, offset: int, length: int) -> bytes:
        path = self._path(relative)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} wanted, "
                             f"{len(data)} there")
        return data

    def _visit(self, file: str, offset: int, length: int, height: int,
               prefix: bytes) -> None:
        what = f"{file}@{offset}"
        r = _Reader(_decode_envelope(self._read_file(file, offset, length),
                                    NODE_MAGIC, what, self.max_node_bytes),
                    what)
        if r.byte() != height:
            raise ValueError(f"{what}: node height differs from its "
                             "reference's")
        files = _data_file_table(r)
        n = r.varint()
        keys, shared = _keys(r, n, height > 0)
        if height > 0:
            child = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # keys, tree bytes, indirect value bytes
            r.end()
            for i, key in enumerate(keys):
                self._visit(files[child[0][i]], child[1][i], child[2][i],
                            height - 1, prefix + key[:shared[i]])
            return
        size = r.varints(n)
        kind = r.varints(n)
        if set(kind) - {0, 1}:
            raise ValueError(f"{what}: unknown value kind")
        indirect = [i for i in range(n) if kind[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        for i, f, o in zip(indirect, ids, offsets):
            self._values[prefix + keys[i]] = (files[f], o, size[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[prefix + keys[i]] = r.take(size[i])
        r.end()

    def list(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        value = self._values[key.encode()]
        return value if isinstance(value, bytes) else self._read_file(*value)


# -- zarr v2 arrays, as orbax writes them into the store (`use_zarr3` off)

def _fill(spec, name: str):
    value = spec.get("fill_value")
    if value is None:
        return 0
    if not isinstance(value, (int, float)):
        raise ValueError(f"{name}: zarr fill_value {value!r} is not read")
    return value


def _decode_chunk(raw: bytes, spec, dtype: np.dtype,
                  chunks: Tuple[int, ...], name: str) -> np.ndarray:
    size = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    compressor = spec.get("compressor")
    if compressor is not None:
        if compressor.get("id") != "zstd":
            raise ValueError(f"{name}: zarr compressor {compressor} is not "
                             "read (zstd only)")
        raw = zstd.decompress(raw, size_hint=size, max_size=size)
    if len(raw) != size:
        raise ValueError(f"{name}: chunk of {len(raw)} bytes, expected "
                         f"{size}")
    return np.frombuffer(raw, dtype).reshape(chunks, order=spec["order"])


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` (its ``.zarray`` and chunks
    ``name/<i>.<j>...``): chunks placed on the grid, edge chunks cut to the
    shape, missing chunks the fill value (zero for ``null``).  Raises on a
    compressor, filter, dtype or order it does not know."""
    spec = json.loads(store.read(f"{name}/.zarray"))
    if spec.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {spec.get('zarr_format')}")
    if spec.get("filters"):
        raise ValueError(f"{name}: zarr filters {spec['filters']} are not "
                         "read")
    if spec.get("order") not in ("C", "F"):
        raise ValueError(f"{name}: zarr order {spec.get('order')!r}")
    try:
        dtype = np.dtype(spec["dtype"])
    except TypeError as e:
        raise ValueError(f"{name}: zarr dtype {spec['dtype']!r} is not "
                         "read") from e
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"{name}: zarr dtype {spec['dtype']!r} is not read")
    shape = tuple(int(s) for s in spec["shape"])
    chunks = tuple(int(c) for c in spec["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = spec.get("dimension_separator", ".")
    out = np.full(shape, _fill(spec, name), dtype=dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue
        chunk = _decode_chunk(store.read(key), spec, dtype, chunks, key)
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(index, chunks, shape))
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out

