"""The OCDBT key-value store under the JAX package's orbax checkpoints.

Counterpart of tensorstore's ``ocdbt`` driver, which orbax's
``StandardCheckpointer`` writes through (``umetrack_tpu/utils/checkpoints.py``).
A store is a directory: ``manifest.ocdbt`` names the latest version, whose
root is a B+tree node; nodes and values live in data files (``d/<hex>``) as
byte ranges.  Every manifest and node file is framed the same way:

    magic (u32, big-endian) | total length (u64, little-endian) |
    format version (varint, 0) | compression (varint: 0 none, 1 zstd) |
    body (a zstd frame when compressed) | CRC-32C of all before it (u32 LE)

Bodies are columnar: each field is stored for all entries before the next
field.  Integers are LEB128 varints unless stated.

- Data file table (in manifests and nodes): count; for entries after the
  first, the length of the path prefix shared with the previous path; the
  length of each path's remaining suffix; the length of each path's base
  path; the suffixes.  A file is ``base path + relative path``, relative to
  the store's root, and the base path of the node that holds the table is
  prepended (orbax's root store points into ``ocdbt.process_0/``).
- Manifest: config (16-byte uuid, manifest kind, max inline value bytes,
  max decoded node bytes, version-tree arity log2 as a byte, compression
  method, a 4-byte zstd level when zstd); a data file table; the inline
  versions (count; generation; root height as a byte; root data file,
  offset, length; key count; tree bytes; indirect value bytes; commit
  time as u64 nanoseconds); the version-tree node references (count;
  generation; data file, offset, length; generation count; commit time;
  height as a byte).
- B+tree node: height (byte, 0 for a leaf); a data file table; entry
  count; shared key prefix lengths (entries after the first); key suffix
  lengths; interior nodes only: the length of each child subtree's common
  key prefix; the key suffixes.  A leaf then has value lengths, value kinds
  (0 inline, 1 in a data file), data file and offset of each out-of-line
  value, and the inline values.  An interior node has its children's data
  file, offset, length, key count, tree bytes and indirect value bytes.
  Keys are relative to the prefixes their ancestors stripped.

Reading checks every file's CRC-32C and decodes zstd with the port's own
decoder (``utils/_zstd.py``).  Writing makes one version at the root of a
new directory: values above ``max_inline_value_bytes`` and then the
B+tree nodes go into one data file, nodes and the manifest compressed as
zstd frames of stored blocks, split into as many nodes as
``max_decoded_node_bytes`` requires.
"""
from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from . import _zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
NO_COMPRESSION, ZSTD = 0, 1
SINGLE_MANIFEST = 0
# orbax's settings for its checkpoints (orbax ``add_ocdbt_write_options``)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_NO_NODE = (1 << 64) - 1  # offset and length of an empty tree's root

DataFile = Tuple[str, str]  # (base path, relative path), both under the store's root
ValueRef = Union[bytes, Tuple[DataFile, int, int]]


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT store."""


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes after the last field")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, after checking its magic,
    length, CRC-32C, format version and compression."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: truncated ({len(data)} bytes)")
    found = int.from_bytes(data[:4], "big")
    if found != magic:
        raise OcdbtError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise OcdbtError(f"{what}: header says {length} bytes, found {len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if _zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(data[:-4], what)
    cur.pos = 12
    version = cur.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{what}: format version {version} is not supported")
    compression = cur.varint()
    body = data[cur.pos:-4]
    if compression == ZSTD:
        return _zstd.decompress(body)
    if compression != NO_COMPRESSION:
        raise OcdbtError(f"{what}: compression {compression} is not supported")
    return body


def encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node file around ``body``, zstd-framed in stored blocks."""
    payload = _zstd.frame_stored(body)
    head_tail = _varint(FORMAT_VERSION) + _varint(ZSTD)
    total = 4 + 8 + len(head_tail) + len(payload) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", total) + head_tail + payload
    return data + struct.pack("<I", _zstd.crc32c(data))


def _read_file_table(cur: _Cursor, base: str) -> List[DataFile]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{cur.what}: data file path prefix out of range")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError(f"{cur.what}: data file base path out of range")
        files.append((base + path[:base_len[i]].decode(), path[base_len[i]:].decode()))
        prev = path
    return files


def _write_file_table(files: Sequence[DataFile]) -> bytes:
    paths = [(b + r).encode() for b, r in files]
    prefix = [len(os.path.commonprefix([paths[i - 1], paths[i]])) for i in range(1, len(paths))]
    prefix_all = [0] + prefix
    return (_varint(len(paths)) + _varints(prefix)
            + _varints(len(p) - k for p, k in zip(paths, prefix_all))
            + _varints(len(b.encode()) for b, _ in files)
            + b"".join(p[k:] for p, k in zip(paths, prefix_all)))


def _read_keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], Optional[List[int]]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{cur.what}: key prefix out of range")
        prev = prev[:prefix[i]] + cur.take(suffix[i])
        keys.append(prev)
    return keys, common


def _write_keys(keys: Sequence[bytes], common: Optional[Sequence[int]] = None) -> bytes:
    prefix = [0] + [len(os.path.commonprefix([keys[i - 1], keys[i]])) for i in range(1, len(keys))]
    out = (_varint(len(keys)) + _varints(prefix[1:])
           + _varints(len(k) - p for k, p in zip(keys, prefix)))
    if common is not None:
        out += _varints(common)
    return out + b"".join(k[p:] for k, p in zip(keys, prefix))


class OcdbtStore:
    """The latest version of the OCDBT store at ``root``, read-only:
    :meth:`list` its keys, :meth:`read` a value.  The B+tree is read when
    the store is opened; out-of-line values when they are read."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise OcdbtError(f"{root} is no OCDBT store (no manifest.ocdbt)")
        with open(path, "rb") as fp:
            cur = _Cursor(decode_file(fp.read(), MANIFEST_MAGIC, path), path)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != SINGLE_MANIFEST:
            raise OcdbtError(f"{path}: manifest kind {kind} (numbered manifests) is not supported")
        cur.varint()  # max inline value bytes: a writer's limit
        self.max_decoded_node_bytes = cur.varint()
        cur.take(1)  # version tree arity log2
        compression = cur.varint()
        if compression == ZSTD:
            cur.take(4)  # zstd level
        elif compression != NO_COMPRESSION:
            raise OcdbtError(f"{path}: compression method {compression} is not supported")
        files = _read_file_table(cur, "")
        n = cur.varint()
        cur.varints(n)  # generation numbers
        heights = list(cur.take(n))
        file_ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # key count, tree bytes, indirect value bytes
        cur.u64s(n)  # commit times
        m = cur.varint()  # references to version-tree nodes (older versions)
        cur.varints(5 * m)
        cur.u64s(m)
        cur.take(m)
        cur.end()
        if n == 0:
            raise OcdbtError(f"{path}: no inline version (only version-tree nodes)")
        self.height = heights[-1]  # of the newest version's B+tree
        self._entries: Dict[bytes, ValueRef] = {}
        if offsets[-1] != _NO_NODE:
            if file_ids[-1] >= len(files):
                raise OcdbtError(f"{path}: root data file {file_ids[-1]} out of range")
            self._walk(heights[-1], files[file_ids[-1]], offsets[-1], lengths[-1], b"")

    def _read_range(self, file: DataFile, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, file[0] + file[1])
        with open(path, "rb") as fp:
            fp.seek(offset)
            data = fp.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} run past its end")
        return data

    def _walk(self, height: int, file: DataFile, offset: int, length: int, prefix: bytes) -> None:
        what = f"{file[0] + file[1]}@{offset}"
        body = decode_file(self._read_range(file, offset, length), BTREE_MAGIC, what)
        if len(body) > self.max_decoded_node_bytes:
            raise OcdbtError(f"{what}: node of {len(body)} bytes exceeds the store's limit")
        cur = _Cursor(body, what)
        found = cur.take(1)[0]
        if found != height:
            raise OcdbtError(f"{what}: node height {found}, expected {height}")
        files = _read_file_table(cur, file[0])
        n = cur.varint()
        keys, common = _read_keys(cur, n, interior=height > 0)

        def data_file(i: int) -> DataFile:
            if i >= len(files):
                raise OcdbtError(f"{what}: data file {i} out of range")
            return files[i]

        if height == 0:
            value_lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            m = sum(kinds)
            ids, offsets = cur.varints(m), cur.varints(m)
            j = 0
            for key, size, kind in zip(keys, value_lengths, kinds):
                if kind:
                    self._entries[prefix + key] = (data_file(ids[j]), offsets[j], size)
                    j += 1
                else:
                    self._entries[prefix + key] = cur.take(size)
            cur.end()
            return
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # key count, tree bytes, indirect value bytes
        cur.end()
        for key, keep, i, off, size in zip(keys, common, ids, offsets, lengths):
            if keep > len(key):
                raise OcdbtError(f"{what}: subtree prefix longer than its key")
            self._walk(height - 1, data_file(i), off, size, prefix + key[:keep])

    def list(self) -> List[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` if the store has none."""
        ref = self._entries[key.encode()]
        return ref if isinstance(ref, bytes) else self._read_range(*ref)


# ---------------------------------------------------------------- writing

class _Child:
    """A written node, as its parent refers to it: the first and last key of
    its subtree (full keys), where it lies and what it holds."""

    def __init__(self, first: bytes, last: bytes, offset: int, length: int, tree_bytes: int,
                 indirect_bytes: int, num_keys: int):
        self.first, self.last = first, last
        self.common = os.path.commonprefix([first, last])
        self.offset, self.length = offset, length
        self.tree_bytes, self.indirect_bytes, self.num_keys = tree_bytes, indirect_bytes, num_keys


def _groups(sizes: Sequence[int], overhead: int, limit: int) -> List[Tuple[int, int]]:
    """Split entries of ``sizes`` (upper bounds of their encoded bytes) into
    consecutive runs of at most ``limit`` bytes with ``overhead`` each."""
    runs, start, total = [], 0, overhead
    for i, size in enumerate(sizes):
        if overhead + size > limit:
            raise OcdbtError(f"an entry of {size} bytes does not fit a node of {limit} bytes")
        if total + size > limit and i > start:
            runs.append((start, i))
            start, total = i, overhead
        total += size
    runs.append((start, len(sizes)))
    return runs


def write_store(root: str, items: Mapping[str, bytes], *,
                max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> None:
    """Write ``items`` as a new one-version OCDBT store at ``root`` (an
    empty or missing directory): one data file of out-of-line values and
    B+tree nodes, then ``manifest.ocdbt``.  A node under a parent stores
    its keys without their common prefix, which its parent records."""
    if not items:
        raise ValueError("an OCDBT store needs at least one key")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileExistsError(f"{root} already holds an OCDBT store")
    data_file: DataFile = ("", f"d/{uuid.uuid4().hex}")
    table = _write_file_table([data_file])
    keys = sorted(k.encode() for k in items)
    chunks: List[bytes] = []
    offset = 0

    def append(blob: bytes) -> int:
        nonlocal offset
        chunks.append(blob)
        offset += len(blob)
        return offset - len(blob)

    values = [items[k.decode()] for k in keys]
    refs = [append(v) if len(v) > max_inline_value_bytes else None for v in values]

    # Upper bounds of each entry's encoded bytes: a varint takes at most 10.
    node_overhead = 1 + len(table) + 10
    sizes = [len(k) + 10 * 5 + 1 + (len(v) if r is None else 0)
             for k, v, r in zip(keys, values, refs)]
    runs = _groups(sizes, node_overhead, max_decoded_node_bytes)
    level: List[_Child] = []
    for lo, hi in runs:
        strip = len(os.path.commonprefix([keys[lo], keys[hi - 1]])) if len(runs) > 1 else 0
        vals, out = values[lo:hi], [r for r in refs[lo:hi] if r is not None]
        body = (bytes([0]) + table + _write_keys([k[strip:] for k in keys[lo:hi]])
                + _varints(len(v) for v in vals)
                + _varints(int(r is not None) for r in refs[lo:hi])
                + _varints(0 for _ in out) + _varints(out)
                + b"".join(v for v, r in zip(vals, refs[lo:hi]) if r is None))
        node = encode_file(body, BTREE_MAGIC)
        indirect = sum(len(v) for v, r in zip(vals, refs[lo:hi]) if r is not None)
        level.append(_Child(keys[lo], keys[hi - 1], append(node), len(node), len(node),
                            indirect, hi - lo))
    height = 0
    while len(level) > 1:
        height += 1
        runs = _groups([len(c.first) + 10 * 7 for c in level], node_overhead,
                       max_decoded_node_bytes)
        parents: List[_Child] = []
        for lo, hi in runs:
            children = level[lo:hi]
            strip = (len(os.path.commonprefix([children[0].first, children[-1].last]))
                     if len(runs) > 1 else 0)
            body = (bytes([height]) + table
                    + _write_keys([c.first[strip:] for c in children],
                                  [len(c.common) - strip for c in children])
                    + _varints(0 for _ in children)
                    + _varints(c.offset for c in children)
                    + _varints(c.length for c in children)
                    + _varints(c.num_keys for c in children)
                    + _varints(c.tree_bytes for c in children)
                    + _varints(c.indirect_bytes for c in children))
            node = encode_file(body, BTREE_MAGIC)
            parents.append(_Child(children[0].first, children[-1].last, append(node), len(node),
                                  len(node) + sum(c.tree_bytes for c in children),
                                  sum(c.indirect_bytes for c in children),
                                  sum(c.num_keys for c in children)))
        level = parents
    root_node = level[0]
    with open(os.path.join(root, data_file[1]), "wb") as fp:
        for blob in chunks:
            fp.write(blob)
        fp.flush()
        os.fsync(fp.fileno())
    config = (uuid.uuid4().bytes + _varint(SINGLE_MANIFEST) + _varint(max_inline_value_bytes)
              + _varint(max_decoded_node_bytes) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(ZSTD) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([height]) + _varint(0)
               + _varint(root_node.offset) + _varint(root_node.length)
               + _varint(root_node.num_keys) + _varint(root_node.tree_bytes)
               + _varint(root_node.indirect_bytes) + struct.pack("<Q", time.time_ns()))
    manifest = encode_file(config + table + version + _varint(0), MANIFEST_MAGIC)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as fp:
        fp.write(manifest)
        fp.flush()
        os.fsync(fp.fileno())
