"""A small msgpack reader: nil, bool, int, float32/64, str, bin, array,
map, and the extension type that flax writes for arrays (type 1, the
packed tuple ``(shape, dtype name, C-order bytes)``).  The reading half of
the port's ``data/_msgpack.py``, frozen: enough to read a flax msgpack
checkpoint.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np


EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_EXT_NAMES = {EXT_COMPLEX: "a complex number", EXT_NPSCALAR: "a numpy scalar"}
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT_LEN = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_LEN = {first: n for n, first in _FIXEXT.items()}


def _unpack_ext(code: int, payload: bytes) -> np.ndarray:
    if code != EXT_NDARRAY:
        what = _EXT_NAMES.get(code, "unknown")
        raise ValueError(f"unsupported msgpack extension type {code} ({what})")
    try:
        fields, end = _unpack(payload, 0)
    except (IndexError, struct.error):
        raise ValueError("truncated msgpack data") from None
    if not (isinstance(fields, list) and len(fields) == 3 and end == len(payload)
            and isinstance(fields[0], list) and isinstance(fields[1], str)
            and isinstance(fields[2], bytes)):
        raise ValueError("malformed array extension: want (shape, dtype name, bytes)")
    shape, dtype_name, raw = fields
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"array of dtype {dtype_name!r}: numpy has no such dtype") from None
    # a copy: the array must not pin (or alias) the whole file's buffer
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


# first byte -> (struct format of the value or of the length)
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY_LEN = {0xDC: ">H", 0xDD: ">I"}
_MAP_LEN = {0xDE: ">H", 0xDF: ">I"}


def unpackb(data) -> Any:
    """Decode one object from ``data`` (bytes, bytearray or memoryview);
    trailing bytes raise."""
    buf = bytes(data)  # indexing bytes is the fastest the interpreter offers
    try:
        obj, end = _unpack(buf, 0)
    except (IndexError, struct.error):
        raise ValueError("truncated msgpack data") from None
    if end > len(buf):
        raise ValueError("truncated msgpack data")
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack object")
    return obj


_F64 = struct.Struct(">d").unpack_from


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b < 0x90:
        return _unpack_map(buf, pos, b & 0x0F)
    if b < 0xA0:
        return _unpack_array(buf, pos, b & 0x0F)
    if b < 0xC0:
        end = pos + (b & 0x1F)
        return buf[pos:end].decode("utf-8"), end
    if b == 0xCB:
        return _F64(buf, pos)[0], pos + 8
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _SCALARS:
        fmt = _SCALARS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _BIN_LEN or b in _STR_LEN:
        fmt = _BIN_LEN.get(b) or _STR_LEN[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        raw = buf[pos: pos + n]
        if len(raw) != n:
            raise ValueError("truncated msgpack data")
        return (raw if b in _BIN_LEN else raw.decode("utf-8")), pos + n
    if b in _ARRAY_LEN or b in _MAP_LEN:
        fmt = _ARRAY_LEN.get(b) or _MAP_LEN[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return _unpack_array(buf, pos, n) if b in _ARRAY_LEN else _unpack_map(buf, pos, n)
    if b in _EXT_LEN or b in _FIXEXT_LEN:
        if b in _EXT_LEN:
            n = struct.unpack_from(_EXT_LEN[b], buf, pos)[0]
            pos += struct.calcsize(_EXT_LEN[b])
        else:
            n = _FIXEXT_LEN[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        payload = buf[pos: pos + n]
        if len(payload) != n:
            raise ValueError("truncated msgpack data")
        return _unpack_ext(code, payload), pos + n
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _float64_matrix(buf: bytes, pos: int, n: int):
    """``n`` consecutive arrays of one length, all float64 (a matrix stored
    as a list of rows: a mesh, a point cloud), decoded at once with numpy;
    ``None`` if the bytes at ``pos`` are anything else."""
    b = buf[pos]
    if 0x90 < b < 0xA0:
        hdr, k = 1, b & 0x0F
    elif b == 0xDC:
        hdr, k = 3, struct.unpack_from(">H", buf, pos + 1)[0]
    else:
        return None
    row = hdr + 9 * k
    if k == 0 or pos + n * row > len(buf):
        return None
    a = np.frombuffer(buf, np.uint8, n * row, pos).reshape(n, row)
    if not ((a[:, :hdr] == a[0, :hdr]).all() and (a[:, hdr::9] == 0xCB).all()):
        return None
    values = np.ascontiguousarray(a[:, hdr:].reshape(n, k, 9)[:, :, 1:]).view(">f8")
    return values.reshape(n, k).tolist(), pos + n * row


_MATRIX_MIN_ROWS = 8  # below this the numpy calls cost more than the loop


def _unpack_array(buf: bytes, pos: int, n: int) -> Tuple[list, int]:
    # Label files are mostly lists of float64 and small ints.  A run of
    # float64 decodes with one struct call and a matrix of them with numpy;
    # otherwise the two commonest scalars are decoded in this loop, without
    # a call each.
    end = pos + 9 * n
    if n > 1 and buf[pos:end:9] == b"\xcb" * n and end <= len(buf):
        return list(struct.unpack_from(">" + "xd" * n, buf, pos)), end
    if n >= _MATRIX_MIN_ROWS:
        matrix = _float64_matrix(buf, pos, n)
        if matrix is not None:
            return matrix
    out = []
    append = out.append
    for _ in range(n):
        b = buf[pos]
        if b < 0x80:
            append(b)
            pos += 1
        elif b == 0xCB:
            append(_F64(buf, pos + 1)[0])
            pos += 9
        else:
            item, pos = _unpack(buf, pos)
            append(item)
    return out, pos


def _unpack_map(buf: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        value, pos = _unpack(buf, pos)
        out[key] = value
    return out, pos
