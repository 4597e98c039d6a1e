"""A small msgpack codec: nil, bool, int, float32/64, str, bin, array, map,
and the extension type that flax writes for arrays.

The torch_data label files are msgpack objects, and this package depends on
no msgpack library: it always uses this codec.  It covers what the label
schema (nested dicts and lists of numbers and strings) and a flax msgpack
checkpoint need.  A numpy array is extension type 1, whose payload is the
packed tuple ``(shape, dtype name, C-order bytes)``; flax's other two
extension types (2: complex, 3: numpy scalar), any other extension type and
timestamps raise.

:func:`packb` writes each value in its shortest form, floats as float64 and
``bytes`` as bin, so its output is byte-identical to the ``msgpack``
package's ``packb`` defaults; :func:`unpackb` reads every width of every
type listed above, so it reads what that package wrote.  Decoding is plain
Python with two shortcuts for what fills the label files: runs of float64
and matrices of float64 (lists of equally long rows).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2**8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 2**16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 2**8:
            out += b"\xc4" + struct.pack(">B", n)
        elif n < 2**16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 2**16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(obj, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 2**16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_EXT_NAMES = {EXT_COMPLEX: "a complex number", EXT_NPSCALAR: "a numpy scalar"}
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT_LEN = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_LEN = {first: n for n, first in _FIXEXT.items()}


def _pack_ndarray(a: np.ndarray, out: bytearray) -> None:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError(f"cannot pack an array of dtype {a.dtype}")
    payload = bytearray()
    _pack((tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes("C")), payload)
    n = len(payload)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    elif n < 2**8:
        out += b"\xc7" + struct.pack(">B", n)
    elif n < 2**16:
        out += b"\xc8" + struct.pack(">H", n)
    elif n < 2**32:
        out += b"\xc9" + struct.pack(">I", n)
    else:
        raise OverflowError(f"array of {a.nbytes} bytes does not fit one msgpack extension")
    out.append(EXT_NDARRAY)
    out += payload


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


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 2**8:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v < 2**16:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v < 2**32:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v < 2**64:
        out += b"\xcf" + struct.pack(">Q", v)
    elif v >= 2**64 or v < -(2**63):
        raise OverflowError(f"integer {v} does not fit 64 bits")
    elif -(2**7) <= v:
        out += b"\xd0" + struct.pack(">b", v)
    elif -(2**15) <= v:
        out += b"\xd1" + struct.pack(">h", v)
    elif -(2**31) <= v:
        out += b"\xd2" + struct.pack(">i", v)
    else:
        out += b"\xd3" + struct.pack(">q", v)


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
