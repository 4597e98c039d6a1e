"""ctypes binding of the port's zstd decoder and CRC32C (``csrc/zstd_decode.cpp``).

The orbax checkpoints of the JAX package store every OCDBT manifest, node
and zarr chunk as zstd frames.  Python 3.12 has no zstd in its standard
library and the port takes no compression package, so it decodes with its
own C++ (RFC 8878), built with ``g++`` at first use into
``umetrack_torch/_build/`` (``ops/_build.py::build_host``, keyed and atomic,
so concurrent processes build it once).  There is no fallback: if the
library cannot be built, the first call raises.

The writer's half needs no compressor: :func:`frame_stored` wraps bytes in a
valid zstd frame of raw (stored) blocks, which any zstd decoder reads.
"""
from __future__ import annotations

import ctypes
import functools
import struct

NAME = "zstd_decode"
# function name -> (restype, argtypes)
_SIGNATURES = {
    "zd_decompress": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64]),
    "zd_status": (ctypes.c_int, [ctypes.c_void_p]),
    "zd_message": (ctypes.c_char_p, [ctypes.c_void_p]),
    "zd_size": (ctypes.c_int64, [ctypes.c_void_p]),
    "zd_data": (ctypes.c_void_p, [ctypes.c_void_p]),
    "zd_free": (None, [ctypes.c_void_p]),
    "zd_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]),
    "zd_xxh64": (ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64]),
}
MAGIC = b"\x28\xb5\x2f\xfd"
MAX_BLOCK = 128 << 10


class ZstdError(ValueError):
    """Corrupt, truncated or unsupported zstd input."""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded library (built if need be); raises if it cannot be built."""
    from ..ops import _build

    lib = ctypes.CDLL(_build.build_host(NAME))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data`` (skippable frames
    skipped); raises :class:`ZstdError` on corrupt or truncated input, a
    content checksum that does not match, or a frame that needs a
    dictionary."""
    data = bytes(data)
    lib = load_library()
    handle = lib.zd_decompress(data, len(data))
    if not handle:
        raise MemoryError("zstd: out of memory")
    try:
        if lib.zd_status(handle) != 0:
            raise ZstdError(f"zstd: {lib.zd_message(handle).decode()}")
        return ctypes.string_at(lib.zd_data(handle), lib.zd_size(handle))
    finally:
        lib.zd_free(handle)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return int(load_library().zd_crc32c(data, len(data), crc))


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash behind zstd's content checksum)."""
    data = bytes(data)
    return int(load_library().zd_xxh64(data, len(data), seed))


def frame_stored(data: bytes) -> bytes:
    """``data`` as one zstd frame of raw blocks: a single-segment header
    with the content size, then blocks of at most 128 KiB, no checksum."""
    n = len(data)
    if n < 256:
        header = bytes([0x20, n])  # single segment, 1-byte content size
    elif n < 65536 + 256:
        header = bytes([0x60]) + struct.pack("<H", n - 256)
    elif n < 1 << 32:
        header = bytes([0xA0]) + struct.pack("<I", n)
    else:
        header = bytes([0xE0]) + struct.pack("<Q", n)
    parts = [MAGIC, header]
    view = memoryview(data)
    start = 0
    while True:
        block = view[start:start + MAX_BLOCK]
        start += len(block)
        last = start >= n
        parts.append(struct.pack("<I", (len(block) << 3) | int(last))[:3])
        parts.append(block)
        if last:
            return b"".join(parts)
