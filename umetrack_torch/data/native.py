"""ctypes binding of the native idx/bin reader (``csrc/umetrack_io.cpp``).

Counterpart of ``umetrack_tpu/data/native.py``: frames are zero-copy views
of the mmap'd ``.bin`` file, and a ring of native worker threads prefaults
the pages of the frames to come, so the byte path never holds the
interpreter lock.  Msgpack frames are decoded from the mmap'd span with the
port's own codec (``data/_msgpack.py``).  The library is built with
``g++`` at first use into ``umetrack_torch/_build/`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, Optional, Sequence

import numpy as np

from . import _msgpack
from .idxbin import DTYPE_CODES, bin_path_for_idx

NAME = "umetrack_io"
_P64 = ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
# function name -> (restype, argtypes)
_SIGNATURES = {
    "ut_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p]),
    "ut_close": (None, [ctypes.c_void_p]),
    "ut_len": (ctypes.c_int64, [ctypes.c_void_p]),
    "ut_dtype_code": (ctypes.c_int64, [ctypes.c_void_p]),
    "ut_frame_ndim": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
    "ut_frame_dims": (None, [ctypes.c_void_p, ctypes.c_int64, _P64]),
    "ut_frame_ptr": (_PU8, [ctypes.c_void_p, ctypes.c_int64, _P64]),
    "ut_ring_create": (ctypes.c_void_p, [ctypes.c_void_p, _P64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64]),
    "ut_ring_next": (ctypes.c_int64, [ctypes.c_void_p, ctypes.POINTER(_PU8), _P64]),
    "ut_ring_destroy": (None, [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded library (built if need be); raises if it cannot be built."""
    from ..ops import _build

    lib = ctypes.CDLL(_build.build_host(NAME))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def library_path() -> str:
    """Where the library is (or would be) built."""
    from ..ops import _build

    return _build._library_path(NAME, _build._sources_key(_build.GXX_FLAGS))


class NativeIdxBin:
    """Native counterpart of :class:`~umetrack_torch.data.idxbin.IdxBinFile`:
    ``file[i]`` is a zero-copy ndarray view (tensor frames) or a decoded
    msgpack object, valid until :meth:`close`."""

    def __init__(self, idx_path: str, bin_path: Optional[str] = None):
        self._lib = load_library()
        bin_path = bin_path or bin_path_for_idx(idx_path)
        self._h = self._lib.ut_open(idx_path.encode(), bin_path.encode())
        if not self._h:
            raise IOError(f"cannot open {idx_path} / {bin_path}")
        code = int(self._lib.ut_dtype_code(self._h))
        name = DTYPE_CODES.get(code)
        if name is None:
            self.close()
            raise ValueError(f"unknown dtype code {code} in {idx_path}")
        self.is_msgpack = name == "object"
        self.dtype = np.dtype("uint8" if self.is_msgpack else name)
        self._n = int(self._lib.ut_len(self._h))

    def __len__(self) -> int:
        return self._n

    def _check(self, i: int) -> int:
        if self._h is None:
            raise ValueError("the file is closed")
        if not 0 <= i < self._n:
            raise IndexError(i)
        return i

    def frame_shape(self, i: int):
        i = self._check(i)
        nd = int(self._lib.ut_frame_ndim(self._h, i))
        buf = (ctypes.c_int64 * nd)()
        self._lib.ut_frame_dims(self._h, i, buf)
        return tuple(int(x) for x in buf)

    def _frame(self, i: int, ptr, size: int):
        raw = np.ctypeslib.as_array(ptr, shape=(size,)) if size else np.empty(0, np.uint8)
        if self.is_msgpack:
            return _msgpack.unpackb(raw.tobytes())
        return raw.view(self.dtype).reshape(self.frame_shape(i))

    def __getitem__(self, i: int):
        i = self._check(int(i))
        size = ctypes.c_int64()
        ptr = self._lib.ut_frame_ptr(self._h, i, ctypes.byref(size))
        return self._frame(i, ptr, size.value)

    def iter_prefetched(
        self, order: Optional[Sequence[int]] = None, n_threads: int = 4, capacity: int = 16,
    ) -> Iterator:
        """(index, frame) pairs of ``order`` (default every frame), their
        pages prefaulted by ``n_threads`` native threads at most
        ``capacity`` frames ahead; within that window the pairs come in the
        order the threads finish."""
        order_arr = np.asarray(range(self._n) if order is None else list(order), dtype=np.int64)
        for i in order_arr:
            self._check(int(i))
        ring = self._lib.ut_ring_create(
            self._h, order_arr.ctypes.data_as(_P64), len(order_arr), n_threads, capacity
        )
        try:
            ptr, size = _PU8(), ctypes.c_int64()
            while True:
                idx = int(self._lib.ut_ring_next(ring, ctypes.byref(ptr), ctypes.byref(size)))
                if idx < 0:
                    break
                yield idx, self._frame(idx, ptr, size.value)
        finally:
            self._lib.ut_ring_destroy(ring)

    def close(self):
        if self._h:
            self._lib.ut_close(self._h)
        self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def open_idxbin(idx_path: str, bin_path: Optional[str] = None):
    """The native reader where the library builds, else the Python one."""
    if available():
        return NativeIdxBin(idx_path, bin_path)
    from .idxbin import IdxBinFile

    return IdxBinFile.open(idx_path, bin_path)
