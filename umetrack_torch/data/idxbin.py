"""Reader/writer for the ``.torch.idx`` / ``.torch.bin`` dataset format.

The port's own copy of ``umetrack_tpu/data/idxbin.py`` (numpy only; msgpack
objects go through ``data/_msgpack.py``), file-compatible both ways.  The
``.idx`` file is a flat int64 array

    [0] magic  = 0x584449544E54  ("TNTIDX" little-endian)   (version 1)
    [1] version (0 legacy: magic must be 0; 1 current)
    [2] dtype code (see DTYPE_CODES; 8 = msgpack object)
    [3] itemsize in bytes
    [4] N  — number of frames
    [5] S  — total number of dimension entries
    [...] N+1 dim offsets   (indices into the sizes block)
    [...] N+1 data offsets  (into the .bin file, in units of itemsize)
    [...] S sizes           (concatenated per-frame shapes)

and the ``.bin`` file is the concatenated frame payloads.  Frames are
served from an ``mmap`` so random access is zero-copy and page-cache
friendly.  The writer emits uniform tensors or msgpack objects.
"""
from __future__ import annotations

import mmap
import os
from dataclasses import dataclass, field
from typing import Any, List, Sequence, Tuple, Union

import numpy as np

from . import _msgpack

MAGIC = 0x584449544E54

DTYPE_CODES = {
    1: "uint8",
    2: "int8",
    3: "int16",
    4: "int32",
    5: "int64",
    6: "float32",
    7: "float64",
    8: "object",  # msgpack-packed
}
CODE_FOR_DTYPE = {v: k for k, v in DTYPE_CODES.items()}

IDX_SUFFIX = ".torch.idx"
BIN_SUFFIX = ".torch.bin"


def bin_path_for_idx(idx_path: str) -> str:
    if not idx_path.endswith(IDX_SUFFIX):
        raise ValueError(f"{idx_path} does not end in {IDX_SUFFIX}")
    return idx_path[: -len(IDX_SUFFIX)] + BIN_SUFFIX


@dataclass
class IdxBinFile:
    """Parsed idx + lazily-mmapped bin.

    ``file[i]`` returns a zero-copy ndarray view (tensor frames) or a decoded
    msgpack object.  ``shape`` is set only when all frames are uniform.
    """

    idx_path: str
    bin_path: str
    dtype: np.dtype
    is_msgpack: bool
    itemsize: int
    dims: List[Tuple[int, ...]]
    byte_offsets: np.ndarray  # [N+1] into the .bin file
    shape: Union[Tuple[int, ...], None]
    _mm: Any = field(default=None, repr=False)

    # -- parsing --------------------------------------------------------------

    @classmethod
    def open(cls, idx_path: str, bin_path: str | None = None) -> "IdxBinFile":
        if bin_path is None:
            bin_path = bin_path_for_idx(idx_path)
        raw = np.fromfile(idx_path, dtype=np.int64)
        if raw[1] == 0:
            if raw[0] != 0:
                raise ValueError(f"bad magic in legacy idx file {idx_path}")
        elif raw[1] == 1:
            if raw[0] != MAGIC:
                raise ValueError(f"bad magic in idx file {idx_path}")
        else:
            raise ValueError(f"unsupported idx version {raw[1]} in {idx_path}")

        code = int(raw[2])
        if code not in DTYPE_CODES:
            raise KeyError(f"unknown dtype code {code} in {idx_path}")
        dtype_name = DTYPE_CODES[code]
        is_msgpack = dtype_name == "object"
        itemsize = int(raw[3])
        n = int(raw[4])
        s = int(raw[5])

        ofs = 6
        dim_offsets = raw[ofs: ofs + n + 1]
        ofs += n + 1
        data_offsets = raw[ofs: ofs + n + 1]
        ofs += n + 1
        sizes = raw[ofs: ofs + s]

        dims = [
            tuple(int(x) for x in sizes[dim_offsets[i]: dim_offsets[i + 1]])
            for i in range(n)
        ]
        byte_offsets = (data_offsets * itemsize).astype(np.int64)

        shape = None
        if not is_msgpack and n > 0 and all(d == dims[0] for d in dims):
            shape = (n, *dims[0])

        return cls(
            idx_path=idx_path,
            bin_path=bin_path,
            dtype=np.dtype("uint8" if is_msgpack else dtype_name),
            is_msgpack=is_msgpack,
            itemsize=itemsize,
            dims=dims,
            byte_offsets=byte_offsets,
            shape=shape,
        )

    # -- access ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.dims)

    @property
    def mm(self):
        if self._mm is None:
            with open(self.bin_path, "rb") as fp:
                self._mm = mmap.mmap(fp.fileno(), 0, access=mmap.ACCESS_READ)
        return self._mm

    def preload(self) -> "IdxBinFile":
        """Pull the whole .bin into RAM so later frame reads never touch
        storage.  Idempotent; returns self."""
        if not isinstance(self._mm, bytes):
            with open(self.bin_path, "rb") as fp:
                self._mm = fp.read()
        return self

    def frame_bytes(self, i: int) -> memoryview:
        lo, hi = int(self.byte_offsets[i]), int(self.byte_offsets[i + 1])
        return memoryview(self.mm)[lo:hi]

    def __getitem__(self, i: int):
        buf = self.frame_bytes(i)
        if self.is_msgpack:
            return _msgpack.unpackb(buf)
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.dims[i])

    def read_all(self):
        """Whole file as one array (uniform tensors only)."""
        if self.shape is None:
            return [self[i] for i in range(len(self))]
        lo = int(self.byte_offsets[0])
        hi = int(self.byte_offsets[-1])
        return np.frombuffer(memoryview(self.mm)[lo:hi], dtype=self.dtype).reshape(
            self.shape
        )

    def close(self):
        # After preload() the backing store is a plain bytes object (nothing
        # to release); only a live mmap needs closing.
        if self._mm is not None and not isinstance(self._mm, bytes):
            self._mm.close()
        self._mm = None


# -- writer -------------------------------------------------------------------


def write_idxbin(
    path_prefix: str,
    frames: Union[np.ndarray, Sequence[Any]],
    msgpack_objects: bool = False,
) -> Tuple[str, str]:
    """Write frames to ``<prefix>.torch.idx`` / ``.torch.bin``.

    ``frames`` is either one ndarray (axis 0 = frames, uniform shape) or a
    sequence of ndarrays / msgpack-serializable objects.
    """
    idx_path = path_prefix + IDX_SUFFIX
    bin_path = path_prefix + BIN_SUFFIX

    if msgpack_objects:
        blobs = [_msgpack.packb(obj) for obj in frames]
        code = CODE_FOR_DTYPE["object"]
        itemsize = 1
        dims = [(len(b),) for b in blobs]
        payloads = blobs
    else:
        if isinstance(frames, np.ndarray):
            frames = [frames[i] for i in range(frames.shape[0])]
        arrs = [np.ascontiguousarray(f) for f in frames]
        dtype = arrs[0].dtype
        if any(a.dtype != dtype for a in arrs):
            raise TypeError("frames of mixed dtypes")
        code = CODE_FOR_DTYPE[dtype.name]
        itemsize = dtype.itemsize
        dims = [a.shape for a in arrs]
        payloads = [a.tobytes() for a in arrs]

    n = len(payloads)
    dim_offsets = np.zeros(n + 1, np.int64)
    for i, d in enumerate(dims):
        dim_offsets[i + 1] = dim_offsets[i] + len(d)
    data_offsets = np.zeros(n + 1, np.int64)
    for i, p in enumerate(payloads):
        data_offsets[i + 1] = data_offsets[i] + len(p) // itemsize
    sizes = np.asarray([x for d in dims for x in d], np.int64)

    header = np.asarray(
        [MAGIC, 1, code, itemsize, n, len(sizes)], np.int64
    )
    idx = np.concatenate([header, dim_offsets, data_offsets, sizes])

    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    idx.tofile(idx_path)
    with open(bin_path, "wb") as fp:
        for p in payloads:
            fp.write(p)
    return idx_path, bin_path
