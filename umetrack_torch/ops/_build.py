"""Build and load the package's CUDA sources (``csrc/<name>.cu``).

Each source has a plain C interface, is compiled by ``nvcc`` for ``sm_90a``
at first use into ``umetrack_torch/_build/`` (keyed on a hash of the source
and the flags, so an edited source never meets a stale library) and is
loaded with ``ctypes``.  Nothing here runs at import: a machine without
``nvcc`` imports every module and fails only when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return found


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns its path.  ``verbose`` adds ``-Xptxas -v`` to a
    build and prints the compiler's report (registers, spills, shared
    memory)."""
    source = source_path(name)
    with open(source, "rb") as fp:
        key = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    out = os.path.join(BUILD_DIR, f"{name}_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip(), flush=True)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if need be), with
    ``argtypes`` set from ``signatures`` (function name -> argument types);
    every function returns an ``int``."""
    lib = _load(name)
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
