"""Build and load the package's native sources: the CUDA kernels
(``csrc/<name>.cu``) and the host-side IO library (``csrc/<name>.cpp``).

Each source has a plain C interface, is compiled at first use into
``umetrack_torch/_build/`` (a ``.cu`` by ``nvcc`` for ``sm_90a``, a ``.cpp``
by ``g++``) and is loaded with ``ctypes``.  A library is keyed on a hash of
every file under ``csrc/`` (the sources share headers there) and of the
flags, so neither an edited source nor an edited header meets a stale
library.  Nothing here runs at import: a machine without ``nvcc`` imports
every module and fails only when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")


def source_path(name: str, suffix: str = ".cu") -> str:
    return os.path.join(CSRC_DIR, f"{name}{suffix}")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return found


def _sources_key(flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of every file under ``csrc/`` (names and contents) and the flags."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for file_name in sorted(os.listdir(CSRC_DIR)):
        path = os.path.join(CSRC_DIR, file_name)
        if os.path.isfile(path):
            digest.update(file_name.encode())
            with open(path, "rb") as fp:
                digest.update(fp.read())
    return digest.hexdigest()[:16]


def _ptxas_summary(report: str) -> str:
    """One line per kernel of ``-Xptxas -v``'s report: the entry's mangled
    name (template arguments ``h``/``f`` for uint8/float32, ``Lb``/``Li``
    for flags), registers, spilled bytes, static shared memory."""
    entry = re.compile(r"Compiling entry function '(\w+)'")
    spills = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
    used = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
    lines, name, spilled = [], None, (0, 0)
    for line in report.splitlines():
        if entry.search(line):
            name = entry.search(line).group(1)
        elif spills.search(line):
            spilled = tuple(int(g) for g in spills.search(line).groups())
        elif name and used.search(line):
            regs, smem = used.search(line).groups()
            lines.append(f"[ptxas] {name[:72]}: {regs} registers, spill stores/loads "
                         f"{spilled[0]}/{spilled[1]} B, static smem {smem or 0} B")
            name = None
    return "\n".join(lines)


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same ``csrc/`` and
    flags exists; returns its path.  ``verbose`` adds ``-Xptxas -v`` to a
    build and prints the compiler's report (registers, spills, shared
    memory of every kernel instantiation)."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    key = _sources_key()
    report = _compile(name, key, lambda: [_nvcc(), *flags, "-I", CSRC_DIR], source_path(name))
    if verbose and report is not None:
        print(_ptxas_summary(report), flush=True)
    return _library_path(name, key)


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    return found


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with ``g++`` (``GXX_FLAGS``) unless a
    library of the same ``csrc/`` and flags exists; returns its path."""
    key = _sources_key(GXX_FLAGS)
    _compile(name, key, lambda: [_gxx(), *GXX_FLAGS], source_path(name, ".cpp"))
    return _library_path(name, key)


def _library_path(name: str, key: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}_{key}.so")


def _compile(name: str, key: str, command: Callable[[], List[str]], source: str) -> Optional[str]:
    """Run ``command() -o <tmp> source`` unless the library of ``key``
    exists, then move it into place; returns the compiler's stderr, or
    None when the library was there already."""
    out = _library_path(name, key)
    if os.path.exists(out):
        return None
    argv = command()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*argv, "-o", tmp, source], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(argv[0])} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stderr


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
