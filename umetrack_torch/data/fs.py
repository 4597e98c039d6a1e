"""Filesystem shim: the one place a blob store would plug in."""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple


def walk(path: str) -> Iterator[Tuple[str, list, list]]:
    yield from os.walk(path)


def join(*parts: str) -> str:
    return os.path.join(*parts)


def basename(path: str) -> str:
    return os.path.basename(path)


def dirname(path: str) -> str:
    return os.path.dirname(path)


def exists(path: str) -> bool:
    return os.path.exists(path)


def open_file(path: str, mode: str = "rb"):
    return open(path, mode)


def read_bytes(path: str, start: Optional[int] = None, stop: Optional[int] = None) -> bytes:
    """Bytes ``[start, stop)`` of the file (the whole file by default)."""
    with open(path, "rb") as fp:
        if start:
            fp.seek(start)
        if stop is None:
            return fp.read()
        return fp.read(stop - (start or 0))
