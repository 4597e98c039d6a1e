"""Filesystem shim: the one place a blob store would plug in."""
from __future__ import annotations

import os
from typing import Iterator, Tuple


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
