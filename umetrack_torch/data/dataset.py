"""Dataset discovery, rank/worker sharding and threaded prefetch.

The port's own copy of ``umetrack_tpu/data/dataset.py`` (numpy only):

- torch_data folders are discovered by the presence of ``<field>.torch.idx``
  files; the split is the leaf folder name;
- :class:`Sampler` is the distributed index sharding contract: optional
  shuffle, pad-or-drop to equalize per-rank counts, round-robin
  ``indices[rank::world]``, then a second round-robin over loader workers;
- a bounded thread-pool prefetcher: frames come from mmap, and decode and
  transform run in worker threads while the device consumes earlier
  batches.

A folder's files are read by the native reader (``data/native.py``, C++
built with ``g++`` at first use) when it builds, as the JAX package reads
them, or by the Python reader :class:`~umetrack_torch.data.idxbin.IdxBinFile`
(``UMETRACK_NATIVE_IO=0``, ``native=False`` or ``preload=True``).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import fs
from .idxbin import IDX_SUFFIX, IdxBinFile
from .split import Split

logger = logging.getLogger(__name__)


def find_torchdata_folders(
    root: str, fields: Sequence[str]
) -> List[str]:
    """Folders under ``root`` containing ``<field>.torch.idx`` for every
    requested field."""
    out = []
    for cur_dir, _dirs, files in fs.walk(root):
        if all(f"{field}{IDX_SUFFIX}" in files for field in fields):
            out.append(cur_dir)
    return sorted(out)


def _native_reader_builds() -> bool:
    from . import native

    try:
        native.load_library()
    except (RuntimeError, OSError) as exc:
        logger.warning("the native idx/bin reader does not build (%s): reading in Python", exc)
        return False
    return True


class FolderDataset:
    """One torch_data folder: a dict of equally-long idx/bin fields.

    ``native=True`` reads through the native reader (raises if it cannot be
    built), ``False`` through the Python reader, and ``None`` (the default)
    takes the native reader when it builds, unless ``UMETRACK_NATIVE_IO=0``
    is set; which one was taken is logged and kept in ``self.native``.
    ``preload`` pulls every .bin into RAM up front (Python reader)."""

    def __init__(
        self, folder: str, fields: Sequence[str], native: Optional[bool] = None,
        preload: bool = False,
    ):
        self.folder = folder
        self.fields = tuple(fields)
        if preload:
            native = False
        elif native is None:
            native = os.environ.get("UMETRACK_NATIVE_IO", "1") != "0" and _native_reader_builds()
        self.native = native
        if native:
            from .native import NativeIdxBin as opener
        else:
            opener = IdxBinFile.open
        logger.info("reading %s with the %s reader", folder, "native" if native else "Python")
        self._files: Dict[str, Any] = {
            f: opener(fs.join(folder, f + IDX_SUFFIX)) for f in fields
        }
        if preload:
            for file in self._files.values():
                file.preload()
        lengths = {f: len(v) for f, v in self._files.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged fields in {folder}: {lengths}")
        self._len = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return {f: v[i] for f, v in self._files.items()}


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]


def find_dataset(
    roots: Sequence[str] | str, fields: Sequence[str],
    preload: bool = False, native: Optional[bool] = None,
) -> Dict[Split, ConcatDataset]:
    """Discover datasets under one or more roots, grouped by split (the leaf
    folder name).  ``preload`` pulls every .bin into RAM up front;
    ``native`` picks the reader as :class:`FolderDataset` does."""
    if isinstance(roots, str):
        roots = [roots]
    by_split: Dict[Split, List[FolderDataset]] = {s: [] for s in Split}
    for root in roots:
        for folder in find_torchdata_folders(root, fields):
            leaf = fs.basename(folder)
            for split in Split:
                if leaf == split.value:
                    by_split[split].append(
                        FolderDataset(folder, fields, native=native, preload=preload)
                    )
    return {s: ConcatDataset(ds) for s, ds in by_split.items() if ds}


def subsample_indices(n: int, num: int) -> np.ndarray:
    """Evenly-spread deterministic subsample of ``num`` indices out of ``n``."""
    if num >= n:
        return np.arange(n)
    return np.linspace(0, n - 1, num).round().astype(np.int64)


class MappedDataset:
    """Lazy item-wise map preserving length and indexing."""

    def __init__(self, fn: Callable, dataset):
        self.fn = fn
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        return self.fn(self.dataset[i])


def map_dataset(fn: Callable, dataset) -> MappedDataset:
    return MappedDataset(fn, dataset)


def subsample(dataset, num: Optional[int] = None, portion: Optional[float] = None):
    """Evenly-spread subset view of a dataset."""
    n = len(dataset)
    if num is None:
        if portion is None or not 0 < portion <= 1:
            raise ValueError("give num, or a portion in (0, 1]")
        num = max(1, int(round(n * portion)))
    idx = subsample_indices(n, num)
    return _IndexView(dataset, idx)


class _IndexView:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


@dataclasses.dataclass
class Sampler:
    """Distributed/worker-aware index sharding.

    * shuffle: permute indices with ``seed`` before sharding
    * distrib_info: (rank, world_size); indices are padded (repeat from the
      front) or dropped so every rank gets the same count, then sharded
      round-robin ``indices[rank::world]``
    * worker round-robin happens at iteration time via ``shard_for_worker``
    """

    n: int
    shuffle: bool = False
    seed: int = 0
    distrib_info: Tuple[int, int] = (0, 1)
    pad_to_equal: bool = True

    def rank_indices(self) -> np.ndarray:
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            idx = np.random.default_rng(self.seed).permutation(idx)
        rank, world = self.distrib_info
        if world > 1:
            rem = len(idx) % world
            if rem:
                if self.pad_to_equal:
                    idx = np.concatenate([idx, idx[: world - rem]])
                else:
                    idx = idx[: len(idx) - rem]
            idx = idx[rank::world]
        return idx

    def shard_for_worker(self, worker_id: int, num_workers: int) -> np.ndarray:
        idx = self.rank_indices()
        if num_workers > 1:
            idx = idx[worker_id::num_workers]
        return idx


def prefetch_map(
    fn: Callable[[Any], Any],
    items: Iterator[Any],
    num_threads: int = 4,
    max_prefetch: int = 16,
) -> Iterator[Any]:
    """Map ``fn`` over ``items`` with a bounded thread-pool pipeline,
    preserving order.

    At most ``max_prefetch`` results are in flight; iteration order is
    input order; worker exceptions re-raise at the consumption point; early
    close drains cleanly.
    """
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=num_threads)
    # Bounded queue: the feeder blocks when max_prefetch results are in
    # flight, which is what bounds memory.  (+1 slot for the None sentinel so
    # the feeder can always terminate.)
    pending: "queue.Queue" = queue.Queue(maxsize=max_prefetch + 1)
    stop = threading.Event()

    def feeder():
        try:
            for item in items:
                if stop.is_set():
                    break
                fut = pool.submit(fn, item)
                while not stop.is_set():
                    try:
                        pending.put(fut, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    fut.cancel()
                    break
        finally:
            pending.put(None)

    feeder_thread = threading.Thread(target=feeder, daemon=True)
    feeder_thread.start()

    try:
        while True:
            fut = pending.get()
            if fut is None:
                break
            yield fut.result()
    finally:
        stop.set()

        def drain():
            while True:
                try:
                    leftover = pending.get_nowait()
                except queue.Empty:
                    return
                if leftover is not None:
                    leftover.cancel()

        drain()  # unblock a feeder stuck in put()
        feeder_thread.join(timeout=2.0)
        drain()
        # cancel_futures drops queued work; a future already running its fn
        # finishes in the background (daemon pool threads, no join).
        pool.shutdown(wait=False, cancel_futures=True)


def iterate_dataset(
    dataset,
    sampler: Sampler,
    transform: Optional[Callable] = None,
    num_threads: int = 4,
    max_prefetch: int = 16,
    worker: Tuple[int, int] = (0, 1),
) -> Iterator[Any]:
    """Sharded, prefetched, optionally-transformed iteration."""
    indices = sampler.shard_for_worker(*worker)

    def load(i):
        item = dataset[int(i)]
        return transform(item) if transform is not None else item

    yield from prefetch_map(load, iter(indices), num_threads, max_prefetch)
