"""Orbax ``StandardCheckpointer`` directories, read and written without orbax.

Counterpart of the directory branch of ``umetrack_tpu/utils/checkpoints.py``
(orbax 0.11 with OCDBT and zarr v2, its defaults).  A checkpoint directory
holds:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf to its key
  tuple (``key_metadata``) and value type, with ``use_ocdbt: true`` and
  ``use_zarr3: false``;
- ``_CHECKPOINT_METADATA``: JSON naming the item handler and timestamps;
- an OCDBT store at the directory's root (``utils/ocdbt.py``) in which each
  leaf is a zarr v2 array named by its keys joined with ``.``: the key
  ``<name>/.zarray`` holds the array's JSON metadata and ``<name>/<i>.<j>``
  its chunks, zstd-compressed.

Reading takes the tree's structure from the key tuples, never from the
dotted names, and refuses what it does not read (zarr3, filters, a
compressor other than zstd, Fortran order, a directory without OCDBT).
Writing stores each array as one chunk in a zstd frame of stored blocks
(raw zstd blocks: about 17.0 MB for ``checkpoints/synthetic.msgpack``'s
weights, which orbax compresses to 15.8 MB); orbax and tensorstore read it.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time
import uuid
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from . import _zstd
from .ocdbt import OcdbtStore, write_store

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                "StandardCheckpointHandler")
DICT_KEY = 2  # orbax ``KeyType.DICT``
ARRAY_VALUE_TYPES = ("np.ndarray", "jax.Array")


class OrbaxError(ValueError):
    """A checkpoint directory in a layout this module does not read."""


def _leaf_keys(path: str, entry: Mapping[str, Any]) -> Tuple[str, ...]:
    keys = []
    for item in entry["key_metadata"]:
        if item.get("key_type") != DICT_KEY:
            raise OrbaxError(f"{path}: only nested dicts are read; found key {item!r}")
        keys.append(str(item["key"]))
    value_type = entry.get("value_metadata", {}).get("value_type")
    if value_type not in ARRAY_VALUE_TYPES:
        raise OrbaxError(f"{path}: leaf {keys} is a {value_type!r}, not an array")
    return tuple(keys)


def _fill_value(value: Any) -> Any:
    if value is None:
        return 0
    if isinstance(value, str):  # zarr v2 spells non-finite floats as strings
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def _read_array(store: OcdbtStore, name: str, where: str) -> np.ndarray:
    meta_key = f"{name}/.zarray"
    if meta_key not in store:
        raise OrbaxError(f"{where}: array {name!r} has no .zarray")
    meta = json.loads(store.read(meta_key))
    if meta.get("zarr_format") != 2:
        raise OrbaxError(f"{where}: {name}: zarr format {meta.get('zarr_format')!r}, expected 2")
    if meta.get("order", "C") != "C":
        raise OrbaxError(f"{where}: {name}: order {meta['order']!r} is not read (only C)")
    if meta.get("filters"):
        raise OrbaxError(f"{where}: {name}: zarr filters {meta['filters']!r} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxError(f"{where}: {name}: compressor {compressor.get('id')!r} is not read "
                         "(only zstd or none)")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as exc:
        raise OrbaxError(f"{where}: {name}: dtype {meta['dtype']!r} is not read") from exc
    if dtype.kind not in "biuf":
        raise OrbaxError(f"{where}: {name}: dtype {meta['dtype']!r} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxError(f"{where}: {name}: shape {shape} and chunks {chunks} differ in rank")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill_value(meta.get("fill_value")), dtype=dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(str(i) for i in index) if index else '0'}"
        if key not in store:
            continue  # a chunk equal to the fill value is not stored
        raw = store.read(key)
        if compressor is not None:
            raw = _zstd.decompress(raw)
        count = math.prod(chunks)
        if len(raw) != count * dtype.itemsize:
            raise OrbaxError(f"{where}: {key}: {len(raw)} bytes for a chunk of {chunks} {dtype}")
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out.astype(dtype.newbyteorder("="), copy=False)


def read_standard_checkpoint(path: str) -> Dict[str, Any]:
    """The variables of the orbax ``StandardCheckpointer`` directory at
    ``path`` as nested dicts of numpy arrays."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no such checkpoint directory")
    if not os.path.isfile(meta_path):
        raise OrbaxError(f"{path} is no orbax checkpoint (no {METADATA})")
    with open(meta_path) as fp:
        meta = json.load(fp)
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path}: zarr3 arrays (use_zarr3) are not read; save with zarr v2, "
                         "orbax's default")
    if not meta.get("use_ocdbt"):
        raise OrbaxError(f"{path}: a checkpoint without OCDBT (use_ocdbt false) is not read")
    store = OcdbtStore(path)
    variables: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = _leaf_keys(path, entry)
        node = variables
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = _read_array(store, ".".join(keys), path)
    return variables


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out.extend(_flatten(value, prefix + (str(key),)))
        else:
            out.append((prefix + (str(key),), np.ascontiguousarray(value)))
    return out


def _zarray(a: np.ndarray) -> bytes:
    meta = {
        "chunks": [max(1, s) for s in a.shape], "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": a.dtype.str, "fill_value": None, "filters": None,
        "order": "C", "shape": list(a.shape), "zarr_format": 2,
    }
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def write_standard_checkpoint(path: str, variables: Mapping[str, Any]) -> str:
    """Write nested dicts of arrays as an orbax ``StandardCheckpointer``
    directory at ``path``, which the JAX package's ``load_checkpoint``
    restores.  Everything is written into a temporary directory beside
    ``path``, which then takes its place; an existing directory at
    ``path`` is replaced, as orbax's ``force=True`` does.  A run killed
    before the swap leaves the previous checkpoint untouched (and a
    ``.<name>.tmp-*`` directory beside it); one killed between its two
    renames leaves it whole as ``.<name>.old-*``."""
    started = time.time_ns()
    path = os.path.abspath(path)
    leaves = _flatten(variables)
    if not leaves:
        raise ValueError("no arrays to write")
    items: Dict[str, bytes] = {}
    tree_metadata: Dict[str, Any] = {}
    for keys, a in leaves:
        if a.dtype.kind not in "biuf":
            raise TypeError(f"{keys}: dtype {a.dtype} is not written")
        name = ".".join(keys)
        items[f"{name}/.zarray"] = _zarray(a)
        if a.size:
            items[f"{name}/{'.'.join('0' * a.ndim) or '0'}"] = _zstd.frame_stored(a.tobytes())
        tree_metadata[repr(keys)] = {
            "key_metadata": [{"key": k, "key_type": DICT_KEY} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
        }
    folder, name = os.path.split(path)
    os.makedirs(folder, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=folder)
    try:
        write_store(tmp, items)
        metadata = {"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                    "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
        with open(os.path.join(tmp, METADATA), "w") as fp:
            json.dump(metadata, fp)
        checkpoint_metadata = {
            "item_handlers": ITEM_HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {},
        }
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as fp:
            json.dump(checkpoint_metadata, fp)
        os.chmod(tmp, 0o755)
        old = None
        if os.path.lexists(path):
            old = os.path.join(folder, f".{name}.old-{uuid.uuid4().hex}")
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        if os.path.isdir(old) and not os.path.islink(old):
            shutil.rmtree(old)
        else:
            os.remove(old)
    return path
