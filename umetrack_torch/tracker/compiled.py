"""Captured CUDA graphs of the tracker's steps: the port's counterpart of
the JAX tracker's ``jax.jit``.

A jitted JAX step is compiled once for its static arguments and its input
shapes, and every later call dispatches that one program without the host
waiting inside it.  :class:`CompiledStep` gives a PyTorch step the same
contract on a CUDA device:

- the first call with a new key runs the step eagerly, and that run is
  the call's result; it is the warm-up too (kernels loaded, cuDNN's
  algorithms picked, cuBLAS's workspaces made, the staged warp's
  shared-memory limit raised).  Then the step is captured into a
  ``torch.cuda.CUDAGraph`` on static copies of the inputs;
- every later call with that key copies its inputs into those static
  tensors, replays the graph and returns **clones** of the static outputs,
  as a JAX call returns fresh arrays (a caller may keep several calls'
  results alive at once).

The key holds what ``jax.jit`` retraces on (the step, the static arguments,
each input leaf's shape and dtype, the device, the model and its compute
dtype) and what a capture bakes in that JAX does not have: each input's
strides, the cuDNN / TF32 / reduced-precision switches of
``torch.backends`` (:func:`backend_flags`: a graph captured with TF32 on
would replay TF32 with it off), the model's train / eval mode and the data
pointers of its parameters and buffers (a model whose tensors were replaced
recaptures; a ``load_state_dict`` in place keeps the pointers, and the
replay reads the new values).

The graphs of all steps share one cache of the last :data:`CAPACITY` keys;
an evicted graph is reset, which hands its memory pool back to PyTorch's
allocator.  A failed capture raises with the key and the cause: there is
no eager fallback on the card.  On the CPU a step runs directly.

The warp kernels count their launches in Python (``ops/warp_pool.py``,
``ops/warp_image.py``), where they are launched, and a replay runs no
Python.  So the launches a capture records are taken back off the counters
(nothing ran), and each replay adds them again: the counters go on
counting the kernels that ran on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ops.warp_image import warp_image_full, warp_image_windowed
from ..ops.warp_pool import warp_pool

CAPACITY = 4  # graphs kept, over all steps
COUNTED = (warp_pool, warp_image_full, warp_image_windowed)  # wrappers with launch counters


def backend_flags() -> tuple:
    """The ``torch.backends`` switches that pick the kernels a capture
    records."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
        cuda.allow_bf16_reduced_precision_reduction, cuda.allow_fp16_reduced_precision_reduction,
        torch.get_float32_matmul_precision(),
    )


# ---- the model's storage -------------------------------------------------------

_MODULES: "weakref.WeakKeyDictionary[torch.nn.Module, list]" = weakref.WeakKeyDictionary()


def _forget_modules(*_):
    """A submodule was set somewhere: every model is walked again."""
    _MODULES.clear()


torch.nn.modules.module.register_module_module_registration_hook(_forget_modules)


def _data_pointers(model: torch.nn.Module) -> tuple:
    """The data pointers of the model's parameters and buffers, read from
    each module's own tables (a swapped tensor is seen) over a walk of the
    module tree kept until a submodule is set anywhere."""
    modules = _MODULES.get(model)
    if modules is None:
        modules = _MODULES[model] = list(model.modules())
    return tuple(t.data_ptr() for m in modules
                 for t in itertools.chain(m._parameters.values(), m._buffers.values()) if t is not None)


# ---- trees of tensors: dicts, dataclasses, tuples, tensors, None ----------------


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for item in tree.values() for leaf in _leaves(item)]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in _leaves(getattr(tree, f.name))]
    return []


def _map(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {name: _map(item, fn) for name, item in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(item, fn) for item in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _map(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)})
    return tree


def _signature(tree):
    """What a capture depends on in ``tree``: its structure, and each
    tensor's shape, dtype and strides."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.stride())
    if isinstance(tree, dict):
        return tuple((name, _signature(item)) for name, item in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_signature(item) for item in tree)
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(_signature(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return tree


# ---- the launch counters ------------------------------------------------------


def _read_counts() -> list:
    return [(w.launches, collections.Counter(getattr(w, "paths", ()))) for w in COUNTED]


def _restore_counts(saved: list) -> None:
    for w, (n, paths) in zip(COUNTED, saved):
        w.launches = n
        if hasattr(w, "paths"):
            w.paths.clear()
            w.paths.update(paths)


def _counts_since(saved: list) -> list:
    return [(w.launches - n, collections.Counter(getattr(w, "paths", ())) - paths)
            for w, (n, paths) in zip(COUNTED, saved)]


def _advance_counts(launched: list) -> None:
    for w, (n, paths) in zip(COUNTED, launched):
        w.launches += n
        if paths:
            w.paths.update(paths)


# ---- CUDA, behind one object that the CPU tests replace -------------------------


class CudaGraphs:
    """What :class:`CompiledStep` asks of CUDA."""

    @staticmethod
    def applies(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def capture(run: Callable[[], Any], device: torch.device):
        """(graph, outputs, bytes of its pool) of ``run()`` captured on a
        side stream.  ``torch.cuda.graph`` empties the allocator's cache as
        it starts; done first here, the reserved bytes before and after the
        capture differ by the graph's private pool."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            # thread-local: a caller's other threads (the streaming eval's
            # decoder) may use CUDA while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = run()
            torch.cuda.synchronize()
            return graph, outputs, torch.cuda.memory_reserved() - reserved


GRAPHS = CudaGraphs()


@dataclasses.dataclass
class Captured:
    """One key's graph, its static inputs and outputs, the launches it
    records, what its capture took: wall ms (the allocator's cache emptied,
    capture and instantiation, synchronised) and the bytes the allocator
    reserved for its pool."""

    step: str
    graph: Any
    inputs: List[torch.Tensor]
    outputs: Any
    launched: list
    capture_ms: float
    pool_bytes: int


_CACHE: "collections.OrderedDict[tuple, Captured]" = collections.OrderedDict()


def cached() -> List[Captured]:
    """The graphs in the cache, oldest first."""
    return list(_CACHE.values())


def release() -> None:
    """Reset and drop every cached graph (their pools go back to the
    allocator)."""
    while _CACHE:
        _CACHE.popitem(last=False)[1].graph.reset()


class CompiledStep:
    """``fn(model, **inputs, **static)`` compiled per key, as ``jax.jit``
    compiles a step with static arguments (see the module's docstring).

    ``inputs`` are the trees of tensors copied into the graph on every
    call; ``static`` are the hashable arguments the step is specialised
    on.  Calls run under ``torch.inference_mode``."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__

    def key(self, model: torch.nn.Module, inputs: Dict[str, Any], static: Dict[str, Any],
            device: torch.device) -> tuple:
        return (
            self.name, id(self), id(model), getattr(getattr(model, "config", None), "compute_dtype", None),
            model.training, _data_pointers(model), backend_flags(), str(device), tuple(sorted(static.items())),
            _signature(inputs),
        )

    @torch.inference_mode()
    def eager(self, model: torch.nn.Module, device: torch.device, inputs: Dict[str, Any],
              **static):
        """The step run eagerly on any device, never captured."""
        return self.fn(model, **inputs, **static)

    @torch.inference_mode()
    def __call__(self, model: torch.nn.Module, device: torch.device, inputs: Dict[str, Any],
                 **static):
        if not GRAPHS.applies(device):
            return self.fn(model, **inputs, **static)
        key = self.key(model, inputs, static, device)
        captured = _CACHE.get(key)
        if captured is None:
            return self._capture(key, model, device, inputs, static)
        _CACHE.move_to_end(key)
        for dst, src in zip(captured.inputs, _leaves(inputs)):
            dst.copy_(src)
        captured.graph.replay()
        _advance_counts(captured.launched)
        return _map(captured.outputs, torch.clone)

    def _capture(self, key: tuple, model, device, inputs, static):
        result = self.fn(model, **inputs, **static)  # the warm-up is the call's result
        static_inputs = _map(inputs, torch.clone)
        counts = _read_counts()
        t0 = time.perf_counter()
        try:
            graph, outputs, pool_bytes = GRAPHS.capture(
                lambda: self.fn(model, **static_inputs, **static), device)
        except Exception as exc:
            shown = key[:5] + (f"<{len(key[5])} data pointers>",) + key[6:]
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed for key {shown}: {exc}") from exc
        finally:
            launched = _counts_since(counts)
            _restore_counts(counts)  # a capture launches nothing
        captured = Captured(
            self.name, graph, _leaves(static_inputs), outputs, launched,
            (time.perf_counter() - t0) * 1e3, pool_bytes,
        )
        _CACHE[key] = captured
        while len(_CACHE) > CAPACITY:
            _CACHE.popitem(last=False)[1].graph.reset()
        return result


def last_capture(step: Optional[str] = None) -> Optional[Captured]:
    """The newest cached graph (of ``step``, a step function's name, if
    given), or None."""
    for captured in reversed(_CACHE.values()):
        if step is None or captured.step == step:
            return captured
    return None
