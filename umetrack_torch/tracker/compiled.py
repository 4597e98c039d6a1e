"""Captured CUDA graphs of the port's steps: the counterpart of the JAX
package's ``jax.jit`` (the tracker's entry points and calibrations, the
batched evals, the train steps, the resident trainer's steps).

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

A training step (``CompiledStep(fn, training=True)``) captures its
forward, backward and optimizer update in one graph.  What it writes in
place is made before the capture and stays at its address: the gradients
and Adam's state (``parallel/optim.py::ClippedAdamW.prepare``), the
BatchNorm running stats; its key adds the optimizer's state and the data
pointers of the resident trees it reads where they lie (a corpus on the
device), and a ``torch.Generator`` among its static arguments is registered
with the graph, so each replay draws on from the generator's state.

The graphs of all steps share one cache of the last :data:`CAPACITY` keys;
an evicted graph is reset, which hands its memory pool back to PyTorch's
allocator.  A failed capture raises with the key and the cause: there is
no eager fallback on the card.  On the CPU a step runs directly.

The port's kernels count their launches in Python (``ops/warp_pool.py``,
``ops/warp_image.py``, ``ops/bn_act.py``), where they are launched, and a
replay runs no Python.  So the launches a capture records are taken back
off the counters (nothing ran), and each replay adds them again: the
counters go on counting the kernels that ran on the card.  The same holds
for the Counters beside them (:data:`COUNTERS`: launches by path, the
model's forwards by layout).

Under a profile, a call's host time is split into the spans ``step.key``
(the key), ``step.stage`` (the copies into the static inputs),
``step.replay`` (the replay's launch) and ``step.outputs`` (the clones of
the static outputs), or ``step.capture`` (the eager run and the capture)
for a new key (``utils/profiling.py::span``).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ops.bn_act import batch_norm_act
from ..ops.warp_image import warp_image_full, warp_image_windowed
from ..ops.warp_pool import warp_pool
from ..utils.profiling import span

CAPACITY = 4  # graphs kept, over all steps
# wrappers with launch counters
COUNTED = (warp_pool, warp_image_full, warp_image_windowed, batch_norm_act)


def backend_flags() -> tuple:
    """The ``torch.backends`` switches that pick the kernels a capture
    records."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
        cuda.allow_bf16_reduced_precision_reduction, cuda.allow_fp16_reduced_precision_reduction,
        torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled(),
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


COUNTERS = ("paths", "formats")  # the Counters a wrapper may keep beside ``.launches``


def _read_counts() -> list:
    return [(w.launches, {name: collections.Counter(getattr(w, name))
                          for name in COUNTERS if hasattr(w, name)}) for w in COUNTED]


def _restore_counts(saved: list) -> None:
    for w, (n, counters) in zip(COUNTED, saved):
        w.launches = n
        for name, counts in counters.items():
            getattr(w, name).clear()
            getattr(w, name).update(counts)


def _counts_since(saved: list) -> list:
    return [(w.launches - n, {name: collections.Counter(getattr(w, name)) - counts
                              for name, counts in counters.items()})
            for w, (n, counters) in zip(COUNTED, saved)]


def _advance_counts(launched: list) -> None:
    for w, (n, counters) in zip(COUNTED, launched):
        w.launches += n
        for name, counts in counters.items():
            getattr(w, name).update(counts)


# ---- CUDA, behind one object that the CPU tests replace -------------------------


class CudaGraphs:
    """What :class:`CompiledStep` asks of CUDA."""

    @staticmethod
    def applies(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def capture(run: Callable[[], Any], device: torch.device, *generators: torch.Generator):
        """(graph, outputs, bytes of its pool) of ``run()`` captured on a
        side stream, with ``generators`` registered so that each replay
        draws on from their state as an eager call would.
        ``torch.cuda.graph`` empties the allocator's cache as it starts;
        done first here, the reserved bytes before and after the capture
        differ by the graph's private pool."""
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
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
CAPTURES: "collections.Counter[str]" = collections.Counter()  # captures made, by step


def cached() -> List[Captured]:
    """The graphs in the cache, oldest first."""
    return list(_CACHE.values())


def release() -> None:
    """Reset and drop every cached graph (their pools go back to the
    allocator)."""
    while _CACHE:
        _CACHE.popitem(last=False)[1].graph.reset()


def _state_key(static: Dict[str, Any], resident: Dict[str, Any]) -> tuple:
    """What a capture reads and writes in place beside the model: the
    optimizer's state (:meth:`ClippedAdamW.capture_key`) and the resident
    trees (their structure, shapes and data pointers: they are used where
    they lie, never copied)."""
    optimizers = tuple(v.capture_key() for _, v in sorted(static.items()) if hasattr(v, "capture_key"))
    leaves = _leaves(resident)
    return optimizers, _signature(resident), tuple(t.data_ptr() for t in leaves)


class CompiledStep:
    """``fn(model, **inputs, **resident, **static)`` compiled per key, as
    ``jax.jit`` compiles a step with static arguments (see the module's
    docstring).

    ``inputs`` are the trees of tensors copied into the graph on every
    call; ``resident`` are trees used where they lie (a corpus kept on the
    device, like the weights: keyed by data pointer); ``static`` are the
    hashable arguments the step is specialised on.  A ``torch.Generator``
    among them is registered with the graph, and an optimizer's state
    (``capture_key``) joins the key.

    An inference step (the default) runs under ``torch.inference_mode``; a
    ``training`` step runs with autograd on, so its graph holds the
    forward, the backward and the optimizer's update, all writing in place
    into tensors made before the capture (``ClippedAdamW.prepare``)."""

    def __init__(self, fn: Callable, training: bool = False):
        self.fn = fn
        self.name = fn.__name__
        self.training = training

    def _mode(self):
        return torch.enable_grad() if self.training else torch.inference_mode()

    def key(self, model: torch.nn.Module, inputs: Dict[str, Any], static: Dict[str, Any],
            device: torch.device, resident: Optional[Dict[str, Any]] = None) -> tuple:
        return (
            self.name, id(self), id(model), getattr(getattr(model, "config", None), "compute_dtype", None),
            model.training, _data_pointers(model), backend_flags(), str(device), tuple(sorted(static.items())),
            _signature(inputs), _state_key(static, resident or {}),
        )

    def eager(self, model: torch.nn.Module, device: torch.device, inputs: Dict[str, Any],
              resident: Optional[Dict[str, Any]] = None, **static):
        """The step run eagerly on any device, never captured."""
        with self._mode():
            return self.fn(model, **inputs, **(resident or {}), **static)

    def __call__(self, model: torch.nn.Module, device: torch.device, inputs: Dict[str, Any],
                 resident: Optional[Dict[str, Any]] = None, **static):
        resident = resident or {}
        with self._mode():
            if not GRAPHS.applies(device):
                return self.fn(model, **inputs, **resident, **static)
            with span("step.key"):
                key = self.key(model, inputs, static, device, resident)
            captured = _CACHE.get(key)
            if captured is None:
                with span("step.capture"):
                    return self._capture(key, model, device, inputs, resident, static)
            _CACHE.move_to_end(key)
            with span("step.stage"):
                for dst, src in zip(captured.inputs, _leaves(inputs)):
                    dst.copy_(src)
            with span("step.replay"):
                captured.graph.replay()
            _advance_counts(captured.launched)
            with span("step.outputs"):
                return _map(captured.outputs, torch.clone)

    def _capture(self, key: tuple, model, device, inputs, resident, static):
        result = self.fn(model, **inputs, **resident, **static)  # the warm-up is the call's result
        static_inputs = _map(inputs, torch.clone)
        generators = [v for v in static.values() if isinstance(v, torch.Generator)]
        counts = _read_counts()
        t0 = time.perf_counter()
        try:
            graph, outputs, pool_bytes = GRAPHS.capture(
                lambda: self.fn(model, **static_inputs, **resident, **static), device, *generators)
        except Exception as exc:
            shown = key[:5] + (f"<{len(key[5])} data pointers>",) + key[6:10] + (
                "<the optimizer's and the resident trees' data pointers>",)
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
        CAPTURES[self.name] += 1
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
