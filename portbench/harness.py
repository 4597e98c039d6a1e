"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, the metrics, the result line.

A cell's file (``portbench/workloads/<cell>.json``) names its configuration
(``portbench/configs/<config>.json``), its entry (the module
``portbench/entries/<entry>.py`` that drives the program) with the entry's
traffic parameters, and the limit of each number its comparison gives.
Which metrics a cell reports is read from ``BENCHMARK.json``; each metric
is computed by its own reader, ``portbench/metrics/<metric>.py``, from the
run's :class:`Readings`.  Nothing here lists cells or metrics.

An entry module defines ``Session(ctx)``, whose constructor is the set-up
(traffic, weights, the program, the warm-up of every shape the window
uses), with:

- ``step() -> int``: one unit of the cell's work handed to the program (a
  call, a frame, a training step), returning the frames or steps it
  covers; it need not wait for the device;
- ``drain()``: wait until everything handed over has finished;
- ``release()``: free the program's graphs and model (its outputs kept);
- ``check(readings) -> {name: value}``: the numbers compared with the
  reference, which runs now, after the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from .compare import against_limits
from .trace import DeviceTrace, Spans, breakdown, device_trace

HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_SECONDS = 2.0  # the traced window's length (shorter if the run is)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "umetrack_tpu")


@dataclasses.dataclass
class Context:
    """What a run was asked for, and the tools its entry shares."""

    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    spans: Spans = dataclasses.field(default_factory=Spans)
    control: bool = False  # the program in the precision below the configuration's (its "control")
    root: str = "."
    values: Dict[str, float] = dataclasses.field(default_factory=dict)  # every number the check gave

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def precision(self) -> dict:
        """What the program runs in: the configuration's ``tf32`` switches
        and compute dtype, or those its ``control`` names."""
        base = {"tf32": self.config["tf32"], "compute_dtype": self.config["model"]["compute_dtype"]}
        return {**base, **self.config["control"]} if self.control else base

    @property
    def compute_dtype(self) -> str:
        return self.precision["compute_dtype"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""

    cell: str
    on_card: bool
    setup_s: float
    window_s: float
    units: int  # frames tracked or optimizer steps completed in the window
    calls: int  # entry calls in the window
    spans: Dict[str, List[float]]  # host seconds by span, the window's
    captures: int  # graphs captured during the window
    trace: Optional[DeviceTrace] = None
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    flops_per_call: Optional[float] = None  # counted on the reference
    warp_bound_s_per_call: Optional[float] = None  # the pool warp's least time a call
    warp_launches_per_call: int = 0

    def median_ms(self, span: str) -> Optional[float]:
        values = self.spans.get(span)
        return statistics.median(values) * 1e3 if values else None


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def load_cell(name: str) -> dict:
    return load_json(HERE, "workloads", f"{name}.json")


def load_config(name: str) -> dict:
    return load_json(HERE, "configs", f"{name}.json")


def load_reader(metric: str):
    """The ``read(readings)`` of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def context(cell_name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            root: str = ".", cell: Optional[dict] = None, config: Optional[dict] = None,
            control: bool = False) -> Context:
    """The context of a run of ``cell_name``; ``cell`` and ``config``
    replace keys of the cell's and the configuration's files (the tests'
    tiny sizes); ``control`` runs the program in the precision below the
    configuration's (the comparison's control).  A configuration whose
    reference module or draw is wrong is refused here, before set-up."""
    from .weights import draw_for

    cell_file = {**load_cell(cell_name), **(cell or {})}
    config_file = {**load_config(cell_file["config"]), **(config or {})}
    draw_for(config_file)
    return Context(cell_name=cell_name, cell=cell_file, config=config_file, seed=seed,
                   seconds=seconds, trace=trace, device=torch.device(device), t_start=t_start,
                   control=control, root=root)


def metrics_of(benchmark: dict, cell: str, per_layer: bool) -> List[dict]:
    """The cell's end-to-end or per-layer metrics in ``BENCHMARK.json``:
    those listing it under ``workloads``, and those with no such list."""
    kind = "per_layer" if per_layer else "end_to_end"
    return [m for m in benchmark[kind] if cell in m.get("workloads", [cell])]


def captures() -> int:
    """Graphs the program has captured so far, over all its steps."""
    from umetrack_torch.tracker import compiled

    return sum(compiled.CAPTURES.values())


def forbidden_modules() -> List[str]:
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


@contextlib.contextmanager
def tf32_switches(tf32: dict):
    """cuDNN's and cuBLAS's TF32 switches as ``tf32`` says, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32["cudnn"], tf32["matmul"]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def run_cell(ctx: Context, benchmark: dict) -> dict:
    """Set up, measure, trace, compare; the result line as a dict."""
    with tf32_switches(ctx.precision["tf32"]):
        return _run_cell(ctx, benchmark)


def _run_cell(ctx: Context, benchmark: dict) -> dict:
    session = importlib.import_module(f"portbench.entries.{ctx.cell['entry']}").Session(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    captured = captures()
    spans = ctx.spans
    units = calls = 0
    gc.collect()
    gc.disable()  # no collection of the harness's own records inside the window
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            units += session.step()
            calls += 1
        session.drain()
        window_s = time.perf_counter() - t0
    finally:
        gc.enable()
    readings = Readings(
        cell=ctx.cell_name, on_card=ctx.on_card, setup_s=setup_s, window_s=window_s, units=units,
        calls=calls, spans={k: list(v) for k, v in spans.seconds.items()},
        captures=captures() - captured, latencies_s=list(getattr(session, "latencies_s", [])),
    )
    if ctx.trace and ctx.on_card:
        def traced():
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < min(TRACE_SECONDS, ctx.seconds):
                session.step()
            session.drain()

        readings.trace = device_trace(traced, spans)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.on_card else 0
    session.release()
    ctx.values = session.check(readings)
    compared = against_limits(ctx.values, ctx.cell["limits"])

    chosen = metrics_of(benchmark, ctx.cell_name, per_layer=ctx.trace)
    metrics = {}
    for m in chosen:
        value = load_reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if ctx.on_card:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device), "count": 1,
                  "memory_peak_bytes": int(peak), "power": power_limit()}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {
        "correct": all(c.ok for c in compared),
        "attempted": units,
        "failed": 0,
        "metrics": metrics,
        "device": device,
    }
    if readings.trace is not None:
        device["busy_s"] = readings.trace.busy_s
        device["window_s"] = readings.trace.window_s
        result["breakdown"] = breakdown(readings.trace)
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return result


def compared_lines(compared: Dict[str, dict]) -> List[str]:
    return [f"compared {name} {c['value']!r} limit {c['limit']!r}"
            f"{'' if c['value'] <= c['limit'] else ' FAILED'}" for name, c in compared.items()]
