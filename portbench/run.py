"""Run one cell of the port's benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number compared with the
reference beside its limit); the last lines of standard error repeat the
numbers compared.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics.  ``--device cpu`` rehearses a cell on
the CPU (tests only: no device metric is reported there).
"""
import time

T_START = time.perf_counter()  # process start, as near as Python allows: set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# Every build and kernel cache at a fixed path inside the checkout, so that
# only a cell's first run there builds; the program builds its own CUDA
# libraries into umetrack_torch/_build/, inside the checkout as well.
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def _finite(obj):
    """Non-finite floats as the largest finite one, so the line is JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return sys.float_info.max if obj > 0 or math.isnan(obj) else -sys.float_info.max
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None, t_start: float = T_START, **overrides) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("portbench: --seed must be a whole number >= 0", file=sys.stderr)
        return 2
    benchmark = harness.load_json(ROOT, "BENCHMARK.json")
    cell_entry = next((w for w in benchmark["workloads"] if w["name"] == args.workload), None)
    if cell_entry is None:
        print(f"portbench: {args.workload!r} is not a cell of BENCHMARK.json", file=sys.stderr)
        return 2
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
            print(f"portbench: {args.workload} needs {cell_entry['chips']} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        torch.cuda.reset_peak_memory_stats()
    ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace), args.device,
                          t_start, ROOT, **overrides)
    result = _finite(harness.run_cell(ctx, benchmark))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process imported {', '.join(found)}: no result", file=sys.stderr)
        return 4
    for line in harness.compared_lines(result["compared"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
