"""The readings a cell's limits are set from, in one process.

    python -m portbench.limits --workload <cell> --seeds 12 --control-seeds 3 \\
        --first-seed <n> --seconds 3 --out limits_<cell>.json

runs the cell as the benchmark does (short windows at the cell's own load)
on ``--seeds`` seeds, then the control, the program in the precision
below the configuration's (the configuration's ``control``: its own
bfloat16 path, or TF32 for a float32 configuration), on
``--control-seeds`` of the same seeds, then each fault of ``portbench/faults.py`` the cell can have
planted in the program, on ``--fault-seeds`` of them; it prints each run's
numbers compared and writes them all to ``--out``.  The lower reading of
a number is its largest over the sound runs, the upper its smallest over
the control's (and, for a training cell, the faults'); ``PERF.md`` gives
both and the limit set between them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import faults, harness  # noqa: E402

def readings(cell: str, seed: int, seconds: float, control: bool = False, benchmark=None) -> dict:
    """One run's numbers, ``{name: value}``: every number its entry gives,
    those the cell's file has no limit for too."""
    ctx = harness.context(cell, seed, seconds, False, "cuda", time.perf_counter(),
                          root=os.getcwd(), control=control)
    harness.run_cell(ctx, benchmark or harness.load_json("BENCHMARK.json"))
    return ctx.values


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--first-seed", type=int, default=1_000_000_007)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    benchmark = harness.load_json("BENCHMARK.json")
    seeds = [args.first_seed + i
             for i in range(max(args.seeds, args.control_seeds, args.fault_seeds))]
    cell = harness.load_cell(args.workload)
    training = cell["entry"] == "train"
    runs = [("program", False, None, seeds[:args.seeds]), ("control", True, None, seeds[:args.control_seeds])]
    runs += [(f"fault.{name}", False, name, seeds[:args.fault_seeds])
             for name in faults.applicable(cell, harness.load_config(cell["config"])) if args.fault_seeds]
    out = {"workload": args.workload}
    for kind, control, fault, run_seeds in runs:
        out[kind] = {}
        for seed in run_seeds:
            with faults.plant(fault, training) if fault else contextlib.nullcontext():
                out[kind][seed] = readings(args.workload, seed, args.seconds, control, benchmark)
            print(kind, seed, json.dumps(out[kind][seed]), file=sys.stderr, flush=True)
        values = list(out[kind].values())
        if values:
            pick = max if kind == "program" else min
            out[f"{kind}.{pick.__name__}"] = {name: pick(r[name] for r in values) for name in values[0]}
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    print(json.dumps({k: out[k] for k in out if k.endswith((".max", ".min"))}))
    print(f"total {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
