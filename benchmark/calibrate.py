#!/usr/bin/env python3
"""Readings from which a cell's correctness limits are set.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 2 [--control-dtype bfloat16]

For each seed, one run of the cell in this process (set-up, a window of
``--seconds`` at the cell's own load, the comparison with the reference):
the checked numbers of sound runs, whose largest is a limit's lower
reading.  For each control seed, the same run's kept answers held against
the reference computed in the control's precision instead of the
program's output: the smallest of those is the upper reading.  Prints one
JSON line a run and a summary line; not part of a benchmark run.
"""

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param", action="append", default=[],
                    help="key=JSON value: a cell parameter set for this "
                         "calibration only")
    args = ap.parse_args(argv)
    import torch

    harness.set_cache_dirs(harness.ROOT)
    spec = harness.load_spec()
    _, cell, _, config = harness.find_cell(spec, args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    dtype = getattr(torch, args.control_dtype)
    params = dict(cell["params"])
    for kv in args.param:
        k, v = kv.split("=", 1)
        params[k] = json.loads(v)
    harness.set_host_threads(torch, cell)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sound, ctrl = {}, {}
    for seed in sorted(set(seeds) | controls):
        ctx = harness.Context(args.device, seed)
        c = driver.Cell(config, dict(params), ctx)
        c.setup()
        c.window(args.seconds)
        row = {"seed": seed, "e2e": c.end_to_end()}
        c.free()
        if seed in seeds:
            row["sound"] = {n: v for n, v, _ in c.check()}
            for n, v in row["sound"].items():
                sound[n] = max(sound.get(n, v), v)
        if seed in controls:
            row["control"] = {n: v for n, v, _ in c.control(dtype)}
            for n, v in row["control"].items():
                ctrl[n] = min(ctrl.get(n, v), v)
        print(json.dumps(row), flush=True)
        del c
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": sound,
                      "upper": ctrl, "control_dtype": args.control_dtype}),
          flush=True)


if __name__ == "__main__":
    main()
