"""Readings that the limits of a cell's correctness check are set from, on
the chip at the cell's own size, many seeds in one process:

  python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
      [--seconds 0.5] [--witness] [--out <readings>.jsonl]

For each seed it runs the cell's set-up and a short window through the
cell's driver, then prints one JSON line with the program's numbers (the
lower readings), the control's (the reference in the precision below the
configuration's, put in the program's place) and those of the faults
planted in it (``check.train_controls``, ``check.measure_controls``). The
benchmark's own runs never run the control.

``--witness`` (training cells of a bf16 configuration) adds two readings
that say where the program's gaps come from: the reference in bf16 against
the reference (``bf16``), and the program itself run at float32, its
float32 kernel route, against the reference (``program_f32``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _driver(cell: dict):
    import importlib

    return importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")


def readings(cell: dict, seed: int, seconds: float, device="cuda",
             witness: bool = False) -> dict:
    """{"program", "control", <fault>...} numbers of one seed."""
    from benchmark import check

    run = _driver(cell).run(cell, seed, seconds, False, device,
                            time.perf_counter())
    cfg, stash, params = cell["config"], run["stash"], run["params"]
    rec = {"seed": seed, "program": run["numbers"],
           "program_detail": run.get("diagnostics", {}),
           "steps": run.get("steps", run.get("samples"))}
    if cell["traffic"]["driver"] == "train":
        start = int(cell["traffic"]["start_step"])
        del run
        rec.update(check.train_controls(cfg, params, stash, start, start,
                                        witness))
        if witness and cfg["model"]["compute_dtype"] == "bfloat16":
            del stash
            f32 = copy.deepcopy(cell)
            f32["config"]["model"]["compute_dtype"] = "float32"
            run = _driver(f32).run(f32, seed, seconds, False, device,
                                   time.perf_counter())
            rec["program_f32"] = dict(run["numbers"],
                                      **run.get("diagnostics", {}))
    else:
        rec.update(check.measure_controls(cfg, params, stash))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--witness", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import run as bench
    from benchmark import spec

    bench.set_environment()
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out = open(args.out, "a")
    try:
        for seed in seeds:
            line = json.dumps(readings(cell, seed, args.seconds,
                                       witness=args.witness))
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
