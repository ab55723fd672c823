"""The benchmark of qmcnn_tpu_torch, one run of one cell:

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration, traffic and cards; the traffic's ``driver`` (``drivers/``)
runs set-up, the measured window and the correctness check. With
``--trace 0`` the last line of standard output holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each beside ``correct``
(the comparison of ``check.py``), ``attempted``, ``failed`` and ``device``;
the numbers compared are printed with their limits as the last lines of
standard error and under the line's last key, ``checked``.

Without CUDA, or with fewer cards than the cell asks for, the run exits
with 2 and prints no result; so it does when JAX or the JAX package has
been imported once the window has closed (exit 3). Every cell runs on one
card: a cell on several cards needs a launcher of one process per card,
which no committed cell uses yet.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "qmcnn_tpu")
#: the build and kernel caches live at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def set_environment() -> None:
    # one intra-op host thread (a user's default run has one per core): the
    # steps are bound by the host's launches, and idle intra-op workers
    # only contend with it
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
    os.environ["USE_FLAX"] = "0"


def pin_to_core() -> None:
    """Keep this process, and the threads it starts, on one core of its
    allowed set: the host-bound loop is then not migrated mid-window. The
    core follows the card the process is given (the first entry of
    ``CUDA_VISIBLE_DEVICES``), so runs on different cards of one machine
    take different cores; one card takes one process."""
    import zlib

    cores = sorted(os.sched_getaffinity(0))
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    index = zlib.crc32(card.encode()) if not card.isdigit() else int(card)
    os.sched_setaffinity(0, {cores[-1 - index % len(cores)]})


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(chips: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def result_line(cell: dict, run: dict, trace: bool, device: dict) -> dict:
    """The run's JSON line (without ``correct``' reasons, which follow)."""
    from benchmark import check, devtrace, spec

    numbers = run["numbers"]
    limits = cell["limits"]
    metrics = spec.read_metrics(
        cell["per_layer"] if trace else cell["end_to_end"], run,
        cell["root"])
    if trace:
        device = dict(device, busy_s=run.get("busy_s", 0.0),
                      window_s=run.get("trace_window_s", 0.0))
    energies = run["energies"]
    failed = sum(1 for e in energies if not e == e or abs(e) == float("inf"))
    line = {"correct": check.verdict(numbers, limits) and failed == 0,
            "attempted": len(energies), "failed": failed,
            "metrics": metrics, "device": device}
    if trace and run.get("devtrace"):
        line["breakdown"] = devtrace.breakdown(run["devtrace"])
    line["checked"] = check.compared(numbers, limits)
    return line


def run_cell(args, cell: dict, device="cuda") -> dict:
    """The cell's driver (``drivers/<traffic driver>.py``) over one run."""
    import importlib

    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    return driver.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    from benchmark import spec

    cell = spec.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    pin_to_core()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"cell {args.workload} asks for {chips} cards; this harness "
              f"runs one-card cells only", file=sys.stderr)
        return 2
    run = run_cell(args, cell)
    device = device_info(1, run["memory_peak_bytes"])
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, run, bool(args.trace), device)
    from benchmark import check

    print(f"set-up by phase (s): {json.dumps(run['setup_phases'])}",
          file=sys.stderr)
    extra = {k: v for k, v in run["numbers"].items()
             if k not in cell["limits"]}
    print(f"diagnostics: {json.dumps(dict(run.get('diagnostics', {}), **extra))}",
          file=sys.stderr)

    for text in check.limit_lines(run["numbers"], cell["limits"]):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
