"""What a cell is, read from data: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration, traffic and chips and the metrics
it reports; the configuration is ``configs/<name>.json``, the traffic
``traffic/<traffic>.json``, the limits of the correctness check
``limits/<cell>.json``, each metric a reader ``metrics/<name>.py``, each
lattice (the configuration's ``lattice.geometry``) a file
``reference/lattices/<geometry>.py`` of its sites and bonds (see
``reference/hamiltonian.py``) and each model kind a file
``reference/kinds/<kind>.py``, or ``<kind>_<geometry>.py`` off the
hypercubic lattice, of its reference forward, weight layout and work count
(see ``reference/models.py``; the rules are ``reference/files.py``). A new
cell, configuration, lattice, model kind, traffic mix or metric is a new
file here and an entry in ``BENCHMARK.json``; no code changes.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List

from benchmark.reference import files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the benchmark's folder under a checkout's root
FOLDER = "benchmark"


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """Everything a run of cell ``name`` needs: its ``BENCHMARK.json``
    entry (``workload``), the configuration entry and file (``config``,
    ``config_meta``), the traffic parameters, the limits, and the metrics
    it reports (``end_to_end``, ``per_layer``: the entries whose
    ``workloads`` name it, or that have none). A configuration whose
    lattice or model kind has no file raises here, naming it, before any
    run."""
    spec = benchmark(root)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    meta = _load_json(os.path.join(root, conf["file"]))
    here = os.path.join(root, FOLDER)
    lattice = files.lattice_path(meta["config"])
    if not os.path.exists(os.path.join(root, lattice)):
        raise FileNotFoundError(
            f"configuration {conf['name']!r} is on a lattice with no file: "
            f"{lattice} (its sites, bonds and sublattices) is missing")
    kind = files.kind_path(meta["config"])
    if not os.path.exists(os.path.join(root, kind)):
        raise FileNotFoundError(
            f"configuration {conf['name']!r} is of a model kind with no "
            f"file: {kind} (its reference forward, weight layout and work "
            f"count) is missing")
    traffic = _load_json(os.path.join(here, "traffic",
                                      f"{work['traffic']}.json"))
    limits_path = os.path.join(here, "limits", f"{name}.json")
    limits = _load_json(limits_path) if os.path.exists(limits_path) else {}

    def mine(metrics: List[dict]) -> List[dict]:
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return {"name": name, "root": root, "workload": work,
            "config": meta["config"],
            "config_meta": meta, "weight_std": meta.get("weight_std"),
            "traffic": traffic,
            "limits": limits.get("limits", {}),
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def reader(metric: str, root: str = ROOT) -> Callable[[dict], object]:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return files.load(
        os.path.join(root, FOLDER, "metrics", f"{metric}.py"),
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}"
    ).read


def read_metrics(metrics: List[dict], run: dict,
                 root: str = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something in ``run``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
