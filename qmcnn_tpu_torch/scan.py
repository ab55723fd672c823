"""Parameter-scan driver of the PyTorch port (port of
``qmcnn_tpu/scan.py``): sequential warm-started training across a grid.

  python -m qmcnn_tpu_torch.scan --config configs/tfim16_sgd.yaml \
      --param hamiltonian.h --values 3.0,2.0,1.5,1.0,0.5 \
      [--steps-per-point 400] [--out runs/scan_h] [--no-warm] \
      [--override section.key=value ...] [--device cuda|cpu]

The phase-diagram workflow: train the same ansatz at each value of one
config key, warm-starting every point from the previous point's converged
parameters ("adiabatic continuation"), so each point starts essentially
converged and the whole sweep costs little more than one cold run.
Outputs, under --out:

  point_<i>_<value>.csv     per-point metrics trace (usual format)
  point_<i>_<value>.npz     per-point converged parameters in the JAX
                            package's flat key-path format
                            (``utils/transfer.params_to_jax``): a valid
                            run.init_from for either package
  summary.csv, .json        value, E, stderr, E/site, E_exact + rel_err
                            when ED is available, seconds

Caveat, on purpose: warm starts hysterese across first-order transitions
or strong crossovers (the carried state can stay in the wrong phase for
many steps). Scan from the phase you trust toward the boundary, scan both
directions and compare, or pass --no-warm for independent cold starts.

Walkers are re-initialized and re-thermalized at every point (train()
thermalizes whenever it is not resuming a checkpoint), so only parameters
carry over.
"""
from __future__ import annotations

import argparse
import csv as _csv
import json
import os
import time
from typing import List, Optional

import numpy as np


def _parse_values(text: str) -> List[float]:
    vals = [float(v) for v in text.replace(";", ",").split(",") if v.strip()]
    if not vals:
        raise ValueError("--values parsed to an empty list")
    return vals


def _save_params_npz(params, path: str) -> int:
    """Save port params as the JAX package's flat {key-path: array} npz."""
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    flat = params_to_jax(params)
    np.savez(path, **flat)
    return len(flat)


def run_scan(base_cfg, param: str, values: List[float], out_dir: str,
             steps_per_point: Optional[int] = None, warm: bool = True,
             log=print, device="cuda") -> List[dict]:
    """Train at each value of ``param``; returns the summary rows."""
    from qmcnn_tpu_torch import configs as cfglib
    from qmcnn_tpu_torch.train import exact_reference_energy, train

    os.makedirs(out_dir, exist_ok=True)
    rows: List[dict] = []
    prev_npz: Optional[str] = None
    for i, v in enumerate(values):
        tag = f"point_{i}_{v:g}"
        overrides = [f"{param}={v}",
                     f"run.csv_path={os.path.join(out_dir, tag)}.csv",
                     "run.ckpt_dir=null",
                     "run.heartbeat_path=null"]
        if steps_per_point is not None:
            overrides.append(f"run.n_steps={steps_per_point}")
        if warm and prev_npz is not None:
            overrides.append(f"run.init_from={prev_npz}")
        cfg = cfglib.apply_overrides(base_cfg, overrides)
        log(f"scan [{i + 1}/{len(values)}] {param}={v:g}"
            + (f" (warm from {os.path.basename(prev_npz)})"
               if warm and prev_npz else " (cold start)"))
        t0 = time.time()
        state, logger = train(cfg, device=device)
        e, err = logger.tail_energy()
        logger.close()
        npz = os.path.join(out_dir, f"{tag}.npz")
        _save_params_npz(state.params, npz)
        prev_npz = npz
        lattice_sites = int(np.prod(cfg.lattice.shape))
        e_exact = exact_reference_energy(cfg)
        row = {
            "value": v, "energy": e, "stderr": err,
            "e_per_site": e / lattice_sites,
            "e_exact": e_exact,
            "rel_err": (abs(e - e_exact) / abs(e_exact)
                        if e_exact is not None else None),
            "seconds": time.time() - t0,
        }
        rows.append(row)
        log(f"scan [{i + 1}/{len(values)}] {param}={v:g}: "
            f"E = {e:.6f} +- {err:.6f}"
            + (f"  rel_err={row['rel_err']:.3e}" if e_exact is not None
               else ""))
    fields = list(rows[0].keys())
    with open(os.path.join(out_dir, "summary.csv"), "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"param": param, "warm": warm, "rows": rows}, f, indent=1)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--param", required=True,
                   help="config key to sweep, e.g. hamiltonian.h")
    p.add_argument("--values", required=True,
                   help="comma-separated numeric grid, swept in order")
    p.add_argument("--steps-per-point", type=int, default=None,
                   help="override run.n_steps at every point")
    p.add_argument("--out", default=None,
                   help="output dir (default runs/scan_<config>_<key>)")
    p.add_argument("--no-warm", action="store_true",
                   help="independent cold starts (no adiabatic carry-over)")
    p.add_argument("--override", action="append", default=[],
                   metavar="section.key=value")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)

    from qmcnn_tpu_torch import configs as cfglib

    cfg = cfglib.load(args.config, tuple(args.override))
    out = args.out or os.path.join(
        "runs", f"scan_{cfg.name}_{args.param.rsplit('.', 1)[-1]}")
    run_scan(cfg, args.param, _parse_values(args.values), out,
             steps_per_point=args.steps_per_point, warm=not args.no_warm,
             device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
