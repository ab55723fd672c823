"""Training entry point of the PyTorch port (port of ``qmcnn_tpu/train.py``):

  python -m qmcnn_tpu_torch.train --config configs/heis10x10_sr.yaml \
      [--override section.key=value ...] [--device cuda|cpu]

Runs the VMC loop on one device (CUDA by default; without a GPU the run
raises unless ``--device cpu`` is given), streams metrics to stdout/CSV,
writes the ``<csv>.params.npz`` snapshot and ``<csv>.meta.json`` manifest
in the JAX package's formats, and — for exactly diagonalizable systems
(n_sites <= 20) — reports the relative error against the ED ground energy.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch import configs as cfglib
from qmcnn_tpu_torch.builder import build, build_lattice
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.utils.metrics import MetricsLogger


def exact_reference_energy(cfg) -> Optional[float]:
    """ED ground energy for small systems (host scipy Lanczos)."""
    lattice = build_lattice(cfg)
    if lattice.n_sites > 20 or not cfg.run.validate_against_ed:
        return None
    from qmcnn_tpu_torch.ops import exact

    h = cfg.hamiltonian
    if h.kind == "tfim":
        sp = exact.sparse_tfim(lattice.n_sites, lattice.nn_bonds, j=h.j,
                               h=h.h, hz=h.hz)
    elif h.kind == "heisenberg":
        sp = exact.sparse_heisenberg(lattice.n_sites, lattice.nn_bonds, j=h.j,
                                     delta=h.delta)
    elif h.kind == "j1j2":
        sp = exact.sparse_heisenberg(lattice.n_sites, lattice.nn_bonds,
                                     j=h.j, nnn_bonds=lattice.nnn_bonds,
                                     j2=h.j2, delta=h.delta)
    elif h.kind == "xyz":
        sp = exact.sparse_xyz(lattice.n_sites, lattice.nn_bonds, jx=h.jx,
                              jy=h.jy, jz=h.jz, hx=h.hx, hz=h.hz)
    else:
        return None
    return exact.ground_energy(sp)


def therm_chunks(total: int, per: int):
    """Chunk schedule for thermalization: [(sweep_offset, n)]. ``per <= 0``
    (or >= total) is one chunk. Each chunk draws its noise at once, so the
    chunk bounds the noise tensors' memory."""
    if total <= 0:
        return []
    if per <= 0 or per >= total:
        return [(0, total)]
    return [(off, min(per, total - off)) for off in range(0, total, per)]


def chunked_thermalize(vmc, state, key: int, walker_ids, n_sweeps: int,
                       per: int):
    """Thermalize in chunks; per-chunk keys fold in the sweep offset, so
    the schedule is deterministic in the seed."""
    for offset, n in therm_chunks(n_sweeps, per):
        state = vmc.thermalize(state, fold_in(key, offset), walker_ids,
                               n_sweeps=n)
    return state


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def train(cfg, device="cuda", logger=None):
    """Run the configured experiment; returns (final state, logger)."""
    dev = _resolve_device(device)
    if cfg.run.ckpt_dir:
        raise NotImplementedError("run.ckpt_dir: checkpoint/resume is not "
                                  "ported yet (ROADMAP.md)")
    if cfg.run.distributed or (cfg.run.n_devices or 1) > 1:
        raise NotImplementedError("walker sharding over several devices is "
                                  "not ported yet (ROADMAP.md, A10)")
    if cfg.run.nan_policy not in ("rollback", "halt", "ignore"):
        raise ValueError(f"unknown run.nan_policy {cfg.run.nan_policy!r}")
    vmc, params, lattice = build(cfg, device=dev)
    n_sites = lattice.n_sites
    m = cfg.sampler.n_walkers
    logger = logger or MetricsLogger(
        csv_path=cfg.run.csv_path, print_every=cfg.run.log_every,
        tensorboard_dir=cfg.run.tensorboard_dir)
    if cfg.run.init_from:
        from qmcnn_tpu_torch.utils.transfer import warm_start

        params = warm_start(params, cfg.run.init_from,
                            expand=cfg.run.init_expand)
        if cfg.run.init_noise > 0:
            # relative isotropic kick: init_noise x each leaf's own RMS
            gen = torch.Generator().manual_seed(cfg.run.seed + 424242)
            params = {k: v + cfg.run.init_noise * torch.sqrt(torch.mean(v * v))
                      * torch.randn(v.shape, generator=gen).to(dev)
                      for k, v in params.items()}

    key = prng_key(cfg.run.seed + 100)
    walker_ids = torch.arange(m, device=dev)
    state = vmc.init_state(fold_in(key, 0), m, params, device=dev)
    state = chunked_thermalize(vmc, state, fold_in(key, 1), walker_ids,
                               cfg.sampler.n_therm_sweeps,
                               cfg.run.therm_sweeps_per_dispatch)

    e_exact = exact_reference_energy(cfg)
    sweeps_per_step = cfg.sampler.n_sweeps_per_step
    base_key = fold_in(key, 2)
    # metrics come to the host once per chunk of steps (no checkpoints to
    # roll back to yet, so 'rollback' acts as 'halt')
    per = max(cfg.run.steps_per_dispatch, 1)
    it = 0
    while it < cfg.run.n_steps:
        chunk = min(per, cfg.run.n_steps - it)
        t0 = time.perf_counter()
        state, metrics = vmc.run_steps(state, base_key, walker_ids, chunk)
        rows = [[float(x) for x in (mt.energy_re, mt.energy_im, mt.energy_var,
                                    mt.accept_rate, mt.grad_norm,
                                    mt.sr_iters)] for mt in metrics]
        dt = (time.perf_counter() - t0) / chunk
        e_re = np.asarray([r[0] for r in rows])
        if cfg.run.nan_policy != "ignore" and not np.isfinite(e_re).all():
            bad_step = it + int(np.flatnonzero(~np.isfinite(e_re))[0]) + 1
            raise RuntimeError(
                f"non-finite energy at step {bad_step} "
                f"(run.nan_policy={cfg.run.nan_policy}, no checkpoint to "
                "roll back to) — a diverged state NaNs every later step; "
                "lower optimizer.lr or raise sr.diag_shift0")
        for j, (er, ei, ev, acc, gn, sri) in enumerate(rows):
            step_no = it + j + 1
            if step_no % cfg.run.log_every == 0 or step_no == cfg.run.n_steps:
                row = {
                    "energy_re": er,
                    "energy_im": ei,
                    "energy_var": ev,
                    "e_per_site": er / n_sites,
                    "accept": acc,
                    "grad_norm": gn,
                    "sr_iters": int(sri),
                    "sweeps_per_sec": sweeps_per_step * m / max(dt, 1e-9),
                }
                if e_exact is not None:
                    row["rel_err"] = abs(er - e_exact) / abs(e_exact)
                logger.log(step_no, row)
        it += chunk

    e_tail, e_err = logger.tail_energy()
    print(f"final energy (tail mean): {e_tail:.6f} +- {e_err:.6f}"
          f"  ({e_tail / n_sites:.6f}/site)")
    if e_exact is not None:
        rel = abs(e_tail - e_exact) / abs(e_exact)
        print(f"exact: {e_exact:.6f}  relative error: {rel:.3e}")
    if cfg.run.csv_path:
        _write_manifest(cfg, e_tail, e_err, e_exact, n_sites, dev)
        _write_snapshot(cfg, state)
    return state, logger


def _write_snapshot(cfg, state) -> None:
    """Final params as '<csv_path>.params.npz' in the JAX package's flat-key
    format (readable by ``qmcnn_tpu.utils.transfer.load_checkpoint_params``
    and usable as ``run.init_from`` by either package)."""
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    flat = params_to_jax(state.params)
    path = cfg.run.csv_path + ".params.npz"
    np.savez(path, **flat)
    n_mb = sum(v.nbytes for v in flat.values()) / 1e6
    print(f"# snapshot: {len(flat)} params leaves ({n_mb:.2f} MB) -> {path}",
          flush=True)


def _write_manifest(cfg, e_tail, e_err, e_exact, n_sites, dev) -> None:
    """Provenance sidecar '<csv_path>.meta.json': resolved config, code
    revision, software/device environment and the headline result."""
    try:
        rev = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        rev = None
    manifest = {
        "name": cfg.name,
        "config": cfglib.to_yaml(cfg),
        "git_rev": rev,
        "torch_version": torch.__version__,
        "python_version": platform.python_version(),
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else platform.processor()),
        "n_devices": 1,
        "finished_unix": time.time(),
        "final_energy_tail": e_tail,
        "final_energy_stderr": e_err,
        "e_per_site": e_tail / n_sites,
        "e_exact": e_exact,
        "rel_err": (abs(e_tail - e_exact) / abs(e_exact)
                    if e_exact is not None else None),
    }
    with open(cfg.run.csv_path + ".meta.json", "w") as f:
        json.dump(manifest, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--override", action="append", default=[],
                   metavar="section.key=value")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    cfg = cfglib.load(args.config, tuple(args.override))
    print(f"=== {cfg.name} ===")
    print(cfglib.to_yaml(cfg))
    train(cfg, device=args.device)


if __name__ == "__main__":
    main()
