"""Training entry point of the PyTorch port (port of ``qmcnn_tpu/train.py``):

  python -m qmcnn_tpu_torch.train --config configs/heis10x10_sr.yaml \
      [--override section.key=value ...] [--device cuda|cpu]

Runs the VMC loop on one device (CUDA by default; without a GPU the run
raises unless ``--device cpu`` is given). With ``run.distributed: true`` the
walkers shard over the ranks of ``torch.distributed``, one process per card
(where the JAX entry point drives every device of a host from one process):

  python -m torch.distributed.run --nproc_per_node=N -m qmcnn_tpu_torch.train \
      --config configs/heis10x10_sr.yaml --override run.distributed=true

over NCCL (gloo with ``--device cpu``); rank 0 alone logs and writes the
files. A single process given ``run.n_devices > 1`` raises. The run streams
metrics to stdout/CSV,
checkpoints to ``run.ckpt_dir`` (``utils/checkpoint.py``; a run whose
directory holds a checkpoint resumes from it), writes the
``<csv>.params.npz`` snapshot (and ``<csv>.ema.npz`` with
``optimizer.ema_decay``) and the ``<csv>.meta.json`` manifest in the JAX
package's formats, and — for exactly diagonalizable systems
(n_sites <= 20) — reports the relative error against the ED ground energy.

Liveness (the JAX loop's, for ``qmcnn_tpu_torch.supervise``): with
``run.heartbeat_path`` rank 0 rewrites '<step> <unix-time>' there after
every completed chunk of steps, the first beat only after the first chunk,
and appends timestamped ``dispatch_start`` / ``dispatch_end`` /
``save_start`` / ``save_end`` / ``save_ping`` lines to
'<heartbeat>.events'; ``run.dispatch_warn_s`` starts a watchdog around
each chunk that prints a warning when the device has stalled;
``run.save_settle_s`` sleeps after the device ping that follows each
periodic save; ``run.steps_per_dispatch <= 0`` sizes the chunk from two
timed, unlogged single steps to a ~40 s budget; ``run.checkify`` runs the
steps under ``utils/debug.checked``. The JAX entry point's
``enable_compilation_cache`` has no counterpart: the port compiles nothing
at run time but its CUDA kernels, which ``kernels/nvcc.py`` caches in
``qmcnn_tpu_torch/_build/`` already.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import threading
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


def check_rank_layout(cfg, group, module: str) -> None:
    """Raise ``ValueError`` where the config's rank layout cannot run: several
    devices in one process (the port runs one process per card, started by
    torchrun; ``module`` is named in the command it suggests), or a walker
    group without ``run.distributed``."""
    if not cfg.run.distributed and (cfg.run.n_devices or 1) > 1:
        raise ValueError(
            f"run.n_devices={cfg.run.n_devices} in one process: the port runs "
            "one process per card, so start them with torchrun (python -m "
            "torch.distributed.run --nproc_per_node="
            f"{cfg.run.n_devices} -m {module} ... --override "
            "run.distributed=true)")
    if group is not None and not cfg.run.distributed:
        raise ValueError("a walker group needs run.distributed: true")


def _heartbeat(path: Optional[str], step: int) -> None:
    """Liveness marker for qmcnn_tpu_torch.supervise: '<step> <unix-time>'.

    Rewritten after every completed chunk; the supervisor watches the mtime
    and restarts the run (from its checkpoint) if it goes stale.
    Best-effort: a failed write never kills training. Atomic (tmp +
    rename): the supervisor polls concurrently, and an open("w")
    truncation window would let it read an empty file and take a live
    child for one that never beat."""
    if not path:
        return
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{step} {time.time()}\n")
        os.replace(tmp, path)
    except OSError:
        pass


def _event(hb_path: Optional[str], name: str, step: int,
           extra: str = "") -> None:
    """Append '<unix-time> <name> <step> [extra]' to <heartbeat>.events:
    timestamped chunk and save bounds, so the interval from a save to a
    stall is a measured quantity. Best-effort, append-only (the
    supervisor never reads it)."""
    if not hb_path:
        return
    try:
        with open(hb_path + ".events", "a") as f:
            f.write(f"{time.time():.3f} {name} {step}"
                    + (f" {extra}" if extra else "") + "\n")
    except OSError:
        pass


def _post_save_settle(cfg, hb_path: Optional[str], step: int, dev) -> None:
    """Device ping (+ optional cool-down) between a save and the next
    chunk: if the save stalled the host or the device, the ping absorbs and
    measures the stall instead of the next chunk. The ping (a one-element
    add and ``torch.cuda.synchronize``, on CUDA only) lands in .events."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.ones(1, device=dev).add_(1.0)
        torch.cuda.synchronize(dev)
    _event(hb_path, "save_ping", step, f"{time.perf_counter() - t0:.3f}s")
    if cfg.run.save_settle_s > 0:
        time.sleep(cfg.run.save_settle_s)


def _metric_rows(metrics) -> list:
    """Per step (energy_re, energy_im, energy_var, accept, grad_norm,
    sr_iters, overlap) as floats: the chunk's one device-to-host read."""
    return [[float(x) for x in (mt.energy_re, mt.energy_im, mt.energy_var,
                                mt.accept_rate, mt.grad_norm, mt.sr_iters,
                                mt.overlap)]
            for mt in metrics]


def train(cfg, device="cuda", ckpt_manager=None, logger=None, group=None):
    """Run the configured experiment; returns (final state, logger).

    With ``ckpt_manager`` (``utils.checkpoint.CheckpointManager``) the state
    is saved every ``run.ckpt_every`` steps and at the end; if the manager
    holds a checkpoint already, the run resumes from it (no warm start, no
    thermalization, the CSV appended), and ``run.nan_policy: rollback``
    restores the latest checkpoint on a non-finite energy.

    With ``run.distributed`` this process is one rank of the walker group
    (``group``, else the default process group, which must be initialized:
    ``parallel.mesh.init_distributed``): the state holds its walkers, its
    device is the group's, and only rank 0 logs and writes files (the
    heartbeat and its events too)."""
    if cfg.run.nan_policy not in ("rollback", "halt", "ignore"):
        raise ValueError(f"unknown run.nan_policy {cfg.run.nan_policy!r}")
    check_rank_layout(cfg, group, "qmcnn_tpu_torch.train")
    m = cfg.sampler.n_walkers
    if cfg.run.distributed:
        from qmcnn_tpu_torch.builder import build_sharded
        from qmcnn_tpu_torch.parallel.mesh import walker_group

        if group is None:
            group = walker_group(cfg.run.n_devices, device)
        sharded, params, lattice = build_sharded(cfg, group)
        vmc, dev = sharded.vmc, group.device
    else:
        dev = _resolve_device(device)
        vmc, params, lattice = build(cfg, device=dev)
        sharded = None
    is_main = group is None or group.rank == 0
    n_sites = lattice.n_sites
    resuming = (ckpt_manager is not None
                and ckpt_manager.latest_step() is not None)
    logger = logger or MetricsLogger(
        csv_path=cfg.run.csv_path if is_main else None,
        print_every=cfg.run.log_every if is_main else 0,
        tensorboard_dir=cfg.run.tensorboard_dir if is_main else None,
        # a resumed run must not truncate the earlier attempt's CSV
        append=resuming)
    if cfg.run.init_from and not resuming:
        from qmcnn_tpu_torch.utils.transfer import warm_start

        params = warm_start(params, cfg.run.init_from,
                            step=cfg.run.init_from_step,
                            expand=cfg.run.init_expand)
        if cfg.run.init_noise > 0:
            # relative isotropic kick: init_noise x each leaf's own RMS
            gen = torch.Generator().manual_seed(cfg.run.seed + 424242)
            params = {k: v + cfg.run.init_noise * torch.sqrt(torch.mean(v * v))
                      * torch.randn(v.shape, generator=gen).to(dev)
                      for k, v in params.items()}

    key = prng_key(cfg.run.seed + 100)
    if sharded is None:
        state = vmc.init_state(fold_in(key, 0), m, params, device=dev)
        walker_ids = torch.arange(m, device=dev)
    else:  # this rank's walkers and their global ids
        state = sharded.init_state(fold_in(key, 0), m, params)
        walker_ids = sharded.local_ids(state)
    n_rep = getattr(vmc.sampler, "n_replicas", 1)
    if resuming:
        state = ckpt_manager.restore(state, group=group, n_replicas=n_rep)
        if is_main:
            print(f"resumed from checkpoint at step {state.step}", flush=True)
    else:
        state = chunked_thermalize(vmc, state, fold_in(key, 1), walker_ids,
                                   cfg.sampler.n_therm_sweeps,
                                   cfg.run.therm_sweeps_per_dispatch)

    e_exact = exact_reference_energy(cfg) if is_main else None
    sweeps_per_step = cfg.sampler.n_sweeps_per_step
    nan_retries = 0
    base_key0 = fold_in(key, 2)
    base_key = base_key0  # the per-step key is fold_in(base_key, step)
    run_steps = vmc.run_steps
    if cfg.run.checkify:
        from qmcnn_tpu_torch.utils.debug import checked

        run_steps = checked(vmc.run_steps)
    it = state.step
    # the first beat comes only after the first completed chunk: the
    # supervisor's short stall timeout runs from the first beat, and its
    # startup timeout covers the warm start, thermalization and the build
    hb_path = cfg.run.heartbeat_path if is_main else None
    per = cfg.run.steps_per_dispatch
    if per <= 0:
        # auto-size: time one single-step chunk (after the first, which may
        # build the kernels) and fill a ~40 s budget. The timing steps are
        # real training steps and their state is kept (the per-step key
        # derives from state.step); only their metrics go unlogged.
        t0 = time.perf_counter()
        state, m0 = run_steps(state, base_key, walker_ids, 1)
        _metric_rows(m0)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, m0 = run_steps(state, base_key, walker_ids, 1)
        _metric_rows(m0)
        dt1 = max(time.perf_counter() - t0, 1e-6)
        it = min(it + 2, cfg.run.n_steps)
        per = max(1, min(100, int(40.0 / dt1)))
        _heartbeat(hb_path, it)
        if is_main:
            print(f"auto steps_per_dispatch: per-step {dt1:.3f}s (first "
                  f"{first:.1f}s) -> {per}", flush=True)
    while it < cfg.run.n_steps:
        chunk = min(per, cfg.run.n_steps - it)
        t0 = time.perf_counter()
        watchdog = None
        if cfg.run.dispatch_warn_s > 0:
            watchdog = threading.Timer(
                cfg.run.dispatch_warn_s,
                lambda: print(
                    f"WARNING: dispatch at step {it} has been blocked for "
                    f"> {cfg.run.dispatch_warn_s:.0f}s — the device may "
                    "have stalled (a healthy chunk here takes "
                    "steps_per_dispatch x per-step time). If this repeats, "
                    "restart the run; it resumes from the last checkpoint.",
                    flush=True))
            watchdog.daemon = True
            watchdog.start()
        _event(hb_path, "dispatch_start", it)
        try:
            state, metrics = run_steps(state, base_key, walker_ids, chunk)
            rows = _metric_rows(metrics)
        finally:
            if watchdog is not None:
                watchdog.cancel()
        dt = (time.perf_counter() - t0) / chunk
        _event(hb_path, "dispatch_end", it + chunk)
        _heartbeat(hb_path, it + chunk)
        e_re = np.asarray([r[0] for r in rows])
        # the energies are all-reduce outputs, the same on every rank, so
        # every rank takes this branch alike
        if cfg.run.nan_policy != "ignore" and not np.isfinite(e_re).all():
            bad_step = it + int(np.flatnonzero(~np.isfinite(e_re))[0]) + 1
            no_ckpt = (ckpt_manager is None
                       or ckpt_manager.latest_step() is None)
            if (cfg.run.nan_policy != "rollback" or no_ckpt
                    or nan_retries >= cfg.run.nan_max_retries):
                raise RuntimeError(
                    f"non-finite energy at step {bad_step} "
                    f"(run.nan_policy={cfg.run.nan_policy}"
                    + (f", retries exhausted {nan_retries}"
                       if nan_retries else "")
                    + (", no checkpoint to roll back to" if no_ckpt else "")
                    + ") — a diverged state NaNs every later step; lower "
                    "optimizer.lr or raise sr.diag_shift0")
            nan_retries += 1
            state = ckpt_manager.restore(state, group=group,
                                         n_replicas=n_rep)
            it = state.step
            # a replay from the checkpoint would NaN at the same step:
            # re-fold the key so the retry draws another sample path
            base_key = fold_in(base_key0, nan_retries)
            if is_main:
                print(f"non-finite energy at step {bad_step}: rolled back "
                      f"to checkpoint step {it} with a re-folded key (retry "
                      f"{nan_retries}/{cfg.run.nan_max_retries})",
                      flush=True)
            continue
        for j, (er, ei, ev, acc, gn, sri, ovl) in enumerate(rows):
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
                if cfg.optimizer.orthogonalize_to:
                    row["overlap"] = ovl
                if cfg.optimizer.sector_momentum is not None:
                    # the overlap slot carries the sector weight |<P_q>|
                    row["sector_weight"] = ovl
                if e_exact is not None:
                    row["rel_err"] = abs(er - e_exact) / abs(e_exact)
                logger.log(step_no, row)
        it += chunk
        if (ckpt_manager is not None and (it // cfg.run.ckpt_every)
                > ((it - chunk) // cfg.run.ckpt_every)):
            _event(hb_path, "save_start", it)
            ckpt_manager.save(it, state, group=group)
            _event(hb_path, "save_end", it)
            _post_save_settle(cfg, hb_path, it, dev)

    if ckpt_manager is not None:
        _event(hb_path, "save_start", cfg.run.n_steps)
        ckpt_manager.save(cfg.run.n_steps, state, group=group)
        _event(hb_path, "save_end", cfg.run.n_steps)
    if not is_main:
        return state, logger
    e_tail, e_err = logger.tail_energy()
    print(f"final energy (tail mean): {e_tail:.6f} +- {e_err:.6f}"
          f"  ({e_tail / n_sites:.6f}/site)")
    if e_exact is not None:
        rel = abs(e_tail - e_exact) / abs(e_exact)
        print(f"exact: {e_exact:.6f}  relative error: {rel:.3e}")
    if cfg.run.csv_path:
        _write_manifest(cfg, e_tail, e_err, e_exact, n_sites, dev,
                        1 if group is None else group.world_size)
        _write_snapshot(cfg, state)
    return state, logger


def _write_snapshot(cfg, state) -> None:
    """Final params as '<csv_path>.params.npz', and the EMA (when on) as
    '<csv_path>.ema.npz' with the same keys, in the JAX package's flat-key
    format (readable by ``qmcnn_tpu.utils.transfer.load_checkpoint_params``
    and usable as ``run.init_from`` by either package)."""
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    for field, tree in (("params", state.params), ("ema", state.ema)):
        if tree is None:
            continue
        flat = params_to_jax(tree)
        path = f"{cfg.run.csv_path}.{field}.npz"
        np.savez(path, **flat)
        n_mb = sum(v.nbytes for v in flat.values()) / 1e6
        print(f"# snapshot: {len(flat)} {field} leaves ({n_mb:.2f} MB) -> "
              f"{path}", flush=True)


def _write_manifest(cfg, e_tail, e_err, e_exact, n_sites, dev,
                    world_size: int) -> None:
    """Provenance sidecar '<csv_path>.meta.json': resolved config, code
    revision, software/device environment (one process per card: devices
    = processes = ranks) and the headline result."""
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
        "n_devices": world_size,
        "n_processes": world_size,
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
    group = None
    if cfg.run.distributed:
        # before any device use: the rank's card and the process group
        from qmcnn_tpu_torch.parallel.mesh import init_distributed

        group = init_distributed(cfg.run, device=args.device)
    if group is None or group.rank == 0:
        print(f"=== {cfg.name} ===")
        print(cfglib.to_yaml(cfg))
    ckpt = None
    if cfg.run.ckpt_dir:
        from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(cfg.run.ckpt_dir, keep=cfg.run.ckpt_keep)
    try:
        train(cfg, device=args.device, ckpt_manager=ckpt, group=group)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
