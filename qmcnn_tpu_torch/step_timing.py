"""Per-phase time of training steps on a CUDA device:

  python -m qmcnn_tpu_torch.step_timing --config configs/j1j2_8x8_gcnn.yaml \
      [--override section.key=value ...] [--therm 20] [--steps 3]

Builds the config on ``cuda``, thermalizes ``--therm`` sweeps from the
seeded walkers and times ``--steps`` training steps after one warm-up step,
phase by phase: sample (refresh and sweeps), E_loc (in sector mode the
sector ratio estimator), deflation (with ``optimizer.deflate_c``: the
frozen states' forwards on the live walkers and the live model on the
frozen batches), gradient (the surrogate-loss backward and an additive
penalty's, the forwards above excluded), SR and update. Each phase ends
with a device synchronize and is read on the host clock. Prints one JSON
line: the config name, the card, the mean ms per step of each phase and
their total.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from qmcnn_tpu_torch import configs as cfglib
from qmcnn_tpu_torch.builder import build
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.vmc import (energy_and_grad, sector_chunk_size,
                                 sector_energy_and_grad)

PHASES = ("sample", "e_loc", "gradient", "sr", "update")


def _deflation(vmc):
    """(frozen states, c) when ``vmc`` deflates, else None."""
    if vmc.penalty_states and vmc.deflate_c > 0:
        return vmc.penalty_states, vmc.deflate_c
    return None


def step_split(vmc, state, n_steps: int = 3) -> dict:
    """Mean ms per step of each phase over ``n_steps`` steps after one
    warm-up step, starting from ``state`` (params, walkers, step). With a
    walker group (``vmc.group``) this rank's split, collectives included.
    A deflating run has a ``deflation`` phase after E_loc."""
    from qmcnn_tpu_torch.ops.observables import sector_energy_ratio
    from qmcnn_tpu_torch.ops.penalty import (deflation_e_loc,
                                             penalty_value_and_grad)

    params, walkers, sr_aux = state.params, state.walkers, state.sr_aux
    opt_state = vmc.optimizer.init(params)
    group = vmc.group
    m = vmc.sampler.physical(walkers).s.shape[0]
    ids = (torch.arange(m, device=walkers.s.device) if group is None
           else group.local_ids(m))
    deflate = _deflation(vmc)
    phases = PHASES if deflate is None else (
        PHASES[:2] + ("deflation",) + PHASES[2:])
    totals = dict.fromkeys(phases, 0.0)

    def lap(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(n_steps + 1):
        t0 = time.perf_counter()
        w = vmc.sampler.refresh(params, vmc.sampler.reset_counters(walkers))
        w = vmc.sampler.sample(params, w, fold_in(prng_key(7), i), ids,
                               vmc.n_sweeps)
        t_sample = lap(t0)
        phys = vmc.sampler.physical(w)
        t0 = time.perf_counter()
        t_defl = 0.0
        if vmc.sector_momentum is not None:
            sector_energy_ratio(
                vmc.eval_log_psi_fn, params, phys.s, phys.log_psi, vmc.ham,
                tuple(vmc.lattice_shape), tuple(vmc.sector_momentum),
                chunk_size=sector_chunk_size(vmc.chunk_size,
                                             vmc.lattice_shape, m))
            t_eloc = lap(t0)
            t0 = time.perf_counter()
            _, _, grads, e_loc, _ = sector_energy_and_grad(
                vmc.log_psi_fn, vmc.ham, params, phys, vmc.lattice_shape,
                vmc.sector_momentum, kappa=vmc.sector_kappa,
                chunk_size=vmc.chunk_size,
                eval_log_psi_fn=vmc.eval_log_psi_fn, group=group)
        else:
            local_energy(vmc.eval_log_psi_fn, params, vmc.ham, phys.s,
                         phys.log_psi, chunk_size=vmc.chunk_size)
            t_eloc = lap(t0)
            if deflate is not None:
                t0 = time.perf_counter()
                deflation_e_loc(vmc.eval_log_psi_fn, params, phys.s,
                                phys.log_psi, deflate[0], group=group,
                                chunk_size=vmc.chunk_size)
                t_defl = lap(t0)
            t0 = time.perf_counter()
            _, _, grads, e_loc, _ = energy_and_grad(
                vmc.log_psi_fn, vmc.ham, params, phys,
                chunk_size=vmc.chunk_size,
                eval_log_psi_fn=vmc.eval_log_psi_fn, group=group,
                deflate=deflate)
            if vmc.penalty_states and deflate is None:
                _, pen = penalty_value_and_grad(
                    vmc.log_psi_fn, params, phys.s, vmc.penalty_states,
                    vmc.penalty_beta, group=group)
                grads = {k: grads[k] + pen[k] for k in grads}
        t_grad = lap(t0) - t_eloc - t_defl
        t0 = time.perf_counter()
        if vmc.sr is not None and sr_aux is not None:  # SPRING
            grads, _, _, sr_aux = vmc.sr.solve_spring(
                vmc.log_psi_fn, params, phys.s, grads, state.step, sr_aux,
                e_loc=e_loc, group=group)
        elif vmc.sr is not None:
            grads, _, _ = vmc.sr.solve(vmc.log_psi_fn, params, phys.s, grads,
                                       state.step, e_loc=e_loc, group=group)
        t_sr = lap(t0)
        t0 = time.perf_counter()
        upd, opt_state = vmc.optimizer.update(grads, opt_state)
        params = {k: params[k] + upd[k] for k in params}
        t_upd = lap(t0)
        walkers = w
        if i:  # the first step warms up
            times = dict(sample=t_sample, e_loc=t_eloc, deflation=t_defl,
                         gradient=t_grad, sr=t_sr, update=t_upd)
            for k in totals:
                totals[k] += times[k] / n_steps
    return totals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--override", action="append", default=[],
                   help="section.key=value (repeatable)")
    p.add_argument("--therm", type=int, default=20,
                   help="thermalization sweeps before the timed steps")
    p.add_argument("--steps", type=int, default=3, help="timed steps")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_timing needs a CUDA device")
    cfg = cfglib.load(args.config, tuple(args.override))
    vmc, params, _ = build(cfg, device="cuda")
    m = cfg.sampler.n_walkers
    key = prng_key(cfg.run.seed + 100)
    ids = torch.arange(m, device="cuda")  # physical walkers
    state = vmc.init_state(fold_in(key, 0), m, params, device="cuda")
    state = vmc.thermalize(state, fold_in(key, 1), ids, args.therm)
    ms = step_split(vmc, state, args.steps)
    print(json.dumps({"config": cfg.name,
                      "device": torch.cuda.get_device_name(0),
                      "ms": ms, "total_ms": sum(ms.values())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
