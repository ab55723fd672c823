"""Time-evolution entry point of the PyTorch port (t-VMC, ``ops/tdvp.py``;
port of ``qmcnn_tpu/evolve.py``):

  # real-time quench, the standard protocol: train the ground state of
  # the PRE-quench Hamiltonian (h=2), then evolve it under the quenched
  # one (h=1.2)
  python -m qmcnn_tpu_torch.evolve --config configs/tfim16_sgd.yaml \\
      --override 'lattice.shape=[12]' --override hamiltonian.h=1.2 \\
      --override model.complex_params=true --mode real \\
      --init-from runs/tfim12_h2.csv.params.npz --dt 0.005 --steps 362 \\
      --solver dense --diag-shift 0.0001 --sampling fullsum \\
      --csv quench.csv --corr-csv quench_corr.csv

  # imaginary-time flow to the ground state (deterministic full-sum TDVP)
  python -m qmcnn_tpu_torch.evolve --config configs/tfim16_sgd.yaml \\
      --mode imag --dt 0.05 --steps 400 --sampling fullsum --solver dense

Initial state: ``--init-from`` (a ``.params.npz`` snapshot or a port
checkpoint, as ``measure`` reads them: e.g. the ground state of the
pre-quench Hamiltonian), ``--init-zero`` (all parameters zero: log psi
identically 0, the product state |+x>^N; ``--init-perturb`` adds Gaussian
noise of that scale, since exact zeros are a dead point of the manifold for
conv + lncosh models), or the model's fresh init.

Sampling: ``--sampling fullsum`` enumerates the basis (exact expectations,
n_sites <= ~16 free / ~18 in the S^z = 0 sector); ``--sampling mc``
advances the config's Metropolis walkers alongside the state.

Per step the CSV gets the JAX package's columns in its order: time, energy
(conserved in real time), its variance, the TDVP projection error
epsilon^2, the solver's residual, steps per second and the observables
(staggered M^2, and for the TFIM <sigma_x>/N and the nearest-neighbour
<sigma_z sigma_z> per bond). ``--corr-csv`` logs the full equal-time
C(r, t) = <S^z_0 S^z_r>(t), which ``analyze --quench-spectrum`` turns into
omega(q).

The Jacobian differentiates the model; log psi, E_loc, the Born weights,
the observables and the sampler evaluate through the builder's evaluation
forward (``builder.evaluation_forward``): on CUDA the sweep kernel's
recompute forward for an eligible real f32 CNN, and its fused sweep
(``builder.resolve_sampler_backend``). It runs on CUDA by default (without
a GPU it raises unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch import configs as cfglib
from qmcnn_tpu_torch.builder import (build_hamiltonian, build_lattice,
                                     build_model, evaluation_forward,
                                     model_log_psi_is_real, resolve_move,
                                     resolve_sampler_backend)
from qmcnn_tpu_torch.models.cnn import log_psi_apply
from qmcnn_tpu_torch.ops.hamiltonians import TFIM
from qmcnn_tpu_torch.ops.tdvp import (TDVP, all_states, expectation,
                                      state_weights)
from qmcnn_tpu_torch.sampler.metropolis import (MetropolisSampler, fold_in,
                                                prng_key)
from qmcnn_tpu_torch.train import _resolve_device
from qmcnn_tpu_torch.utils.metrics import MetricsLogger
from qmcnn_tpu_torch.utils.profiling import annotate, recording, unit

#: the spans of a step that ``--timings`` reports
PHASES = ("weights", "sample", "forward", "jacobian", "solve", "observables")


def initial_params(cfg, model, device, init_from: Optional[str] = None,
                   init_zero: bool = False, init_perturb: float = 1e-3):
    """The evolution's starting params: ``init_from`` warm-started into the
    model's fresh init, or (``init_zero``) zeros plus Gaussian noise of
    scale ``init_perturb`` from a generator seeded by ``run.seed + 1`` (one
    draw per leaf in sorted key order), or the fresh init from
    ``run.seed``."""
    params = model.init(cfg.run.seed, device=device)
    if init_from:
        from qmcnn_tpu_torch.utils.transfer import warm_start

        return warm_start(params, init_from)
    if init_zero:
        gen = torch.Generator().manual_seed(cfg.run.seed + 1)
        out = {}
        for k in sorted(params):
            p = torch.zeros_like(params[k])
            if init_perturb:
                p = p + init_perturb * torch.randn(
                    p.shape, generator=gen, dtype=p.dtype).to(device)
            out[k] = p
        return out
    return params


def evolve(cfg, mode: str = "imag", dt: float = 0.01, n_steps: int = 100,
           solver: str = "minsr", diag_shift: float = 1e-4,
           integrator: str = "heun", sampling: str = "fullsum",
           init_from: Optional[str] = None, init_zero: bool = False,
           init_perturb: float = 1e-3,
           sector: str = "auto", csv_path: Optional[str] = None,
           log_every: int = 1, corr_csv: Optional[str] = None,
           device="cuda"):
    """Run the evolution on ``device``; returns (final params, logger).

    Each step's parts are spans (:data:`PHASES`), carrying the step index:
    ``weights`` (full sum: the Born weights, the predictor's included) or
    ``sample`` (MC: refresh and sweeps), ``forward`` (log psi and E_loc of
    each TDVP stage), ``jacobian``, ``solve`` and ``observables``."""
    if mode == "real" and model_log_psi_is_real(cfg):
        # a real-parameter ansatz has a purely real tangent space, which
        # is orthogonal to the real-time TDVP velocity -i(H - <H>)|psi>:
        # theta-dot is identically zero and the state never moves
        raise ValueError(
            "mode='real' needs a complex-capable ansatz: this model's log "
            "psi is real, so the real-time TDVP velocity projects to zero "
            "and the state cannot move. Set model.complex_params=true (or "
            "use a complex model family).")
    if cfg.model.lanczos_alpha is not None:
        raise ValueError("evolve runs the bare model: model.lanczos_alpha "
                         "(the (1 + alpha H) training wrapper) does not "
                         "apply")
    dev = _resolve_device(device)
    lattice = build_lattice(cfg)
    ham = build_hamiltonian(cfg, lattice)
    model = build_model(cfg, lattice)

    def log_psi_fn(params, s):
        return log_psi_apply(model, params, s)

    eval_fn = evaluation_forward(cfg, lattice, dev, log_psi_fn)
    params = initial_params(cfg, model, dev, init_from, init_zero,
                            init_perturb)
    with_im = not (mode == "imag" and model_log_psi_is_real(cfg))
    tdvp = TDVP(log_psi_fn=log_psi_fn, ham=ham, mode=mode, solver=solver,
                diag_shift=diag_shift, with_im=with_im,
                jacobian_chunk=cfg.sr.jacobian_chunk,
                chunk_size=cfg.run.chunk_size, eval_log_psi_fn=eval_fn)

    # observables beyond the energy: the diagonal ones inline; <sigma_x>
    # through the operator-as-Hamiltonian trick (the TFIM with J = 0,
    # h = 1 has the local value -sum_i sigma_x)
    n = lattice.n_sites
    bonds = torch.as_tensor(np.asarray(lattice.nn_bonds, np.int64),
                            device=dev)
    stag = torch.as_tensor(1 - 2 * lattice.sublattice_mask,
                           dtype=torch.float32, device=dev)
    sx_op = (TFIM(lattice, j=0.0, h=1.0) if cfg.hamiltonian.kind == "tfim"
             else None)
    if corr_csv is not None and lattice.basis != 1:
        raise ValueError("--corr-csv needs a 1-site-basis lattice")
    shifts = [tuple(int(c) for c in lattice.coords[r]) for r in range(n)]
    axes = tuple(range(1, 1 + lattice.ndim))

    def weighted_corr(s, w):
        # C(r) = <S^z_0 S^z_r>, translation-averaged and weighted, so the
        # same code serves the Born weights and MC's uniform ones
        m = s.shape[0]
        sz = s.reshape(m, *lattice.shape) / 2.0
        return torch.stack([
            ((sz * torch.roll(sz, shifts=sh, dims=axes)).reshape(m, -1)
             .mean(dim=1) * w).sum() for sh in shifts])

    def observables(p, s, w):
        with annotate("observables"), torch.no_grad():
            zz = (s[:, bonds[:, 0]] * s[:, bonds[:, 1]]).mean(dim=1)
            ms = (s * stag[None, :]).mean(dim=1)
            out = {"szsz_nn": (w * zz).sum(), "stag_m2": (w * ms * ms).sum()}
            if corr_csv is not None:
                out["_corr"] = weighted_corr(s, w)
            if sx_op is not None:
                out["sx"] = -expectation(eval_fn, p, sx_op, s, w).re / n
        return out

    def advance(p, s, w, resample=None):
        if integrator == "heun":
            return tdvp.step_heun(p, dt, s, w, resample=resample)
        return tdvp.step_euler(p, dt, s, w)

    sz_zero = (sector == "sz0" if sector != "auto"
               else cfg.hamiltonian.kind in ("heisenberg", "j1j2"))
    if sampling == "fullsum":
        states = torch.as_tensor(all_states(n, sz_zero=sz_zero), device=dev)

        def resample(p):
            with annotate("weights"):
                return states, state_weights(eval_fn, p, states)

        def run_step(p, walkers, key):
            s, w = resample(p)
            new, r = advance(p, s, w, resample=resample)
            return new, walkers, r, observables(p, s, w)
        walkers = None
    elif sampling == "mc":
        move = resolve_move(cfg)
        sampler = MetropolisSampler(
            eval_fn, n_sites=n, move=move,
            bonds=lattice.nn_bonds if move.startswith("exchange") else None,
            sweep_size=cfg.sampler.sweep_size,
            backend=resolve_sampler_backend(cfg, dev),
            lattice_shape=tuple(lattice.shape))
        m = cfg.sampler.n_walkers
        ids = torch.arange(m, device=dev)
        w_mc = torch.full((m,), 1.0 / m, device=dev)
        with torch.no_grad():
            walkers = sampler.init_state(params, prng_key(cfg.run.seed + 1),
                                         m, device=dev)
            walkers = sampler.sample(params, walkers,
                                     prng_key(cfg.run.seed + 2), ids,
                                     n_sweeps=cfg.sampler.n_therm_sweeps)

        def run_step(p, ws, key):
            with annotate("sample"), torch.no_grad():
                ws = sampler.reset_counters(ws)
                ws = sampler.refresh(p, ws)
                ws = sampler.sample(p, ws, key, ids,
                                    n_sweeps=cfg.sampler.n_sweeps_per_step)
            new, r = advance(p, ws.s, w_mc)  # Heun reuses the samples
            return new, ws, r, observables(p, ws.s, w_mc)
    else:
        raise ValueError(f"unknown sampling {sampling!r}")

    logger = MetricsLogger(csv_path=csv_path, print_every=log_every)
    corr_file = None
    if corr_csv is not None:
        corr_file = open(corr_csv, "w")
        corr_file.write("t," + ",".join(f"c{r}" for r in range(n)) + "\n")
    key = prng_key(cfg.run.seed + 3)
    t0 = time.perf_counter()
    try:
        for it in range(n_steps):
            unit(it)
            params, walkers, r, obs = run_step(params, walkers,
                                               fold_in(key, it))
            corr_t = obs.pop("_corr", None)
            last = (it + 1) % log_every == 0 or it + 1 == n_steps
            if corr_file is not None and last:
                corr_file.write(",".join(
                    [f"{(it + 1) * dt:.6f}"]
                    + [f"{v:.8f}" for v in corr_t.tolist()]) + "\n")
                corr_file.flush()
            # the blowup check runs every step: the energy, then one
            # param-norm scalar (a params-first failure)
            e_re = float(r.energy.re)
            bad = not np.isfinite(e_re)
            if not bad:
                pnorm = float(sum(p.abs().sum() for p in params.values()))
                bad = not np.isfinite(pnorm)
            if bad or last:
                row = {
                    "t": (it + 1) * dt,
                    "energy_re": e_re,
                    "energy_im": float(r.energy.im),
                    "e_per_site": e_re / n,
                    "e_var": float(r.e_var),
                    "tdvp_error": float(r.tdvp_error),
                    "solver_residual": float(r.residual),
                    "steps_per_sec": (it + 1) / max(
                        time.perf_counter() - t0, 1e-9),
                }
                for k in sorted(obs):  # JAX's jitted dict: sorted keys
                    row[k] = float(obs[k])
                logger.log(it + 1, row)
                if bad:
                    # terminal: the parameter state itself is non-finite;
                    # the history up to here is valid dynamics
                    # (read_corr_csv trims the rest)
                    print(f"# non-finite state at t={row['t']:.4f} "
                          f"(step {it + 1}) — halting the trajectory",
                          flush=True)
                    break
    finally:
        if corr_file is not None:
            corr_file.close()
        logger.close()
    return params, logger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--override", action="append", default=[],
                   metavar="section.key=value")
    p.add_argument("--mode", choices=["imag", "real"], default="imag")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--solver", choices=["dense", "minsr"], default="minsr")
    p.add_argument("--diag-shift", type=float, default=1e-4)
    p.add_argument("--integrator", choices=["euler", "heun"], default="heun")
    p.add_argument("--sampling", choices=["fullsum", "mc"], default="fullsum")
    p.add_argument("--init-from", help="a .params.npz snapshot or a port "
                   "checkpoint for the initial state")
    p.add_argument("--init-zero", action="store_true",
                   help="zero all params: the |+x>^N product state")
    p.add_argument("--init-perturb", type=float, default=1e-3,
                   help="gaussian scale added to --init-zero params "
                        "(0 = exact zeros; those are a dead TDVP point "
                        "for conv+lncosh models)")
    p.add_argument("--sector", choices=["auto", "sz0", "free"],
                   default="auto", help="fullsum basis sector")
    p.add_argument("--csv", dest="csv_path")
    p.add_argument("--corr-csv", dest="corr_csv",
                   help="also log the full equal-time C(r, t) correlation "
                        "function to this CSV (FFT -> S(q, t): light-cone "
                        "spreading / order melting after a quench)")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--timings", action="store_true",
                   help="diagnostic: also print one JSON line of seconds "
                        "per part of the steps (the spans' device time on "
                        "CUDA, host time on the CPU) and the CUDA kernels' "
                        "launch counts")
    args = p.parse_args(argv)
    cfg = cfglib.load(args.config, tuple(args.override))
    print(f"=== evolve {cfg.name}: mode={args.mode} dt={args.dt} "
          f"steps={args.steps} sampling={args.sampling} ===")
    with (recording() if args.timings
          else contextlib.nullcontext()) as window:
        evolve(cfg, mode=args.mode, dt=args.dt, n_steps=args.steps,
               solver=args.solver, diag_shift=args.diag_shift,
               integrator=args.integrator, sampling=args.sampling,
               init_from=args.init_from, init_zero=args.init_zero,
               init_perturb=args.init_perturb,
               sector=args.sector, csv_path=args.csv_path,
               log_every=args.log_every, corr_csv=args.corr_csv,
               device=args.device)
    if window is not None:
        from qmcnn_tpu_torch.kernels.gcnn_forward import gcnn_group_sums
        from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep

        print(json.dumps({"timings_s": window.seconds(PHASES),
                          "n_steps": args.steps, "launches": {
                              "k1": metropolis_sweep.launches,
                              "k2_f32": gcnn_group_sums.launches,
                              "k2_bf16": gcnn_group_sums.launches_bf16}}))


if __name__ == "__main__":
    main()
