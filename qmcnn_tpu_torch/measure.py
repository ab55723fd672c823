"""Measurement entry point of the PyTorch port: observables of a trained
state (port of ``qmcnn_tpu/measure.py``).

  python -m qmcnn_tpu_torch.measure --config configs/heis10x10_sr.yaml \\
      --ckpt-dir <csv>.params.npz | <checkpoint dir> [--n-samples 20] \\
      [--sweeps-between 2] [--total-spin] [--dimer] [--chirality] \\
      [--sector-momentum 0,0] [--ema] [--device cuda|cpu]

Restores the state (a ``.params.npz`` snapshot: params only and at least
50 fresh sweeps; a port checkpoint directory: the whole state, or its
params after a structure or shape mismatch), thermalizes, then alternates
sampling and measuring: the energy with its binned error, the
magnetization, the staggered moments and the Binder cumulant, S^z-S^z
correlations with the structure factor and the correlation length, the
nearest-neighbour S.S; with the flags the z-dimer correlations, the scalar
chirality, the momentum-sector energy ratio, and <S^2> of the final
walkers. It prints one JSON report with the JAX package's keys.

Measurement computes in float32 whatever the training config's dtype,
and every forward is the evaluation forward of the sampler and E_loc
(``VMC.eval_log_psi_fn``): on CUDA the fused kernels serve a bf16 GCNN
snapshot on K2's float32 route and the real CNN on K1's recompute
forward. It runs on one device in one process (CUDA by default; without
a GPU it raises unless ``--device cpu`` is given). Not ported yet
(ROADMAP.md): ``--renyi2``, ``--sma``, ``--fidelity-ckpt`` and
``--lanczos-step`` (A17b), and a measurement sharded over ranks (A17c).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch import configs as cfglib
from qmcnn_tpu_torch.builder import build
from qmcnn_tpu_torch.ops import observables
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.train import _resolve_device, chunked_thermalize
from qmcnn_tpu_torch.utils.memory import divided_chunk
from qmcnn_tpu_torch.utils.metrics import binned_stderr
from qmcnn_tpu_torch.utils.transfer import warm_start


class PhaseTimer:
    """Seconds per named phase on the host clock, the device synchronized
    at both ends of each phase: ``with timer("e_loc"): ...``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] += time.perf_counter() - t0


def _untimed(name: str):
    return contextlib.nullcontext()


def sample_estimators(log_psi_fn, params, walkers, ham, lattice, *,
                      chunk_size: Optional[int] = None, dimer: bool = False,
                      marshall: bool = False, timer=_untimed) -> dict:
    """The estimators of one sample (JAX ``measure_once``) on the physical
    walkers, through ``log_psi_fn`` (the evaluation forward): the mean
    E_loc, the magnetization, the staggered moments, the S^z-S^z
    correlation (C(r) [N] on a 1-site basis, else the sublattice-resolved
    C_ab(r) flattened), the nearest-neighbour S.S (0 off the site grid),
    and the dimer correlation and mean (zeros without ``dimer``), as 0-d
    or 1-d tensors on the walkers' device. ``timer(name)`` wraps each
    part (``e_loc``, ``nn_ss``, ``diagonal``)."""
    s, lp = walkers.s, walkers.log_psi
    n = lattice.n_sites
    on_grid = lattice.basis == 1
    with torch.no_grad():
        with timer("e_loc"):
            energy = local_energy(log_psi_fn, params, ham, s, lp,
                                  chunk_size=chunk_size).mean().re
        with timer("nn_ss"):
            if on_grid:
                nn_disp = int(np.ravel_multi_index(
                    tuple([1] + [0] * (lattice.ndim - 1)), lattice.shape))
                ss_nn = observables.spin_spin_correlation(
                    log_psi_fn, params, s, lp, lattice, nn_disp,
                    marshall=marshall, chunk_size=chunk_size).re
            else:
                ss_nn = torch.zeros((), device=s.device)
        with timer("diagonal"):
            if on_grid:
                corr = observables.szsz_correlation(s, lattice)
            else:
                corr = observables.szsz_correlation_basis(
                    s, lattice).reshape(-1)
            if dimer:
                dcorr, dmean = observables.dimer_correlation(s, lattice)
            else:
                dcorr = torch.zeros(n, device=s.device)
                dmean = torch.zeros((), device=s.device)
            mst2, mst4 = observables.staggered_moments(s, lattice)
            mag = observables.magnetization(s)
    return {"energy": energy, "magnetization": mag, "mst2": mst2,
            "mst4": mst4, "corr": corr, "ss_nn": ss_nn, "dimer_corr": dcorr,
            "dimer_mean": dmean}


def assemble_report(traces: dict, lattice, *, step: int = 0,
                    ema: bool = False) -> dict:
    """The report (JAX ``measure``'s keys) from the per-sample traces
    (``sample_estimators``' values as host numbers or arrays, one list
    entry per sample, in ``traces[name]``), with optional entries:
    ``dimer`` (True: the dimer keys), ``chirality`` (a list of per-sample
    chi), ``sector_momentum`` with ``sector_num`` / ``sector_den`` (lists
    of complex per-walker arrays), ``total_spin_sq`` (a float)."""
    n = lattice.n_sites
    e_trace = np.asarray(traces["energy"], np.float64)
    mst2 = float(np.mean(traces["mst2"]))
    mst4 = float(np.mean(traces["mst4"]))
    corr = np.mean(np.asarray(traces["corr"], np.float64), axis=0)
    report = {
        "step": int(step),
        "ema": bool(ema),
        "energy": float(np.mean(e_trace)),
        "energy_err": binned_stderr(e_trace),
        "energy_per_site": float(np.mean(e_trace)) / n,
        "magnetization": float(np.mean(traces["magnetization"])),
        "staggered_m2": mst2,
        "staggered_m4": mst4,
        "binder_cumulant": observables.binder_cumulant(mst2, mst4),
        "szsz_corr": corr.tolist(),
    }
    if lattice.basis == 1:
        sq = observables.structure_factor(corr, lattice)
        report["spin_spin_nn"] = float(np.mean(traces["ss_nn"]))
        report["structure_factor_peak"] = float(sq.max())
        report["structure_factor_peak_q_index"] = int(sq.argmax())
        report["correlation_length"] = observables.correlation_length(
            corr, lattice)
    else:
        # the sublattice-resolved C_ab(r), flattened from [b, b, n_cells]
        sq = observables.structure_factor_basis(corr, lattice)
        report["structure_factor_peak"] = float(sq.max())
        report["structure_factor_peak_q_index"] = int(sq.argmax())
        if lattice.is_bipartite_compatible:
            # bipartite by basis (honeycomb): the basis-staggered Neel
            # order parameter peaks at q = 0
            sq_st = observables.structure_factor_basis(
                corr, lattice, phases=(-1.0) ** np.arange(lattice.basis))
            report["neel_sf_q0"] = float(sq_st.reshape(-1)[0])
    if traces.get("dimer"):
        d_mean = float(np.mean(traces["dimer_mean"]))
        sd = observables.dimer_structure_factor(
            np.mean(np.asarray(traces["dimer_corr"], np.float64), axis=0),
            d_mean, lattice)
        report["dimer_mean"] = d_mean
        # columnar VBS of x-bonds peaks at q = (pi, 0) = index [Lx/2, 0]
        report["dimer_sf_pi0"] = float(sd[lattice.shape[0] // 2, 0])
        report["dimer_sf_peak"] = float(sd.max())
        report["dimer_sf_peak_q_index"] = int(sd.argmax())
    if traces.get("chirality") is not None:
        chi = np.asarray(traces["chirality"], np.float64)
        report["scalar_chirality"] = float(np.mean(chi))
        report["scalar_chirality_err"] = binned_stderr(chi)
    if traces.get("sector_momentum") is not None:
        num = np.concatenate(traces["sector_num"])
        den = np.concatenate(traces["sector_den"])
        e_q, e_q_err, w_q = observables.sector_energy_from_samples(
            C(num.real, num.imag), C(den.real, den.imag))
        report["sector_momentum"] = [int(x) for x in
                                     traces["sector_momentum"]]
        report["sector_energy"] = e_q
        report["sector_energy_err"] = e_q_err
        report["sector_weight"] = w_q  # |<psi|P_q|psi>|: a small weight
        # amplifies the variance; read the error bar, not just the mean
        report["sector_gap"] = e_q - report["energy"]
    if traces.get("total_spin_sq") is not None:
        report["total_spin_sq"] = float(traces["total_spin_sq"])
    return report


def chunk_sizes(vmc, m_walkers: int, lattice) -> tuple:
    """(E_loc walker chunk or None, total_spin_sq's pair chunk, the sector
    ratio's walker chunk): the training auto-chunk, adjusted to divide the
    walker count, bounds every measurement forward; the pair chunk fills
    the forward budget chunk x K of the train step; the sector pass
    multiplies each walker's forwards by the T translations."""
    le_chunk = vmc.chunk_size
    if le_chunk is not None:
        le_chunk = max(1, min(le_chunk, m_walkers))
        while m_walkers % le_chunk:
            le_chunk -= 1
        if le_chunk >= m_walkers:
            le_chunk = None
    fwd_budget = (le_chunk or m_walkers) * max(1, vmc.ham.n_conn)
    sec_chunk = divided_chunk(le_chunk or m_walkers,
                              int(np.prod(lattice.shape)), m_walkers)
    return le_chunk, max(1, fwd_budget // m_walkers), sec_chunk


def _complex(z: C) -> np.ndarray:
    return (z.re.detach().cpu().numpy().astype(np.float64)
            + 1j * z.im.detach().cpu().numpy().astype(np.float64))


def measure(cfg, ckpt_dir: str, n_samples: int = 20,
            sweeps_between: int = 2, therm_sweeps: int = 20,
            fidelity_ckpt: Optional[str] = None,
            fidelity_step: Optional[int] = None,
            lanczos: bool = False,
            total_spin: bool = False,
            dimer: bool = False,
            renyi2_region=None,
            chirality: bool = False,
            sma: bool = False,
            use_ema: bool = False,
            sector_momentum=None,
            device="cuda",
            timer: Optional[PhaseTimer] = None) -> dict:
    """Measure the state in ``ckpt_dir`` (a ``.npz`` snapshot or a port
    checkpoint directory) with ``cfg``'s model on ``device``; returns the
    report. ``use_ema`` measures the parameter EMA (the ``<csv>.ema.npz``
    beside a ``<csv>.params.npz``, or the checkpoint's ``TrainState.ema``)
    and raises ``ValueError`` where there is none. ``timer`` (a
    :class:`PhaseTimer`) accumulates the seconds of thermalization
    (``therm``), each sample's sweeps (``sweeps``) and estimators
    (``sample_estimators``' parts, ``sector``, ``chirality``) and
    ``total_spin``."""
    unported = [flag for flag, on in (
        ("--fidelity-ckpt", fidelity_ckpt is not None),
        ("--lanczos-step", lanczos), ("--renyi2", bool(renyi2_region)),
        ("--sma", sma)) if on]
    if unported:
        raise NotImplementedError(
            f"measure {', '.join(unported)} is not ported yet (ROADMAP.md, "
            "A17b)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "measure runs in one process on one device; a measurement "
            "sharded over ranks is not ported yet (ROADMAP.md, A17c)")
    timer = timer or _untimed
    # Measurement runs in f32 even when the training config computes in
    # bf16: the Lanczos third moment cancels ~|E|^3 down to O(var), and
    # bf16 log-psi noise destroys it. Params are stored in f32; this only
    # changes the activations' compute, a measurement-time precision
    # upgrade of the same state.
    if cfg.model.compute_dtype not in (None, "float32"):
        print(f"measure: forcing compute_dtype float32 "
              f"(training used {cfg.model.compute_dtype})")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32"))
    dev = _resolve_device(device)
    vmc, params, lattice = build(cfg, device=dev)
    # with parallel tempering only the b = 1 rows are |psi|^2-distributed
    phys = vmc.sampler.physical
    m_walkers = cfg.sampler.n_walkers
    ids = torch.arange(m_walkers, device=dev)
    key = prng_key(cfg.run.seed + 12345)
    loaded_step = None
    field = "ema" if use_ema else "params"
    if ckpt_dir.endswith(".npz"):
        # a .params.npz snapshot is params-only: fresh walkers
        params = warm_start(params, ckpt_dir, field=field)
        state = vmc.init_state(fold_in(key, 0), m_walkers, params,
                               device=dev)
        therm_sweeps = max(therm_sweeps, 50)
    else:
        from qmcnn_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      saved_steps)
        from qmcnn_tpu_torch.utils.transfer import load_checkpoint_params

        if not saved_steps(ckpt_dir):
            load_checkpoint_params(ckpt_dir)  # raises: not a port checkpoint
        template = vmc.init_state(fold_in(key, 0), m_walkers, params,
                                  device=dev)
        loaded_step = saved_steps(ckpt_dir)[-1]
        try:
            state = CheckpointManager(ckpt_dir).restore(template)
            if state.walkers.s.shape != template.walkers.s.shape:
                raise ValueError(
                    f"the checkpoint holds {state.walkers.s.shape[0]} walker "
                    f"rows, this config {template.walkers.s.shape[0]}")
            loaded_step = int(state.step)
            print(f"restored checkpoint at step {loaded_step}")
        except (ValueError, KeyError, TypeError) as exc:
            # a structure or shape mismatch with the saved run (e.g.
            # another walker count): params only (the EMA with --ema).
            # I/O errors (OSError) propagate: retrying beats measuring a
            # fresh state
            print(f"full-state restore failed ({type(exc).__name__}); "
                  "restoring params only and re-thermalizing fresh walkers")
            params = warm_start(params, ckpt_dir, field=field)
            state = vmc.init_state(fold_in(key, 0), m_walkers, params,
                                   device=dev)
            therm_sweeps = max(therm_sweeps, 50)
        else:
            if use_ema:
                # the Polyak average instead of the last iterate; the
                # thermalization below refreshes every cached log psi. A
                # restore starts an absent EMA at the params: the saved
                # state itself must hold one
                from qmcnn_tpu_torch.utils.checkpoint import load_state_dict

                if (state.ema is None or load_state_dict(
                        ckpt_dir, loaded_step).get("ema") is None):
                    raise ValueError(
                        "--ema: checkpoint/config has no EMA state (train "
                        "with optimizer.ema_decay > 0)")
                state = state._replace(params=state.ema)
                print("measuring the EMA (Polyak-averaged) parameters")
    with timer("therm"):
        state = chunked_thermalize(vmc, state, fold_in(key, 1), ids,
                                   therm_sweeps,
                                   cfg.run.therm_sweeps_per_dispatch)

    le_chunk, pair_chunk, sec_chunk = chunk_sizes(vmc, m_walkers, lattice)
    on_grid = lattice.basis == 1
    if dimer and not (on_grid and lattice.ndim == 2):
        raise ValueError("--dimer needs a 2D 1-site-basis lattice")
    if chirality:
        lattice.triangles  # raises early on triangle-free geometries
    # the trained state lives in the Marshall-rotated basis for these
    # kinds: every transverse estimator undoes the sign
    marshall = (cfg.hamiltonian.kind in ("heisenberg", "j1j2")
                and cfg.hamiltonian.marshall)

    traces = defaultdict(list)
    with torch.no_grad():
        for i in range(n_samples):
            with timer("sweeps"):
                state = vmc.thermalize(state, fold_in(key, 100 + i), ids,
                                       n_sweeps=sweeps_between)
            walkers = phys(state.walkers)
            est = sample_estimators(
                vmc.eval_log_psi_fn, state.params, walkers, vmc.ham, lattice,
                chunk_size=le_chunk, dimer=dimer, marshall=marshall,
                timer=timer)
            for k, v in est.items():
                traces[k].append(v.cpu().numpy() if v.dim()
                                 else float(v))
            if sector_momentum is not None:
                with timer("sector"):
                    num, den = observables.sector_energy_ratio(
                        vmc.eval_log_psi_fn, state.params, walkers.s,
                        walkers.log_psi, vmc.ham, tuple(lattice.shape),
                        tuple(sector_momentum), chunk_size=sec_chunk)
                    traces["sector_num"].append(_complex(num))
                    traces["sector_den"].append(_complex(den))
            if chirality:
                with timer("chirality"):
                    traces["chirality"].append(float(
                        observables.scalar_chirality(
                            vmc.eval_log_psi_fn, state.params, walkers.s,
                            walkers.log_psi, lattice,
                            chunk_size=le_chunk).re))
        if total_spin:
            # N(N-1)/2 forwards per walker: once, on the final walkers
            walkers = phys(state.walkers)
            with timer("total_spin"):
                traces["total_spin_sq"] = float(observables.total_spin_sq(
                    vmc.eval_log_psi_fn, state.params, walkers.s,
                    walkers.log_psi, lattice, marshall=marshall,
                    pair_chunk=pair_chunk).re)
    traces["dimer"] = dimer
    if sector_momentum is not None:
        traces["sector_momentum"] = list(sector_momentum)
    return assemble_report(traces, lattice,
                           step=loaded_step if loaded_step is not None else 0,
                           ema=use_ema)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--n-samples", type=int, default=20)
    p.add_argument("--sweeps-between", type=int, default=2)
    p.add_argument("--fidelity-ckpt", default=None,
                   help="not ported yet (ROADMAP.md, A17b)")
    p.add_argument("--fidelity-step", type=int, default=None)
    p.add_argument("--lanczos-step", action="store_true",
                   help="not ported yet (ROADMAP.md, A17b)")
    p.add_argument("--total-spin", action="store_true",
                   help="also report <S^2> of the total spin (singlet 0, "
                        "triplet 2, ...; costs N(N-1)/2 forwards/walker)")
    p.add_argument("--dimer", action="store_true",
                   help="also report z-dimer correlations + structure "
                        "factor (VBS order probe; 2D square lattices)")
    p.add_argument("--chirality", action="store_true",
                   help="also report the scalar spin chirality "
                        "<S_i.(S_j x S_k)> averaged over CCW triangles "
                        "(triangular/kagome; chiral-order diagnostic)")
    p.add_argument("--sma", action="store_true",
                   help="not ported yet (ROADMAP.md, A17b)")
    p.add_argument("--renyi2", action="append", default=None,
                   metavar="REGION", help="not ported yet (ROADMAP.md, A17b)")
    p.add_argument("--sector-momentum", default=None,
                   help="comma-separated integer wavenumbers m_d (q_d = "
                        "2 pi m_d / L_d), e.g. '4,4' for (pi,pi) on 8x8: "
                        "momentum-sector energy by |psi|^2 ratio "
                        "estimators (no |P psi|^2 sampling)")
    p.add_argument("--ema", action="store_true",
                   help="measure the Polyak/EMA-averaged parameters (the "
                        "<csv>.ema.npz beside a <csv>.params.npz, or a "
                        "checkpoint's EMA) instead of the last iterate")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--timings", action="store_true",
                   help="diagnostic: also print one JSON line of seconds "
                        "per phase (the device synchronized around each) "
                        "and the CUDA kernels' launch counts, which show "
                        "what served the run (0 where a model takes the "
                        "plain forward)")
    args = p.parse_args(argv)
    cfg = cfglib.load(args.config, tuple(args.override))
    timer = PhaseTimer(args.device) if args.timings else None
    report = measure(cfg, args.ckpt_dir, n_samples=args.n_samples,
                     sweeps_between=args.sweeps_between,
                     fidelity_ckpt=args.fidelity_ckpt,
                     fidelity_step=args.fidelity_step,
                     lanczos=args.lanczos_step,
                     total_spin=args.total_spin,
                     dimer=args.dimer,
                     renyi2_region=args.renyi2,
                     chirality=args.chirality,
                     sma=args.sma,
                     use_ema=args.ema,
                     sector_momentum=(
                         [int(x) for x in args.sector_momentum.split(",")]
                         if args.sector_momentum else None),
                     device=args.device, timer=timer)
    print(json.dumps({k: v for k, v in report.items() if k != "szsz_corr"},
                     indent=2))
    print("szsz_corr:", np.array2string(np.asarray(report["szsz_corr"]),
                                        precision=4))
    if timer is not None:
        from qmcnn_tpu_torch.kernels.gcnn_forward import gcnn_group_sums
        from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep

        print(json.dumps({"timings_s": dict(timer.seconds),
                          "n_samples": args.n_samples, "launches": {
                              "k1": metropolis_sweep.launches,
                              "k2_f32": gcnn_group_sums.launches,
                              "k2_bf16": gcnn_group_sums.launches_bf16}}))


if __name__ == "__main__":
    main()
