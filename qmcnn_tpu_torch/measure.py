"""Measurement entry point of the PyTorch port: observables of a trained
state (port of ``qmcnn_tpu/measure.py``).

  python -m qmcnn_tpu_torch.measure --config configs/heis10x10_sr.yaml \\
      --ckpt-dir <csv>.params.npz | <checkpoint dir> [--n-samples 20] \\
      [--sweeps-between 2] [--total-spin] [--dimer] [--chirality] \\
      [--sector-momentum 0,0] [--renyi2 REGION ...] [--sma] \\
      [--lanczos-step] [--fidelity-ckpt PATH [--fidelity-step N]] \\
      [--ema] [--device cuda|cpu]

Restores the state (a ``.params.npz`` snapshot: params only and at least
50 fresh sweeps; a port checkpoint directory: the whole state, or its
params after a structure or shape mismatch), thermalizes, then alternates
sampling and measuring: the energy with its binned error, the
magnetization, the staggered moments and the Binder cumulant, S^z-S^z
correlations with the structure factor and the correlation length, the
nearest-neighbour S.S; with the flags the z-dimer correlations, the
Lanczos-step energy of (1 + alpha H) psi with its jackknife error, the
momentum-sector energy ratio, the Renyi-2 entropy of each region (the
replica swap over even/odd walker pairs), the scalar chirality and the
single-mode-approximation magnon dispersion; then <S^2> of the final
walkers and the fidelity with a second state (a second chain thermalized
under its params). It prints one JSON report with the JAX package's keys.

Measurement computes in float32 whatever the training config's dtype,
and every forward is the evaluation forward of the sampler and E_loc
(``VMC.eval_log_psi_fn``): on CUDA the fused kernels serve a bf16 GCNN
snapshot on K2's float32 route and the real CNN on K1's recompute
forward. It runs on CUDA by default (without a GPU it raises unless
``--device cpu`` is given). With ``run.distributed: true`` under torchrun
each rank measures its rows of the walkers (global walker ids, so the
sweeps draw what one rank draws for them), the estimator means reduce
over the ranks, the per-walker arrays the report pools (the sector ratio,
the Lanczos moments) are gathered, and rank 0 alone prints:

  python -m torch.distributed.run --standalone --nproc_per_node=N \\
      -m qmcnn_tpu_torch.measure --config ... --ckpt-dir ... \\
      --override run.distributed=true
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch import configs as cfglib
from qmcnn_tpu_torch.builder import build
from qmcnn_tpu_torch.ops import observables
from qmcnn_tpu_torch.ops import sma as sma_mod
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.fidelity import fidelity
from qmcnn_tpu_torch.ops.lanczos import (h_moment_samples, lanczos_step,
                                         moments_from_samples)
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.train import (_resolve_device, check_rank_layout,
                                   chunked_thermalize)
from qmcnn_tpu_torch.utils.memory import divided_chunk
from qmcnn_tpu_torch.utils.metrics import binned_stderr
from qmcnn_tpu_torch.utils.transfer import warm_start
from qmcnn_tpu_torch.vmc import pmean


def parse_region(spec: str, n_sites: int) -> np.ndarray:
    """Region spec -> [N] 0/1 float32 mask: 'half' (the first N/2 sites),
    'a:b' (a site slice) or a comma list of site indices. Raises
    ``ValueError`` unless the region is a proper subset of the sites."""
    mask = np.zeros(n_sites, np.float32)
    if spec == "half":
        mask[: n_sites // 2] = 1.0
    elif ":" in spec:
        lo, hi = spec.split(":")
        mask[int(lo or 0): int(hi or n_sites)] = 1.0
    else:
        mask[[int(t) for t in spec.split(",")]] = 1.0
    if not 0 < mask.sum() < n_sites:
        raise ValueError(f"region {spec!r} must be a proper subset of "
                         f"the {n_sites} sites")
    return mask


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
                      marshall: bool = False, group=None,
                      timer=_untimed) -> dict:
    """The estimators of one sample (JAX ``measure_once``) on the physical
    walkers, through ``log_psi_fn`` (the evaluation forward): the mean
    E_loc, the magnetization, the staggered moments, the S^z-S^z
    correlation (C(r) [N] on a 1-site basis, else the sublattice-resolved
    C_ab(r) flattened), the nearest-neighbour S.S (0 off the site grid),
    and the dimer correlation and mean (zeros without ``dimer``), as 0-d
    or 1-d tensors on the walkers' device, each a mean over ``group``'s
    walkers (a rank's own without one). ``timer(name)`` wraps each part
    (``e_loc``, ``nn_ss``, ``diagonal``)."""
    s, lp = walkers.s, walkers.log_psi
    n = lattice.n_sites
    on_grid = lattice.basis == 1
    with torch.no_grad():
        with timer("e_loc"):
            energy = pmean(local_energy(log_psi_fn, params, ham, s, lp,
                                        chunk_size=chunk_size).re.mean(),
                           group)
        with timer("nn_ss"):
            if on_grid:
                nn_disp = int(np.ravel_multi_index(
                    tuple([1] + [0] * (lattice.ndim - 1)), lattice.shape))
                ss_nn = observables.spin_spin_correlation(
                    log_psi_fn, params, s, lp, lattice, nn_disp,
                    marshall=marshall, group=group,
                    chunk_size=chunk_size).re
            else:
                ss_nn = torch.zeros((), device=s.device)
        with timer("diagonal"):
            if on_grid:
                corr = observables.szsz_correlation(s, lattice, group)
            else:
                corr = observables.szsz_correlation_basis(
                    s, lattice, group).reshape(-1)
            if dimer:
                dcorr, dmean = observables.dimer_correlation(
                    s, lattice, group=group)
            else:
                dcorr = torch.zeros(n, device=s.device)
                dmean = torch.zeros((), device=s.device)
            mst2, mst4 = observables.staggered_moments(s, lattice, group)
            mag = observables.magnetization(s, group)
    return {"energy": energy, "magnetization": mag, "mst2": mst2,
            "mst4": mst4, "corr": corr, "ss_nn": ss_nn, "dimer_corr": dcorr,
            "dimer_mean": dmean}


def assemble_report(traces: dict, lattice, *, step: int = 0,
                    ema: bool = False) -> dict:
    """The report (JAX ``measure``'s keys) from the per-sample traces
    (``sample_estimators``' values as host numbers or arrays, one list
    entry per sample, in ``traces[name]``), with optional entries:
    ``dimer`` (True: the dimer keys), ``renyi2_swap`` (a list of per-sample
    float32 [R] swap means) with ``renyi2_region_size``, ``chirality`` (a
    list of per-sample chi), ``sma_ct`` (a list of per-sample float32 C_t
    per displacement) with ``sma_shells``, ``sector_momentum`` with
    ``sector_num`` / ``sector_den`` (lists of complex per-walker arrays),
    ``fidelity`` and ``total_spin_sq`` (floats), ``lanczos_e1`` /
    ``lanczos_g`` (lists of complex per-walker arrays)."""
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
    if traces.get("renyi2_swap") is not None:
        # average the Tr(rho_A^2) estimates, then -ln: the mean of logs is
        # biased for a noisy positive estimator
        swaps = np.stack(traces["renyi2_swap"])           # [samples, R]
        means = swaps.mean(axis=0)
        report["renyi2_swap_mean"] = [float(x) for x in means]
        report["renyi2_swap_err"] = [binned_stderr(swaps[:, r])
                                     for r in range(swaps.shape[1])]
        report["renyi2_entropy"] = [observables.renyi2_entropy(float(x))
                                    for x in means]
        report["renyi2_region_size"] = [int(x) for x in
                                        traces["renyi2_region_size"]]
        if len(means) == 1:  # one region: plain scalars, as JAX reports
            for k in ("renyi2_swap_mean", "renyi2_swap_err",
                      "renyi2_entropy", "renyi2_region_size"):
                report[k] = report[k][0]
    if traces.get("chirality") is not None:
        chi = np.asarray(traces["chirality"], np.float64)
        report["scalar_chirality"] = float(np.mean(chi))
        report["scalar_chirality_err"] = binned_stderr(chi)
    if traces.get("sma_ct") is not None:
        shells = traces["sma_shells"]
        disps = sorted({d for _, d in shells})
        acc = np.zeros(len(disps))
        for ct_i in traces["sma_ct"]:
            acc += np.asarray(ct_i)
        ct = {d: float(v / len(traces["sma_ct"]))
              for d, v in zip(disps, acc)}
        f_q, _, omega = sma_mod.sma_dispersion(shells, ct, corr, lattice)
        finite = np.isfinite(omega) & (np.arange(n).reshape(omega.shape) > 0)
        report["sma_transverse_corr"] = {str(d): ct[d] for d in disps}
        report["sma_first_moment"] = [round(float(x), 8)
                                      for x in f_q.reshape(-1)]
        report["sma_omega"] = [float(x) if np.isfinite(x) else None
                               for x in omega.reshape(-1)]
        if finite.any():
            # the softest mode over the grid, q = 0 excluded: an upper
            # bound on the spin gap
            k = int(np.nanargmin(np.where(finite, omega, np.nan)))
            report["sma_gap_bound"] = float(omega.reshape(-1)[k])
            report["sma_gap_q_index"] = k
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
    if traces.get("fidelity") is not None:
        report["fidelity_vs_ckpt"] = float(traces["fidelity"])
    if traces.get("total_spin_sq") is not None:
        report["total_spin_sq"] = float(traces["total_spin_sq"])
    if traces.get("lanczos_e1") is not None:
        report.update(lanczos_report(traces["lanczos_e1"],
                                     traces["lanczos_g"], report["energy"], n))
    return report


def _lanczos_energy(e1, g) -> tuple:
    """(alpha, E_lz, h1, k2) of the pooled complex per-walker arrays."""
    e1, g = np.concatenate(e1), np.concatenate(g)
    h1, h2, h3 = moments_from_samples(
        C(e1.real.astype(np.float64), e1.imag.astype(np.float64)),
        C(g.real.astype(np.float64), g.imag.astype(np.float64)))
    alpha, e_lz, _ = lanczos_step(h1, h2, h3)
    return alpha, e_lz, h1, h2 - h1 * h1


def lanczos_report(e1_blocks, g_blocks, energy: float, n_sites: int) -> dict:
    """The ``lanczos_*`` keys from the per-sample blocks of per-walker
    (E_loc, G): the step's alpha and energy, its validity (one Krylov step
    lowers the energy by at most sqrt(k2); a larger gain means the moment
    estimators are noise-dominated, k3's ~|E|^3 cancellation, and a line
    says so) and, with 4 or more blocks, the delete-one-block jackknife
    error propagated through the whole moments -> (alpha, E) map."""
    alpha, e_lz, h1, k2 = _lanczos_energy(e1_blocks, g_blocks)
    bound = np.sqrt(max(k2, 0.0))
    valid = bool(h1 - e_lz <= 1.05 * bound + 1e-12)
    out = {"lanczos_valid": valid, "lanczos_alpha": alpha,
           "lanczos_energy": e_lz, "lanczos_energy_per_site": e_lz / n_sites,
           "lanczos_gain_per_site": (e_lz - energy) / n_sites}
    blocks = len(e1_blocks)
    if blocks >= 4:
        e_js = np.asarray([_lanczos_energy(
            [x for i, x in enumerate(e1_blocks) if i != j],
            [x for i, x in enumerate(g_blocks) if i != j])[1]
            for j in range(blocks)], np.float64)
        err = np.sqrt((blocks - 1) / blocks
                      * ((e_js - e_js.mean()) ** 2).sum())
        out["lanczos_energy_err"] = float(err)
        out["lanczos_energy_per_site_err"] = float(err) / n_sites
    if not valid:
        print(f"lanczos: NOISE-DOMINATED (gain {h1 - e_lz:.3g} > "
              f"sqrt(k2) {bound:.3g}); increase samples/walkers or "
              "check moment precision")
    return out


def chunk_sizes(vmc, m_walkers: int, lattice) -> tuple:
    """(E_loc walker chunk or None, total_spin_sq's pair chunk, the sector
    ratio's walker chunk, the Lanczos moments' walker chunk) for
    ``m_walkers`` walkers (a rank's): the training auto-chunk, adjusted to
    divide the walker count, bounds every measurement forward; the pair
    chunk fills the forward budget chunk x K of the train step; the sector
    pass multiplies each walker's forwards by the T translations; the
    moment pass takes half the budget, since it keeps the connected
    states' E_loc, ratios and configurations live beside each forward."""
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
    # JAX's min(M, budget // 2K), with the budget chunk x K
    lz_chunk = divided_chunk(le_chunk or m_walkers, 2, m_walkers)
    return le_chunk, max(1, fwd_budget // m_walkers), sec_chunk, lz_chunk


def _pooled(z: C, group) -> np.ndarray:
    """Complex per-walker values of every rank, in global walker order."""
    if group is not None:
        z = C(group.all_gather(z.re), group.all_gather(z.im))
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
            timer: Optional[PhaseTimer] = None,
            group=None,
            record: Optional[dict] = None) -> dict:
    """Measure the state in ``ckpt_dir`` (a ``.npz`` snapshot or a port
    checkpoint directory) with ``cfg``'s model on ``device``; returns the
    report. ``use_ema`` measures the parameter EMA (the ``<csv>.ema.npz``
    beside a ``<csv>.params.npz``, or the checkpoint's ``TrainState.ema``)
    and raises ``ValueError`` where there is none. ``renyi2_region`` is a
    region spec or a list of them (:func:`parse_region`); ``fidelity_ckpt``
    (at ``fidelity_step`` for a checkpoint) is the second state of the
    fidelity.

    With ``cfg.run.distributed`` this process is one rank of the walker
    group (``group``, else the default process group, which must be
    initialized): it holds its rows of the walkers, and every rank returns
    the same report. ``timer`` (a :class:`PhaseTimer`) accumulates the
    seconds of thermalization (``therm``), each sample's sweeps
    (``sweeps``) and estimators (``sample_estimators``' parts,
    ``lanczos``, ``sector``, ``renyi2``, ``chirality``, ``sma``),
    ``total_spin``, the second chain's thermalization (``fidelity_therm``)
    and ``fidelity``. ``record``, a dict, receives this rank's physical
    walkers after thermalization (``walkers``) and the traces the report
    is assembled from (``traces``; the per-walker arrays pooled over the
    ranks)."""
    check_rank_layout(cfg, group, "qmcnn_tpu_torch.measure")
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
    m_walkers = cfg.sampler.n_walkers
    if cfg.run.distributed:
        from qmcnn_tpu_torch.builder import build_sharded
        from qmcnn_tpu_torch.parallel.mesh import walker_group

        if group is None:
            group = walker_group(cfg.run.n_devices, device)
        sharded, params, lattice = build_sharded(cfg, group)
        vmc, dev = sharded.vmc, group.device
        rows = group.rows(m_walkers)
        ids = group.local_ids(rows.stop - rows.start)
    else:
        dev = _resolve_device(device)
        vmc, params, lattice = build(cfg, device=dev)
        rows = None
        ids = torch.arange(m_walkers, device=dev)
    m_local = len(ids)
    # with parallel tempering only the b = 1 rows are |psi|^2-distributed
    phys = vmc.sampler.physical
    n_rep = getattr(vmc.sampler, "n_replicas", 1)
    key = prng_key(cfg.run.seed + 12345)

    def fresh_state(k, p):
        return vmc.init_state(k, m_walkers, p, device=dev, rows=rows)

    loaded_step = None
    field = "ema" if use_ema else "params"
    if ckpt_dir.endswith(".npz"):
        # a .params.npz snapshot is params-only: fresh walkers
        params = warm_start(params, ckpt_dir, field=field)
        state = fresh_state(fold_in(key, 0), params)
        therm_sweeps = max(therm_sweeps, 50)
    else:
        from qmcnn_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      saved_steps)
        from qmcnn_tpu_torch.utils.transfer import load_checkpoint_params

        if not saved_steps(ckpt_dir):
            load_checkpoint_params(ckpt_dir)  # raises: not a port checkpoint
        template = fresh_state(fold_in(key, 0), params)
        loaded_step = saved_steps(ckpt_dir)[-1]
        try:
            state = CheckpointManager(ckpt_dir).restore(
                template, group=group, n_replicas=n_rep)
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
            state = fresh_state(fold_in(key, 0), params)
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
    if record is not None:
        record["walkers"] = phys(state.walkers).s.clone()

    n = lattice.n_sites
    le_chunk, pair_chunk, sec_chunk, lz_chunk = chunk_sizes(vmc, m_local,
                                                            lattice)
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
    regions = None
    if renyi2_region:
        # every region in one pass per sample, over the walkers paired
        # even/odd (independent chains by construction); a rank pairs its
        # own rows, the pairs of one rank
        specs = ([renyi2_region] if isinstance(renyi2_region, str)
                 else list(renyi2_region))
        regions = np.stack([parse_region(sp, n) for sp in specs])
        if m_local % 2:
            raise ValueError(
                f"--renyi2 pairs the walkers even/odd: this rank holds "
                f"{m_local} (odd); choose sampler.n_walkers divisible by "
                f"twice the {1 if group is None else group.world_size} "
                "ranks")
        # exchange-family moves keep the walkers in one S^z sector: mask
        # the pairs whose region magnetizations differ
        sector_mask = cfg.sampler.move.startswith("exchange") or (
            getattr(cfg.sampler, "kind", "metropolis") == "direct"
            and cfg.model.kind == "arnn")
        traces["renyi2_region_size"] = [int(r.sum()) for r in regions]
    sma_disps = None
    if sma:
        # raises before any sampling for a non-exchange Hamiltonian, a
        # multi-site basis or open boundaries
        traces["sma_shells"] = sma_mod.exchange_shells(vmc.ham, lattice)
        sma_disps = sorted({d for _, d in traces["sma_shells"]})

    with torch.no_grad():
        for i in range(n_samples):
            with timer("sweeps"):
                state = vmc.thermalize(state, fold_in(key, 100 + i), ids,
                                       n_sweeps=sweeps_between)
            walkers = phys(state.walkers)
            s, lp = walkers.s, walkers.log_psi
            est = sample_estimators(
                vmc.eval_log_psi_fn, state.params, walkers, vmc.ham, lattice,
                chunk_size=le_chunk, dimer=dimer, marshall=marshall,
                group=group, timer=timer)
            for k, v in est.items():
                traces[k].append(v.cpu().numpy() if v.dim()
                                 else float(v))
            if lanczos:
                with timer("lanczos"):
                    e1, g = h_moment_samples(
                        vmc.eval_log_psi_fn, state.params, vmc.ham, s, lp,
                        chunk_size=lz_chunk)
                    traces["lanczos_e1"].append(_pooled(e1, group))
                    traces["lanczos_g"].append(_pooled(g, group))
            if sector_momentum is not None:
                with timer("sector"):
                    num, den = observables.sector_energy_ratio(
                        vmc.eval_log_psi_fn, state.params, s, lp, vmc.ham,
                        tuple(lattice.shape), tuple(sector_momentum),
                        chunk_size=sec_chunk)
                    traces["sector_num"].append(_pooled(num, group))
                    traces["sector_den"].append(_pooled(den, group))
            if regions is not None:
                with timer("renyi2"):
                    traces["renyi2_swap"].append(torch.stack([
                        observables.renyi2_swap(
                            vmc.eval_log_psi_fn, state.params, s[0::2],
                            s[1::2], lp[0::2], lp[1::2], reg,
                            sector_mask=sector_mask, group=group).re
                        for reg in regions]).cpu().numpy())
            if chirality:
                with timer("chirality"):
                    traces["chirality"].append(float(
                        observables.scalar_chirality(
                            vmc.eval_log_psi_fn, state.params, s, lp,
                            lattice, group=group, chunk_size=le_chunk).re))
            if sma:
                # C_t(delta) per shell displacement: one amplitude-ratio
                # pass each, the NN S.S estimator's machinery
                with timer("sma"):
                    traces["sma_ct"].append(torch.stack([
                        observables.offdiag_observable(
                            vmc.eval_log_psi_fn, state.params, s, lp,
                            observables.spin_spin_connected(
                                lattice, d, marshall=marshall),
                            group=group, chunk_size=le_chunk).re
                        for d in sma_disps]).cpu().numpy())
        walkers = phys(state.walkers)
        if total_spin:
            # N(N-1)/2 forwards per walker: once, on the final walkers
            with timer("total_spin"):
                traces["total_spin_sq"] = float(observables.total_spin_sq(
                    vmc.eval_log_psi_fn, state.params, walkers.s,
                    walkers.log_psi, lattice, marshall=marshall, group=group,
                    pair_chunk=pair_chunk).re)
        if fidelity_ckpt is not None:
            # the two-chain estimator: a second chain thermalized under the
            # second state's params
            params2 = warm_start(dict(state.params), fidelity_ckpt,
                                 step=fidelity_step)
            with timer("fidelity_therm"):
                state2 = chunked_thermalize(
                    vmc, fresh_state(fold_in(key, 2), params2),
                    fold_in(key, 3), ids, max(therm_sweeps, 50),
                    cfg.run.therm_sweeps_per_dispatch)
            with timer("fidelity"):
                traces["fidelity"] = float(fidelity(
                    vmc.eval_log_psi_fn, state.params, vmc.eval_log_psi_fn,
                    params2, walkers.s, phys(state2.walkers).s, group=group))
    traces["dimer"] = dimer
    if sector_momentum is not None:
        traces["sector_momentum"] = list(sector_momentum)
    if record is not None:
        record["traces"] = dict(traces)
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
                   help="second checkpoint dir or .params.npz: report the "
                        "MC fidelity |<psi1|psi2>|^2 between the two states")
    p.add_argument("--fidelity-step", type=int, default=None)
    p.add_argument("--lanczos-step", action="store_true",
                   help="also report the Lanczos-step refined variational "
                        "energy of (1 + alpha H) psi (ops/lanczos.py; "
                        "costs K extra local-energy passes per sample), "
                        "with its validity guard and, from 4 samples, a "
                        "jackknife error")
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
                   help="also report the single-mode-approximation "
                        "(Feynman) magnon dispersion omega_SMA(q) = "
                        "f(q)/S(q) over the reciprocal grid, plus the "
                        "softest-mode spin-gap bound (exchange "
                        "Hamiltonians on 1-site-basis periodic lattices; "
                        "costs one amplitude-ratio pass per bond shell)")
    p.add_argument("--renyi2", action="append", default=None,
                   metavar="REGION",
                   help="also report the Renyi-2 entanglement entropy of a "
                        "region via the replica swap trick: 'half', a site "
                        "slice 'a:b', or a comma list of sites; repeat the "
                        "flag for an entanglement-scaling scan (all "
                        "regions measured in one pass)")
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
    group = None
    if cfg.run.distributed:
        # before any device use: the rank's card and the process group
        from qmcnn_tpu_torch.parallel.mesh import init_distributed

        group = init_distributed(cfg.run, device=args.device)
    is_main = group is None or group.rank == 0
    timer = PhaseTimer(args.device if group is None else group.device
                       ) if args.timings else None
    try:
        # rank 0 alone prints; the others' lines (warm starts) are dropped
        with (contextlib.nullcontext() if is_main
              else contextlib.redirect_stdout(io.StringIO())):
            report = measure(
                cfg, args.ckpt_dir, n_samples=args.n_samples,
                sweeps_between=args.sweeps_between,
                fidelity_ckpt=args.fidelity_ckpt,
                fidelity_step=args.fidelity_step, lanczos=args.lanczos_step,
                total_spin=args.total_spin, dimer=args.dimer,
                renyi2_region=args.renyi2, chirality=args.chirality,
                sma=args.sma, use_ema=args.ema,
                sector_momentum=(
                    [int(x) for x in args.sector_momentum.split(",")]
                    if args.sector_momentum else None),
                device=args.device, timer=timer, group=group)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    if not is_main:
        return
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
