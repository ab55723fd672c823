"""Ranks of the PyTorch port's walker-sharding tests
(``tests/test_torch_distributed.py``): one process per rank, joined by gloo
over a ``FileStore`` on the CPU, so parallel test workers never race for a
port. Imports torch and the port only, never JAX.

Run as:  python tests/torch_dist_ranks.py <rank> <world size> <work dir>
         [excited]

The work dir holds ``spec.pt`` (the parent's shared inputs); each rank
writes ``rank<r>.pt`` with what the parent compares against the 1-rank
run, which the parent computes with the same functions and no group.
With ``excited`` the ranks run only the tempering, deflation and penalty
legs (``run_excited``; tests/test_torch_tempering.py); with ``measure``
only the measurement with every flag (``run_measure``;
tests/test_torch_distributed.py); with ``tdvp`` only the TDVP right-hand
sides (``run_tdvp``; tests/test_torch_distributed.py); with ``pcg`` only
the tempered heis10x10_sr leg with pcg's loop values traced
(``run_pcg_trace``; tests/torch_pcg_margins.py), on the spec's device.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from qmcnn_tpu_torch import builder as tb  # noqa: E402
from qmcnn_tpu_torch import configs as tcfg  # noqa: E402
from qmcnn_tpu_torch.builder import Optimizer  # noqa: E402
from qmcnn_tpu_torch.lattice import chain  # noqa: E402
from qmcnn_tpu_torch.models.cnn import LogPsiCNN, log_psi_apply  # noqa: E402
from qmcnn_tpu_torch.ops.cplx import C  # noqa: E402
from qmcnn_tpu_torch.ops.hamiltonians import TFIM, Heisenberg  # noqa: E402
from qmcnn_tpu_torch.parallel.mesh import (make_sharded_vmc,  # noqa: E402
                                           walker_group)
from qmcnn_tpu_torch.sampler.metropolis import (MetropolisSampler,  # noqa: E402
                                                fold_in, prng_key)
from qmcnn_tpu_torch.sr import SR  # noqa: E402
from qmcnn_tpu_torch.vmc import VMC  # noqa: E402

N = 8
M = 64
MOVES = ("flip", "exchange", "exchange_anti")
#: the JAX distributed tests' SR settings (tests/test_distributed.py)
SR_KW = dict(diag_shift0=0.1, diag_shift_decay=1.0, diag_shift_min=0.1)
SOLVERS = {
    "pcg": SR(solver="pcg", **SR_KW),
    "dense": SR(solver="dense", **SR_KW),
    "minsr_gather": SR(solver="minsr", real_log_psi=True, **SR_KW),
    "minsr_ring": SR(solver="minsr", real_log_psi=True,
                     minsr_assembly="ring", **SR_KW),
    "cg": SR(solver="cg", cg_tol=1e-6, cg_maxiter=200, **SR_KW),
}
GCNN = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn.yaml")
ARNN = os.path.join(ROOT, "configs", "tfim16_arnn.yaml")
GCNN_SMALL = ("lattice.shape=[4,4]", "model.channels=[2,2]",
              "sampler.n_walkers=32", "run.chunk_size=8")


def build_case(move="flip", sr=None, group=None):
    """The 8-site chain CNN of the JAX distributed tests: TFIM with flip
    moves, else Heisenberg; SGD at 0.02."""
    lat = chain(N)
    ham = TFIM(lat, h=1.0) if move == "flip" else Heisenberg(lat)
    model = LogPsiCNN(lattice_shape=(N,), channels=(4,), param_scale=0.1)

    def log_psi_fn(p, s):
        return log_psi_apply(model, p, s)

    bonds = lat.nn_bonds if move.startswith("exchange") else None
    sampler = MetropolisSampler(log_psi_fn, n_sites=N, move=move, bonds=bonds)
    vmc = VMC(log_psi_fn=log_psi_fn, ham=ham, sampler=sampler,
              optimizer=Optimizer(kind="sgd", lr=lambda count: 0.02),
              n_sweeps=1, sr=sr, group=group)
    return vmc, model.init(0)


class Runner:
    """``ShardedVMC``'s methods on this rank's walkers, or, with no group,
    the plain VMC's on all M walkers (the 1-rank run)."""

    def __init__(self, vmc, group):
        self.vmc = vmc
        self.sharded = None if group is None else make_sharded_vmc(vmc, group)

    def init(self, params, n_walkers=M):
        if self.sharded is None:
            return self.vmc.init_state(prng_key(1), n_walkers, params)
        return self.sharded.init_state(prng_key(1), n_walkers, params)

    def step(self, state, key):
        if self.sharded is None:
            return self.vmc.step(state, key, torch.arange(M))
        return self.sharded.step(state, key)

    def thermalize(self, state, key, n_sweeps):
        if self.sharded is None:
            return self.vmc.thermalize(state, key, torch.arange(M), n_sweeps)
        return self.sharded.thermalize(state, key, n_sweeps)

    def run_steps(self, state, key, n_steps):
        if self.sharded is None:
            return self.vmc.run_steps(state, key, torch.arange(M), n_steps)
        return self.sharded.run_steps(state, key, n_steps)


def record(state, mt=None) -> dict:
    out = {"s": state.walkers.s.clone(),
           "params": {k: v.clone() for k, v in state.params.items()}}
    if mt is not None:
        out.update(energy_re=float(mt.energy_re),
                   energy_var=float(mt.energy_var),
                   accept=float(mt.accept_rate), sr_iters=int(mt.sr_iters))
    return out


def leg_moves(move, group):
    """3 steps from the init walkers, as test_sharded_step_matches."""
    vmc, params = build_case(move, group=group)
    run = Runner(vmc, group)
    state = run.init(params)
    out = [record(state)]
    for it in range(3):
        state, mt = run.step(state, fold_in(prng_key(2), it))
        out.append(record(state, mt))
    return out


def leg_sr(name, group):
    """One step with each SR solver (TFIM, flip)."""
    vmc, params = build_case("flip", sr=SOLVERS[name], group=group)
    run = Runner(vmc, group)
    return record(*run.step(run.init(params), prng_key(5)))


def leg_thermalize(group):
    vmc, params = build_case(group=group)
    run = Runner(vmc, group)
    return record(run.thermalize(run.init(params), prng_key(7), 2))


def leg_run_steps(group):
    """4 steps in one run_steps call, and 4 step calls with the keys it
    derives (fold_in(base_key, step))."""
    vmc, params = build_case(group=group)
    run = Runner(vmc, group)
    fused, ms = run.run_steps(run.init(params), prng_key(9), 4)
    loop = run.init(params)
    singles = []
    for _ in range(4):
        loop, mt = run.step(loop, fold_in(prng_key(9), loop.step))
        singles.append(float(mt.energy_re))
    return {"fused": record(fused), "loop": record(loop),
            "fused_e": [float(mt.energy_re) for mt in ms],
            "loop_e": singles, "step": fused.step}


def minsr_deltas(spec, group):
    """The distributed minSR solve of the complex GCNN on this rank's rows
    of the parent's walkers, per assembly."""
    vmc, _, _ = tb.build(tcfg.load(GCNN, GCNN_SMALL), device="cpu")
    s, e_re, e_im = spec["s"], spec["e_re"], spec["e_im"]
    rows = slice(None) if group is None else group.rows(s.shape[0])
    out = {}
    for assembly in ("gather", "ring"):
        sr = SR(solver="minsr", real_log_psi=False, diag_shift0=0.5,
                minsr_assembly=assembly)
        delta, _, resid = sr.solve(vmc.log_psi_fn, spec["params"], s[rows],
                                   spec["grads"], 2,
                                   e_loc=C(e_re[rows], e_im[rows]),
                                   group=group)
        out[assembly] = {"delta": delta, "resid": float(resid)}
    return out


def leg_spring(group):
    """2 SPRING steps (mu 0.9) per minSR assembly: params and the carried
    delta after each."""
    out = {}
    for assembly in ("gather", "ring"):
        sr = SR(solver="minsr", real_log_psi=True, momentum=0.9,
                minsr_assembly=assembly, **SR_KW)
        vmc, params = build_case("flip", sr=sr, group=group)
        run = Runner(vmc, group)
        state = run.init(params)
        steps = []
        for it in range(2):
            state, mt = run.step(state, fold_in(prng_key(4), it))
            steps.append(dict(record(state, mt), sr_aux=state.sr_aux.clone(),
                              resid=float(mt.sr_residual)))
        out[assembly] = steps
    return out


def leg_checkpoint(spec, group, work):
    """Restore the parent's 1-rank checkpoint on this rank; then save this
    rank's state as a checkpoint of the group."""
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

    vmc, params = build_case(group=group)
    run = Runner(vmc, group)
    template = run.init(params)
    restored = CheckpointManager(spec["ckpt_1rank"]).restore(template,
                                                             group=group)
    state, _ = run.step(template, prng_key(3))
    CheckpointManager(os.path.join(work, "ckpt_nrank")).save(
        state.step, state, group=group)
    return {"restored_s": restored.walkers.s, "restored_step": restored.step,
            "saved": record(state)}


def leg_arnn(group):
    """configs/tfim16_arnn.yaml (the ARNN at its width, the direct
    sampler) with M walkers: the init walkers and one step."""
    cfg = tcfg.load(ARNN, (f"sampler.n_walkers={M}",))
    vmc, params, _ = tb.build(cfg, device="cpu", group=group)
    run = Runner(vmc, group)
    state = run.init(params)
    return [record(state), record(*run.step(state, prng_key(6)))]


def run_all(spec, group, work=None) -> dict:
    out = {"moves": {mv: leg_moves(mv, group) for mv in MOVES},
           "arnn": leg_arnn(group),
           "sr": {name: leg_sr(name, group) for name in SOLVERS},
           "thermalize": leg_thermalize(group),
           "run_steps": leg_run_steps(group),
           "minsr": minsr_deltas(spec, group),
           "spring": leg_spring(group)}
    if group is not None:
        out["checkpoint"] = leg_checkpoint(spec, group, work)
        try:
            walker_group(n_devices=group.world_size + 1, device="cpu")
        except ValueError as e:
            out["n_devices_error"] = str(e)
    return out


HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
#: the excited legs' 4x4 Heisenberg CNN with M = 16 and a parameter EMA
EXCITED_SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
                 "sampler.n_walkers=16", "run.csv_path=null",
                 "optimizer.ema_decay=0.9")


def excited_spec(work: str) -> dict:
    """The excited legs' frozen state: the seeded 4x4 model perturbed and
    saved as a snapshot in ``work``."""
    import numpy as np

    cfg = tcfg.load(HEIS, EXCITED_SMALL)
    _, params, _ = tb.build(cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    snap = os.path.join(work, "psi0.params.npz")
    np.savez(snap, **{k: (v + 0.2 * torch.randn(v.shape, generator=gen)
                          ).numpy() for k, v in params.items()})
    return {"psi0": snap}


def _excited_leg(cfg, group, n_steps: int) -> list:
    """``cfg`` on this rank's walkers (all with no group): the init walkers
    and, after each step, the walkers, params, EMA, SPRING's carry, the
    energy and the overlap."""
    vmc, params, _ = tb.build(cfg, device="cpu", group=group)
    m = cfg.sampler.n_walkers
    if group is None:
        state = vmc.init_state(prng_key(1), m, params)
        ids = torch.arange(m)
    else:
        sharded = make_sharded_vmc(vmc, group)
        state = sharded.init_state(prng_key(1), m, params)
        ids = sharded.local_ids(state)
    out = [{"s": state.walkers.s.clone()}]
    for it in range(n_steps):
        state, mt = vmc.step(state, fold_in(prng_key(2), it), ids)
        rec = dict(record(state, mt), overlap=float(mt.overlap),
                   ema={k: v.clone() for k, v in state.ema.items()})
        if state.sr_aux is not None:
            rec["sr_aux"] = state.sr_aux.clone()
        out.append(rec)
    return out


def run_excited(spec, group) -> dict:
    """Tempering (b = 1, 0.6, 0.3; exchange moves, pcg), the deflation
    (c = 2, SPRING) and the additive penalty (beta = 2, no SR) against
    the spec's frozen state, 2 steps each, all with the EMA on."""
    temper = tcfg.load(HEIS, EXCITED_SMALL + (
        "sampler.tempering_betas=[1.0,0.6,0.3]",))
    frozen = (f"optimizer.orthogonalize_to=[{spec['psi0']}]",
              "sampler.n_therm_sweeps=4")
    deflate = tcfg.load(HEIS, EXCITED_SMALL + frozen + (
        "optimizer.deflate_c=2.0", "sr.solver=minsr", "sr.momentum=0.9",
        "sr.diag_shift0=0.1"))
    penalty = tcfg.load(HEIS, EXCITED_SMALL + frozen + (
        "optimizer.orth_beta=2.0", "sr.enabled=false"))
    return {"tempering": _excited_leg(temper, group, 2),
            "deflation": _excited_leg(deflate, group, 2),
            "penalty": _excited_leg(penalty, group, 2)}


#: the measurement leg's 4x4 Heisenberg CNN (Marshall basis, exchange)
MEASURE_SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
                 "sampler.n_walkers=32", "run.csv_path=null")
#: every flag of measure() that the 4x4 square lattice takes
MEASURE_FLAGS = dict(n_samples=4, sweeps_between=1, total_spin=True,
                     dimer=True, sector_momentum=[0, 0], lanczos=True,
                     renyi2_region=["half", "8:16", "0,5"], sma=True)


def measure_spec(work: str) -> dict:
    """Two states of the measurement leg's model, the seeded params
    perturbed twice, saved as snapshots in ``work``: the measured state
    and the fidelity's second state."""
    import numpy as np

    cfg = tcfg.load(HEIS, MEASURE_SMALL)
    _, params, _ = tb.build(cfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    out = {}
    for name in ("psi", "psi2"):
        out[name] = os.path.join(work, f"{name}.params.npz")
        np.savez(out[name], **{k: (v + 0.3 * torch.randn(
            v.shape, generator=gen)).numpy() for k, v in params.items()})
    return out


def run_measure(spec, group) -> dict:
    """``measure()`` with MEASURE_FLAGS and the fidelity against the spec's
    second state, on this rank's walkers (all with no group): the report,
    this rank's walkers after thermalization and the per-sample pooled
    per-walker arrays (the Lanczos (E_loc, G), the sector's num and den)."""
    import numpy as np
    from qmcnn_tpu_torch.measure import measure

    over = MEASURE_SMALL + (("run.distributed=true",) if group else ())
    rec = {}
    report = measure(tcfg.load(HEIS, over), spec["psi"], device="cpu",
                     group=group, record=rec, fidelity_ckpt=spec["psi2"],
                     **MEASURE_FLAGS)
    tr = rec["traces"]
    return {"report": report, "walkers": rec["walkers"],
            **{k: torch.from_numpy(np.stack(tr[k])) for k in (
                "lanczos_e1", "lanczos_g", "sector_num", "sector_den")}}


def run_pcg_trace(spec, group) -> dict:
    """heis10x10_sr from the fixture, tempered at (1.0, 0.7, 0.45), with the
    spec's overrides (the sweeps, steps and walkers), as chip_smoke.py's
    sharded legs train it, on this rank's walkers (all with no group) on
    the spec's device. Every value pcg's loop tests read is recorded as
    ``sr._agreed`` returned it: per solve, [atol2, rr] before the loop and
    [bad, rr] after each iteration. Returns the params and the walkers
    after thermalization and, per step, the walkers, params, sr_iters, the
    energy, pcg's right-hand side b (the gradient) and the solve's trace.

    With ``spec["split_mean"]`` (one process, no group) the S matvec's
    walker mean is taken as the mean of two half-means, the summation
    order of 2 ranks without a collective."""
    from qmcnn_tpu_torch import sr as srmod
    from qmcnn_tpu_torch.train import chunked_thermalize
    from qmcnn_tpu_torch.utils.transfer import warm_start

    cfg = tcfg.load(HEIS, tuple(spec["overrides"]))
    device = spec["device"]
    vmc, params, _ = tb.build(cfg, device=device, group=group)
    params = warm_start(params, cfg.run.init_from)
    m = cfg.sampler.n_walkers
    key = prng_key(cfg.run.seed + 100)
    if group is None:
        state = vmc.init_state(fold_in(key, 0), m, params, device=device)
        ids = torch.arange(m, device=device)
    else:
        sharded = make_sharded_vmc(vmc, group)
        state = sharded.init_state(fold_in(key, 0), m, params)
        ids = sharded.local_ids(state)
    state = chunked_thermalize(vmc, state, fold_in(key, 1), ids,
                               cfg.sampler.n_therm_sweeps,
                               cfg.run.therm_sweeps_per_dispatch)
    out = {"s_therm": state.walkers.s.cpu(), "steps": [],
           "params0": {k: v.cpu() for k, v in state.params.items()}}
    traces = []
    agreed, pcg = srmod._agreed, srmod.pcg_flat

    rhs = []

    def traced_pcg(matvec, b, *args, **kw):
        traces.append([])
        rhs.append(b.detach().cpu())
        return pcg(matvec, b, *args, **kw)

    def traced_agreed(values, grp):
        got = agreed(values, grp)
        traces[-1].append(got)
        return got

    op_matvec = srmod.JacobianSOperator.matvec

    def halves_matvec(op, v, diag_shift):
        h = op.m_local // 2
        parts = [op_matvec(srmod.JacobianSOperator(
            oc_re=op.oc_re[rows], diag_s=op.diag_s, m_local=h,
            oc_im=None if op.oc_im is None else op.oc_im[rows]), v, 0.0)
            for rows in (slice(0, h), slice(h, None))]
        return (parts[0] + parts[1]) / 2 + diag_shift * v

    srmod.pcg_flat, srmod._agreed = traced_pcg, traced_agreed
    if spec.get("split_mean"):
        srmod.JacobianSOperator.matvec = halves_matvec
    try:
        base_key = fold_in(key, 2)
        for _ in range(cfg.run.n_steps):
            state, mt = vmc.step(state, fold_in(base_key, state.step), ids)
            out["steps"].append({
                "s": state.walkers.s.cpu(),
                "params": {k: v.cpu() for k, v in state.params.items()},
                "sr_iters": int(mt.sr_iters),
                "energy_re": float(mt.energy_re), "b": rhs[-1],
                "trace": torch.tensor(traces[-1], dtype=torch.float64)})
    finally:
        srmod.pcg_flat, srmod._agreed = pcg, agreed
        srmod.JacobianSOperator.matvec = op_matvec
    return out


def run_tdvp(spec, group) -> dict:
    """TDVP.rhs of the 8-site TFIM chain's complex CNN in every mode and
    solver, on the basis with Born weights and on the spec's MC batch with
    uniform weights: this rank's rows of the samples and their weights
    (all of them with no group; the weights normalized over every rank)."""
    from qmcnn_tpu_torch.ops.tdvp import TDVP, all_states, state_weights
    from qmcnn_tpu_torch.sr import ravel

    lat = chain(N)
    model = LogPsiCNN(lattice_shape=(N,), channels=(4, 4),
                      complex_params=True, param_scale=0.2)

    def log_psi_fn(p, s):
        return log_psi_apply(model, p, s)

    params = spec["params"]
    basis = torch.as_tensor(all_states(N))
    mc = spec["mc"]
    sets = {"born": (basis, state_weights(log_psi_fn, params, basis)),
            "uniform": (mc, torch.full((mc.shape[0],), 1.0 / mc.shape[0]))}
    out = {}
    for name, (s, w) in sets.items():
        if group is not None:
            rows = group.rows(s.shape[0])
            s, w = s[rows], w[rows]
        for mode in ("imag", "real"):
            for solver in ("dense", "minsr"):
                r = TDVP(log_psi_fn, TFIM(lat, h=1.2), mode=mode,
                         solver=solver, diag_shift=0.1, group=group
                         ).rhs(params, s, w)
                out[f"{name}_{mode}_{solver}"] = {
                    "theta_dot": ravel(r.theta_dot)[0],
                    "scalars": torch.stack([r.energy.re, r.energy.im,
                                            r.e_var, r.tdvp_error,
                                            r.residual])}
    return out


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    suite = sys.argv[4] if len(sys.argv) > 4 else "all"
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=True)
    device = spec.get("device", "cpu")
    if device != "cpu":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    group = walker_group(device=device)
    if suite == "excited":
        out = run_excited(spec, group)
    elif suite == "measure":
        out = run_measure(spec, group)
    elif suite == "tdvp":
        out = run_tdvp(spec, group)
    elif suite == "pcg":
        out = run_pcg_trace(spec, group)
    else:
        out = run_all(spec, group, work)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "qmcnn_tpu"))
    assert not jax_mods, f"a rank imported {jax_mods[:3]}"
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
