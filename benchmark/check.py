"""The comparison that decides ``correct``: the numbers a run is judged by,
each read between what the program produced and what the plain reference
(``reference/``) works out from the same inputs, and held to the cell's
limits (``limits/<cell>.json``).

Training (the reference follows the checked steps of set-up, each on the
walkers the program sampled at that step, from the weights the benchmark
made):
  * ``loss``: the widest relative gap of a step's energy;
  * ``grad``: the first step's gradient as the optimizer gets it (the
    clipped SR direction, worked out from the params of steps 1 and 2 as
    (p1 - p2) / lr), by the worst leaf: the gap between the two norms of a
    leaf over the larger of the reference's norm of that leaf and of the
    median leaf;
  * ``change``: the same for the params' change over the checked steps;
  * ``grad_median``, ``change_median``: the median leaf's gaps;
  * ``sr_residual``: how far the program's first direction is from solving
    the reference's SR system (S + shift) d = F, whatever its length:
    min over a of || a (S + shift) g - F || / || F ||. The norms of the
    leaves cannot tell a direction within the solver's tolerance from a
    wrong one; this number can (pcg stops at a residual of ``cg_tol``).
  Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out of the leaf gaps (a rule on the reference, not a
  name).
The sampling that the reference cannot follow is checked by itself:
  * ``log_psi``: the widest gap between the log psi the sampler cached for a
    walker and the reference's at the params the sampler used (real part,
    and phase mod 2 pi);
  * ``sz``: the largest |sum of spins| of a walker (exchange moves keep
    S^z = 0);
  * ``unmoved``: the largest share of walkers a step's sweeps left as they
    were.
Measurement (answers of samples drawn from the seed, after the window):
  ``energy``, ``ss_nn`` (relative gaps), ``diagonal`` (the widest absolute
  gap of the magnetization, the staggered moments and S^z correlations),
  and ``log_psi``, ``sz``, ``unmoved`` as above.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from benchmark.reference import estimators, models
from benchmark.reference import vmc as rvmc

Params = Dict[str, torch.Tensor]


def leaf_norms(p: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in p.items()}


def counted_leaves(f_ref: Params) -> List[str]:
    """Leaves whose reference gradient is at least 1e-3 of the median
    leaf's."""
    norms = leaf_norms(f_ref)
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def leaf_gaps(a: Params, b: Params, keys: List[str]) -> Dict[str, float]:
    """| |a_k| - |b_k| | / max(|b_k|, median_k |b_k|) for each of ``keys``."""
    na, nb = leaf_norms(a), leaf_norms(b)
    med = statistics.median(nb[k] for k in keys)
    return {k: abs(na[k] - nb[k]) / max(nb[k], med, 1e-30) for k in keys}


def leaf_gap(a: Params, b: Params, keys: List[str]) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(a, b, keys).values())


def _sub(a: Params, b: Params, scale: float = 1.0) -> Params:
    return {k: (a[k] - b[k]) * scale for k in a}


def trajectory_numbers(traj: dict, ref: dict, params0: Params,
                       detail: Optional[dict] = None) -> dict:
    """loss, grad, change, their medians and sr_residual of a trajectory
    {"losses", "g1", "params_out"} against the reference's (followed with
    ``system``); ``detail`` (a dict) receives each step's loss gap, the
    worst leaves, the reference's pcg iterations and its own residual, and
    for pcg how far each side's direction lies from the dense solve."""
    keys = counted_leaves(ref["f1"])
    losses = [abs(a - b) / max(abs(b), 1.0)
              for a, b in zip(traj["losses"], ref["losses"])]
    grad = leaf_gaps(traj["g1"], ref["g1"], keys)
    change = leaf_gaps(_sub(traj["params_out"], params0),
                       _sub(ref["params_out"], params0), keys)
    residual = ref["residual"]
    if detail is not None:
        detail.update({
            "loss_by_step": losses, "leaves_counted": len(keys),
            "grad_worst_leaf": max(grad, key=grad.get),
            "change_worst_leaf": max(change, key=change.get),
            "ref_iters": ref["iters"],
            "ref_residual": residual(rvmc.flat(ref["g1"]))})
        if "g1_exact" in ref:
            detail.update({
                "ref_vs_exact": leaf_gap(ref["g1"], ref["g1_exact"], keys),
                "program_vs_exact": leaf_gap(traj["g1"], ref["g1_exact"],
                                             keys),
                "exact_residual": residual(rvmc.flat(ref["g1_exact"]))})
    return {"loss": max(losses), "grad": max(grad.values()),
            "change": max(change.values()),
            "grad_median": statistics.median(grad.values()),
            "change_median": statistics.median(change.values()),
            "sr_residual": residual(rvmc.flat(traj["g1"]))}


def program_trajectory(cfg: dict, stash: dict, count0: int) -> dict:
    """The program's checked steps as a trajectory: its energies, its first
    step's gradient from the params entering steps 1 and 2, its params
    after the last."""
    p = stash["params_in"]
    lr = rvmc.learning_rate(cfg, count0)
    return {"losses": list(stash["energy"]),
            "g1": _sub(p[0], p[1], 1.0 / lr),
            "params_out": stash["params_out"]}


def _phase_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b + math.pi) % (2.0 * math.pi) - math.pi
    return d.abs()


def sampling_numbers(cfg: dict, stash: dict, prec: str = "f32") -> dict:
    """log_psi, sz and unmoved of the walkers the program's sweeps
    produced."""
    lp_gap = lp_mean = sz = unmoved = 0.0
    for p, s_in, s_out, (lp_re, lp_im) in zip(
            stash["params_in"], stash["s_in"], stash["s_out"],
            stash["lp_out"]):
        re, im = models.log_psi_blocks(cfg, p, s_out, prec)
        gap = torch.maximum((lp_re - re).abs(), _phase_gap(lp_im, im))
        lp_gap = max(lp_gap, float(gap.max()))
        lp_mean = max(lp_mean, float(gap.mean()))
        sz = max(sz, float(s_out.sum(-1).abs().max()))
        same = (s_out == s_in).all(-1).float().mean()
        unmoved = max(unmoved, float(same))
    return {"log_psi": lp_gap, "log_psi_mean": lp_mean, "sz": sz,
            "unmoved": unmoved}


def train_numbers(cfg: dict, params0: Params, stash: dict, step0: int,
                  count0: int, detail: Optional[dict] = None) -> dict:
    """Every number of a training run."""
    ref = rvmc.follow(cfg, params0, stash["s_out"], step0, count0,
                      system=True)
    out = trajectory_numbers(program_trajectory(cfg, stash, count0), ref,
                             params0, detail)
    out.update(sampling_numbers(cfg, stash))
    return out


def measure_numbers(cfg: dict, params0: Params, stash: dict) -> dict:
    """Every number of a measurement run: each checked sample's answers
    against the reference's on the same walkers."""
    out = answer_numbers(cfg, params0, stash["s_out"], stash["answers"])
    out.update(sampling_numbers(cfg, stash))
    return out


def answer_numbers(cfg: dict, params0: Params, walkers, answers_list,
                   ref_list=None) -> dict:
    """energy, ss_nn and diagonal of the answers against the reference's
    (``ref_list``, worked out here when not given)."""
    energy = ss_nn = diagonal = 0.0
    for i, (s, answers) in enumerate(zip(walkers, answers_list)):
        ref = (estimators.sample(cfg, params0, s) if ref_list is None
               else ref_list[i])
        energy = max(energy, abs(answers["energy"] - float(ref["energy"]))
                     / max(abs(float(ref["energy"])), 1.0))
        ss_nn = max(ss_nn, abs(answers["ss_nn"] - float(ref["ss_nn"]))
                    / max(abs(float(ref["ss_nn"])), 1e-2))
        for key in ("magnetization", "mst2", "mst4", "corr"):
            prog = torch.as_tensor(answers[key], dtype=torch.float64)
            gap = (prog - ref[key].double().cpu()).abs().max()
            diagonal = max(diagonal, float(gap))
    return {"energy": energy, "ss_nn": ss_nn, "diagonal": diagonal}


# ---------------------------------------------------------------------------
# the control and the planted faults (calibrate.py reads them on the chip)
# ---------------------------------------------------------------------------

def lower_precision(cfg: dict) -> str:
    """The nearest precision below the configuration's: TF32 under a
    float32 config (computed with TF32 off), float8 under bf16."""
    return "fp8" if cfg["model"]["compute_dtype"] == "bfloat16" else "tf32"


def control_log_psi(cfg: dict, params_list, walkers) -> dict:
    """log_psi and log_psi_mean of the reference in the lower precision
    against the reference, at each step's params and walkers."""
    low = lower_precision(cfg)
    worst = mean = 0.0
    for p, s in zip(params_list, walkers):
        a = models.log_psi_blocks(cfg, p, s, "f32")
        b = models.log_psi_blocks(cfg, p, s, low)
        gap = torch.maximum((a[0] - b[0]).abs(), _phase_gap(a[1], b[1]))
        worst = max(worst, float(gap.max()))
        mean = max(mean, float(gap.mean()))
    return {"log_psi": worst, "log_psi_mean": mean}


def train_controls(cfg: dict, params0: Params, stash: dict, step0: int,
                   count0: int, witness: bool = False) -> dict:
    """{reading: numbers} of the control (the reference put in the
    program's place, in the lower precision) and of the faults planted in
    it: half of the batch left out; a state left unchanged reads 1 on
    ``grad`` and ``change`` by construction. With ``witness`` under a bf16
    configuration, also the reference in bf16 (``bf16``): what the
    configuration's own rounding alone does to each number."""
    ref = rvmc.follow(cfg, params0, stash["s_out"], step0, count0,
                      system=True)
    m = stash["s_out"][0].shape[0]
    out = {}
    runs = {"control": dict(prec=lower_precision(cfg)),
            "half": dict(keep=slice(0, m // 2))}
    if witness and cfg["model"]["compute_dtype"] == "bfloat16":
        runs["bf16"] = dict(prec="bf16")
    for name, kw in runs.items():
        traj = rvmc.follow(cfg, params0, stash["s_out"], step0, count0,
                           **kw)
        detail = {}
        out[name] = trajectory_numbers(traj, ref, params0, detail)
        out[name].update({k: v for k, v in detail.items()
                          if k not in ("loss_by_step", "leaves_counted")})
    out["control"].update(control_log_psi(cfg, stash["params_in"],
                                          stash["s_out"]))
    out["unchanged"] = {"grad": 1.0, "change": 1.0, "grad_median": 1.0,
                        "change_median": 1.0, "unmoved": 1.0}
    return out


def measure_controls(cfg: dict, params0: Params, stash: dict) -> dict:
    """{reading: numbers} of the control (the reference in the lower
    precision in the program's place) and of the planted faults: half of
    the walkers, and the first walker's E_loc and S.S terms left out (an
    answer altered where it is produced)."""
    refs = [estimators.sample(cfg, params0, s) for s in stash["s_out"]]

    def as_answers(est):
        return {k: (v.detach().cpu().numpy() if v.dim() else float(v))
                for k, v in est.items()}

    low = lower_precision(cfg)
    control = [as_answers(estimators.sample(cfg, params0, s, low))
               for s in stash["s_out"]]
    half = [as_answers(estimators.sample(cfg, params0, s[: s.shape[0] // 2]))
            for s in stash["s_out"]]
    altered = []
    for s in stash["s_out"]:
        rest = as_answers(estimators.sample(cfg, params0, s[1:]))
        m = s.shape[0]
        altered.append(dict(rest, energy=rest["energy"] * (m - 1) / m))
    walkers = stash["s_out"]
    return {"control": dict(answer_numbers(cfg, params0, walkers, control,
                                           refs),
                            **control_log_psi(cfg, [params0] * len(walkers),
                                              walkers)),
            "half": answer_numbers(cfg, params0, walkers, half, refs),
            "altered": answer_numbers(cfg, params0, walkers, altered,
                                      refs),
            "unchanged": {"unmoved": 1.0}}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every limited number read, finite and at or under its limit (no
    limits at all fails). Numbers without a limit are not compared."""
    return bool(limits) and all(
        name in numbers and math.isfinite(numbers[name])
        and numbers[name] <= lim for name, lim in limits.items())


def compared(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell compares."""
    return {name: {"value": numbers.get(name), "limit": lim}
            for name, lim in limits.items()}


def limit_lines(numbers: dict, limits: dict) -> List[str]:
    return [f"{name} {numbers.get(name)!r} limit {lim!r}"
            for name, lim in limits.items()]
