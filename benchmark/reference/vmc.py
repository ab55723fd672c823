"""One VMC training step written out plainly, to follow a run step by step
from the walkers it sampled:

  E_loc on the walkers -> energy (the loss) -> the covariance gradient
  F = Re <O* (E_loc - <E>)> -> the SR direction (S + shift) d = F, by
  Jacobi-preconditioned CG on the materialized scores (``pcg``) or by the
  sample-space push-through solve (``minsr``) -> clip by the global norm ->
  SGD at the schedule's learning rate.

S = Re <O* O> - Re <O*><O> with O = d log psi / d theta (the real model
has no imaginary part). The diagonal shift is max(s0 b^step, s_min); the
schedule's count is the optimizer's. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import grad, vmap

from benchmark.reference import hamiltonian, models

Params = Dict[str, torch.Tensor]


def learning_rate(cfg: dict, count: int) -> float:
    o, n_steps = cfg["optimizer"], int(cfg["run"]["n_steps"])
    lr = float(o["lr"])
    if o["schedule"] == "constant":
        return lr
    if o["schedule"] == "cosine":
        decay = int(o["decay_steps"] or n_steps)
        alpha = float(o["lr_min_ratio"])
        c = min(count, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr * ((1.0 - alpha) * cos + alpha)
    raise NotImplementedError(f"schedule {o['schedule']!r}")


def diag_shift(cfg: dict, step: int) -> float:
    s = cfg["sr"]
    return max(float(s["diag_shift0"]) * float(s["diag_shift_decay"]) ** step,
               float(s["diag_shift_min"]))


def flat(params: Params) -> torch.Tensor:
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def _unflat(v: torch.Tensor, like: Params) -> Params:
    out, pos = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = v[pos:pos + n].reshape(like[k].shape)
        pos += n
    return out


def scores(cfg: dict, params: Params, s: torch.Tensor, prec: str,
           block: int = 256) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(O_re [M, P], O_im [M, P] or None for a real model): the per-walker
    gradients of log psi, one walker at a time under ``vmap``, in blocks of
    walkers."""
    keys = sorted(params)
    cplx = bool(cfg["model"]["complex_params"])

    def part(idx):
        def f(p, si):
            return models.log_psi(cfg, p, si[None, :], prec)[idx][0]
        g = vmap(grad(f), in_dims=(None, 0))
        rows = []
        for i in range(0, s.shape[0], block):
            d = g(params, s[i:i + block])
            rows.append(torch.cat([d[k].reshape(d[k].shape[0], -1)
                                   for k in keys], 1))
        return torch.cat(rows)

    return part(0), (part(1) if cplx else None)


def pcg(matvec, b: torch.Tensor, inv_diag: torch.Tensor, tol: float,
        maxiter: int) -> Tuple[torch.Tensor, int]:
    """Jacobi-preconditioned CG from x = 0, until ||r||^2 <= (tol ||b||)^2
    or ``maxiter`` iterations."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_diag * r
    p = z.clone()
    rz = torch.dot(r, z)
    atol2 = float((tol * torch.linalg.norm(b)) ** 2)
    k = 0
    while k < maxiter and float(torch.dot(r, r)) > atol2:
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


def residual_of(matvec, f: torch.Tensor):
    """``r(g)``: how far the direction g is from solving (S + shift) d = F,
    whatever its length (the clip rescales it): the least
    || a (S + shift) g - F || / || F || over the scale a, in float64 after
    the float32 matvec."""
    b = f.double()

    def r(g: torch.Tensor) -> float:
        with models.precision("f32"):
            a = matvec(g.to(f.dtype)).double()
        alpha = torch.dot(a, b) / torch.clamp(torch.dot(a, a), min=1e-300)
        return float(torch.linalg.norm(alpha * a - b) / torch.linalg.norm(b))
    return r


def clipped(cfg: dict, delta: torch.Tensor) -> torch.Tensor:
    """The direction as the optimizer gets it: scaled to the clip norm when
    longer."""
    norm = torch.linalg.norm(delta)
    clip = float(cfg["optimizer"]["clip_norm"] or 0.0)
    if clip and float(norm) >= clip:
        return delta / norm * clip
    return delta


#: the largest parameter count whose (S + shift) is solved densely for the
#: ``exact`` record of a pcg step
DENSE_P = 20_000


def step(cfg: dict, params: Params, s: torch.Tensor, step_no: int,
         count: int, prec: str = "f32", e_block: int = 65536,
         system: bool = False):
    """One step on walkers s [M, N]: returns (new params, record) where the
    record holds the loss, the gradient F and the clipped direction as
    flat [P] vectors, and the walkers' log psi. With ``system`` it also
    holds ``residual`` (:func:`residual_of` of this step's system) and, for
    pcg up to ``DENSE_P`` parameters, ``exact``: the clipped direction of
    the system solved densely in float64 (what pcg's tolerance allows it to
    miss)."""
    with torch.no_grad():
        lp = models.log_psi_blocks(cfg, params, s, prec, e_block)
        e_re, e_im = hamiltonian.local_energy(
            cfg, lambda x: models.log_psi(cfg, params, x, prec), s, lp,
            e_block)
    m = s.shape[0]
    d_re, d_im = e_re - e_re.mean(), e_im - e_im.mean()
    o_re, o_im = scores(cfg, params, s, prec)
    with models.precision(prec):
        oc_re = o_re - o_re.mean(0)
        f = d_re @ oc_re / m
        oc_im = None
        if o_im is not None:
            oc_im = o_im - o_im.mean(0)
            f = f + d_im @ oc_im / m
        shift = diag_shift(cfg, step_no)
        solver = cfg["sr"]["solver"]
        iters = 0

        def matvec(v):
            out = (oc_re @ v) @ oc_re
            if oc_im is not None:
                out = out + (oc_im @ v) @ oc_im
            return out / m + shift * v

        if solver == "pcg":
            diag = (oc_re * oc_re).mean(0)
            if oc_im is not None:
                diag = diag + (oc_im * oc_im).mean(0)
            delta, iters = pcg(matvec, f, 1.0 / (diag + shift),
                               float(cfg["sr"]["cg_tol"]),
                               int(cfg["sr"]["cg_maxiter"]))
        elif solver == "minsr":
            o = oc_re if oc_im is None else torch.cat([oc_re, oc_im])
            eps = d_re if oc_im is None else torch.cat([d_re, d_im])
            gram = o @ o.T / m + shift * torch.eye(o.shape[0],
                                                   device=o.device)
            y = torch.linalg.solve(gram, eps)
            delta = (y @ o) / m
        else:
            raise NotImplementedError(f"solver {solver!r}")
    g = clipped(cfg, delta)
    lr = learning_rate(cfg, count)
    new = _unflat(flat(params) - lr * g, params)
    rec = {"loss": float(e_re.mean()), "f": f, "g": g, "iters": iters,
           "lp": lp}
    if system:
        rec["residual"] = residual_of(matvec, f)
        if solver == "pcg" and f.numel() <= DENSE_P:
            o = oc_re.double()
            dense = o.T @ o
            if oc_im is not None:
                dense = dense + oc_im.double().T @ oc_im.double()
            dense = dense / m + shift * torch.eye(f.numel(), device=f.device,
                                                  dtype=torch.float64)
            exact = torch.linalg.solve(dense, f.double()).to(f.dtype)
            rec["exact"] = clipped(cfg, exact)
    return new, rec


def follow(cfg: dict, params: Params, walkers: List[torch.Tensor],
           step0: int, count0: int, prec: str = "f32",
           keep: Optional[slice] = None, system: bool = False) -> dict:
    """Follow a run through len(walkers) steps from ``params``, step t on
    the walkers the run sampled at step t. ``keep`` restricts every step to
    those walkers (a planted fault: part of the batch left out). Returns
    {"losses", "f1", "g1", "params_out", "iters", "lp"}, and with
    ``system`` the first step's ``residual`` (a function of a flat
    direction) and, where :func:`step` gives it, ``g1_exact``."""
    losses, iters, lps = [], [], []
    out = {}
    p = params
    for t, s in enumerate(walkers):
        if keep is not None:
            s = s[keep]
        p, rec = step(cfg, p, s, step0 + t, count0 + t, prec,
                      system=system and t == 0)
        losses.append(rec["loss"])
        iters.append(rec["iters"])
        lps.append(rec["lp"])
        if t == 0:
            out = {"f1": _unflat(rec["f"], params),
                   "g1": _unflat(rec["g"], params)}
            if "residual" in rec:
                out["residual"] = rec["residual"]
            if "exact" in rec:
                out["g1_exact"] = _unflat(rec["exact"], params)
    return dict(out, losses=losses, params_out=p, iters=iters, lp=lps)
