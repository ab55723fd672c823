"""Excited states by orthogonality penalty and exact deflation (port of
``qmcnn_tpu/ops/penalty.py``).

Penalty: minimize E[psi] + beta * sum_k F_k with
  F_k = |<psi_k|psi>|^2 / (<psi_k|psi_k> <psi|psi>)
against FROZEN, previously trained states psi_k; with beta above the gap
the minimizer is the lowest state orthogonal to every psi_k.

Two-chain estimator:
  F = E_{s ~ |psi|^2}[psi_k(s)/psi(s)] * E_{t ~ |psi_k|^2}[psi(t)/psi_k(t)]
The second chain samples the frozen state, which never changes, so its
batch is drawn once (builder time) and kept, replicated on every rank; only
the live chain's means reduce over a walker group. A single-chain
estimator |E[r]|^2 / E[|r|^2] returns exactly 1 with zero gradient when
the live walkers collapse onto one configuration; the frozen chain keeps
a diverse support.

Gradients: the live-chain expectation is a reweighted mean
  E_w[x] = mean(w x) / mean(w),  w = exp(2 (log|psi_theta| - sg(log|psi|)))
(w = 1 at the evaluation point), so autograd flows through the amplitude
ratios and the sampling distribution; the frozen-chain factor carries the
gradient through psi_theta(t) directly.

The forwards that JAX stop-gradients (psi_k on the live walkers, psi_theta
on the frozen batch in deflation, the frozen batch's cached log psi_k) run
through an evaluation forward: each frozen state holds its own
(``FrozenState.log_psi_fn``, the fused GCNN or CNN forward on CUDA for an
eligible model), so the kernels' weight caches are not re-filled when the
live and frozen params alternate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


class FrozenState(NamedTuple):
    """A frozen wavefunction to orthogonalize against: its evaluation
    forward and params, a batch ``s_frozen`` drawn from |psi_k|^2 once, and
    that batch's cached log psi_k."""

    log_psi_fn: object
    params: dict
    s_frozen: torch.Tensor   # [M0, N] ~ |psi_k|^2
    lp_frozen: C             # [M0] log psi_k(s_frozen)


def make_frozen_state(log_psi_fn, params, s_frozen: torch.Tensor
                      ) -> FrozenState:
    params = {k: v.detach() for k, v in params.items()}
    s_frozen = s_frozen.detach()
    with torch.no_grad():
        lp = log_psi_fn(params, s_frozen)
    return FrozenState(log_psi_fn, params, s_frozen,
                       C(lp.re.detach(), lp.im.detach()))


def _live_means(xs, group):
    """The group means of the live chain's local means ``xs``. Their values
    are the all-reduced means; their gradients stay the local ones, which
    the caller averages over the group afterwards (the frozen chain's part
    is the same on every rank, so that average keeps it)."""
    if group is None:
        return xs
    from qmcnn_tpu_torch.vmc import pmean_all

    means = pmean_all([x.detach() for x in xs], group)
    return [g + (x - x.detach()) for g, x in zip(means, xs)]


def overlap_sq(lp_live: C, lpk_live: C, lp_on_frozen: C, lpk_frozen: C,
               group=None) -> torch.Tensor:
    """Two-chain F = E_live[psi_k/psi] * E_frozen[psi/psi_k] (real part).

    Args:
      lp_live: log psi_theta on the live walkers [M] (carries gradients;
        the sampling dependence enters through the reweighting).
      lpk_live: log psi_k on the live walkers [M] (constants).
      lp_on_frozen: log psi_theta on the frozen batch [M0] (gradients).
      lpk_frozen: cached log psi_k on the frozen batch [M0] (constants).
      group: the walker group; the live chain's stabilizer takes its max,
        its means the group mean.
    """
    w = torch.exp(2.0 * (lp_live.re - lp_live.re.detach()))  # 1 at eval
    d1 = C(lpk_live.re - lp_live.re, lpk_live.im - lp_live.im)
    shift1 = torch.max(d1.re).detach()
    if group is not None:
        shift1 = group.agree(shift1)
    r1 = cplx.cexp(C(d1.re - shift1, d1.im))
    mw, a_re, a_im = _live_means(
        [torch.mean(w), torch.mean(w * r1.re), torch.mean(w * r1.im)], group)
    a = C(a_re, a_im) / mw                               # A e^-shift1
    # frozen chain: B = E[psi/psi_k] over the fixed |psi_k|^2 batch
    d2 = C(lp_on_frozen.re - lpk_frozen.re, lp_on_frozen.im - lpk_frozen.im)
    shift2 = torch.max(d2.re).detach()
    r2 = cplx.cexp(C(d2.re - shift2, d2.im))
    b = C(torch.mean(r2.re), torch.mean(r2.im))          # B e^-shift2
    prod = a * b
    # F = Re[ab] e^(shift1 + shift2); F <= 1 in expectation, clamped
    scale = torch.exp(torch.clamp(shift1 + shift2, max=60.0))
    return prod.re * scale


def _chunked_fwd(fn, s: torch.Tensor, chunk_size: Optional[int]) -> C:
    """``fn(s)`` over walker chunks of ``chunk_size`` when that divides the
    batch and is smaller (the same memory bound as the E_loc chunks), else
    in one call (frozen batches need not match the chunk)."""
    m = int(s.shape[0])
    if chunk_size is None or chunk_size >= m or m % chunk_size:
        return fn(s)
    parts = [fn(s[i:i + chunk_size]) for i in range(0, m, chunk_size)]
    return C(torch.cat([p.re for p in parts]),
             torch.cat([p.im for p in parts]))


def deflation_e_loc(log_psi_fn, params, s: torch.Tensor, lp_live: C,
                    frozen: Sequence[FrozenState], group=None,
                    exp_clip: float = 30.0,
                    chunk_size: Optional[int] = None):
    """Per-sample local energy of the deflation projector, and the overlap.

    Exact deflation optimizes the ground state of
      A = H + c * sum_k |psi_k><psi_k| / <psi_k|psi_k>,
    whose lowest eigenstate (c above the gap) is the lowest state
    orthogonal to every psi_k. The projector is folded into the local
    energy, so the covariance gradient, minSR's residuals, SPRING and the
    variance all see A natively (the additive penalty's gradient is
    discarded by the sample-space minSR solve).

    Per sample:
      (P_k psi)(s)/psi(s) = exp(lpk(s) - lp(s)) * rho_k,
      rho_k = E_{t~|psi_k|^2}[psi(t)/psi_k(t)]  (the frozen batch, one
      forward of the live params per step).
    ``log_psi_fn`` is the live evaluation forward; psi_k uses each frozen
    state's own. Returns (d_loc C[M] = sum_k terms WITHOUT the c factor,
    overlap = sum_k Re E_live[term_k]), no gradient. ``exp_clip`` caps the
    per-sample log-ratio, which is unbounded once the states separate.
    """
    with torch.no_grad():
        zeros = torch.zeros_like(lp_live.re)
        d_loc = C(zeros, zeros)
        overlap = torch.zeros((), device=zeros.device)
        for f in frozen:
            lpk_live = _chunked_fwd(lambda t, f=f: f.log_psi_fn(f.params, t),
                                    s, chunk_size)
            lp_on_frozen = _chunked_fwd(lambda t: log_psi_fn(params, t),
                                        f.s_frozen, chunk_size)
            # rho_k = mean exp(d2), stabilized: b * e^shift2
            d2 = C(lp_on_frozen.re - f.lp_frozen.re,
                   lp_on_frozen.im - f.lp_frozen.im)
            shift2 = torch.max(d2.re)
            r2 = cplx.cexp(C(d2.re - shift2, d2.im))
            b = C(torch.mean(r2.re), torch.mean(r2.im))
            # per sample: exp(d1) * rho_k = exp(d1.re + shift2) e^{i d1.im} b
            d1 = C(lpk_live.re - lp_live.re, lpk_live.im - lp_live.im)
            amp = torch.exp(torch.clamp(d1.re + shift2, max=exp_clip))
            term = C(amp, zeros) * cplx.cexp(C(zeros, d1.im)) * b
            d_loc = d_loc + term
            mean = torch.mean(term.re)
            overlap = overlap + (mean if group is None else group.mean(mean))
    return d_loc, overlap


def penalty_value_and_grad(log_psi_fn, params, s: torch.Tensor,
                           frozen: Sequence[FrozenState], beta: float,
                           group=None, clip_norm: float = 1.0):
    """(sum_k F_k, d/dtheta [beta * sum_k F_k]) on the live batch ``s``,
    the gradient averaged over the walker group.

    ``log_psi_fn`` is the differentiable model. ``clip_norm`` caps the
    global norm of the beta-scaled gradient: once psi separates from
    psi_k the frozen-chain ratios are unbounded sample by sample; near
    orthogonality the gradient is small and passes unclipped."""
    with torch.no_grad():
        lpk_live = [f.log_psi_fn(f.params, s) for f in frozen]
    keys = list(params)
    p = {k: params[k].detach().requires_grad_(True) for k in keys}
    with torch.enable_grad():
        lp_live = log_psi_fn(p, s)
        total = torch.zeros((), device=s.device)
        for f, lpk in zip(frozen, lpk_live):
            lp_on_frozen = log_psi_fn(p, f.s_frozen)
            total = total + overlap_sq(lp_live, lpk, lp_on_frozen,
                                       f.lp_frozen, group)
        grads = torch.autograd.grad(total, [p[k] for k in keys],
                                    allow_unused=True)
    grads = [torch.zeros_like(p[k]) if g is None else g
             for k, g in zip(keys, grads)]
    if group is not None:
        from qmcnn_tpu_torch.vmc import pmean_all

        grads = pmean_all(grads, group)
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = beta * torch.clamp(
        clip_norm / torch.clamp(beta * gnorm, min=1e-30), max=1.0)
    return total.detach(), {k: scale * g for k, g in zip(keys, grads)}
