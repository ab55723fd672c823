"""The VMC driver: estimators, gradient and the training step (port of
``qmcnn_tpu/vmc.py``, ground-state path).

One training step:
  refresh -> sample -> local energy -> covariance gradient (surrogate
  loss) -> [stochastic reconfiguration] -> optimizer update.

Gradient convention (real parameters): F_k = Re[<O_k* dE>] with
O_k = d log psi / d theta_k and dE = E_loc - <E>, the gradient of the
surrogate loss L = mean(Re[conj(dE) * log psi]). The true energy
derivative is 2F; the factor is absorbed into the learning rate, as in the
JAX package, so config learning rates carry over unchanged.

Two log-amplitude functions: ``log_psi_fn`` is the differentiable model
(the surrogate loss and the SR Jacobian), ``eval_log_psi_fn`` the
evaluation-only forward that the sampler and the local energy use (the
fused GCNN kernel, or the sweep kernel's recompute forward for the plain
real CNN, where the builder finds it eligible, else the model itself).
The stored walker log psi and the E_loc ratios both come from the latter,
so they are consistent.

Distribution: every estimator mean goes through ``pmean(x, group)``, the
identity with no walker group (one device) and a mean all-reduce over the
ranks of ``parallel.mesh.WalkerGroup`` otherwise; SR uses the same hook.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.func import grad

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sampler.metropolis import WalkerState, fold_in


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the walker group's ranks; identity when not distributed."""
    return x if group is None else group.mean(x)


def pmean_all(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The pmean of each tensor, in one all-reduce."""
    if group is None:
        return tensors
    flat = group.mean(torch.cat([t.reshape(-1) for t in tensors]))
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def pmean_c(z: C, group) -> C:
    return C(*pmean_all([z.re, z.im], group))


class TrainState(NamedTuple):
    params: Any      # flat Flax-keyed dict of tensors
    opt_state: Any
    walkers: WalkerState
    step: int
    #: SPRING's carry (sr.momentum > 0): the previous step's flat natural
    #: gradient [P], replicated over a walker group; None when unused
    sr_aux: Optional[torch.Tensor] = None


class StepMetrics(NamedTuple):
    """Per-step scalar metrics (0-d tensors, or ints for sr_iters)."""

    energy_re: torch.Tensor
    energy_im: torch.Tensor
    energy_var: torch.Tensor
    accept_rate: torch.Tensor
    grad_norm: torch.Tensor
    sr_iters: int            # 0 when SR is off
    sr_residual: torch.Tensor  # 0.0 when SR is off


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(v * v) for v in tree.values()))


def energy_and_grad(log_psi_fn, ham, params, walkers: WalkerState,
                    chunk_size: Optional[int] = None,
                    eval_log_psi_fn: Optional[Callable[..., C]] = None,
                    group=None):
    """(e_mean C, e_var, grads dict, e_loc C[M]) from the walkers. E_loc
    uses ``eval_log_psi_fn`` (None: the model, ``log_psi_fn``), the
    gradient ``log_psi_fn``; the means run over the walker ``group``."""
    if eval_log_psi_fn is None:
        eval_log_psi_fn = log_psi_fn
    e_loc = local_energy(eval_log_psi_fn, params, ham, walkers.s,
                         walkers.log_psi, chunk_size=chunk_size)
    e_mean = pmean_c(e_loc.mean(), group)
    e_var = pmean((e_loc - e_mean).abs2().mean(), group)
    centered = e_loc - e_mean
    delta = C(centered.re.detach(), centered.im.detach())

    def loss_fn(p):
        lp = log_psi_fn(p, walkers.s)
        # L = mean Re[conj(dE) log psi]  ->  grad = Re[<O* dE>]
        return torch.mean(delta.re * lp.re + delta.im * lp.im)

    grads = grad(loss_fn)(params)
    grads = dict(zip(grads, pmean_all(list(grads.values()), group)))
    return e_mean, e_var, grads, e_loc


@dataclasses.dataclass(frozen=True, eq=False)
class VMC:
    """Binds model, Hamiltonian, sampler and optimizer into a train step.

    ``step(state, key, walker_ids) -> (state, metrics)``; with ``group``
    (a ``parallel.mesh.WalkerGroup``) the state holds this rank's walkers
    and the step runs over :mod:`qmcnn_tpu_torch.parallel.mesh`. With SR
    momentum > 0 the step solves SPRING (``SR.solve_spring``), carrying
    delta in ``TrainState.sr_aux``. Excited-state penalties, deflation,
    sector targeting and EMA are later slices (ROADMAP.md).
    """

    log_psi_fn: Callable[..., C]
    ham: Any
    #: MetropolisSampler or, for the ARNN, sampler/direct.py's
    #: DirectSampler (the same interface and WalkerState)
    sampler: Any
    optimizer: Any  # builder.Optimizer: init(params) / update(g, state)
    n_sweeps: int = 1
    sr: Optional[Any] = None
    chunk_size: Optional[int] = None
    #: evaluation-only forward of the sampler and E_loc (None: log_psi_fn)
    eval_log_psi_fn: Optional[Callable[..., C]] = None
    #: the walker group (None: one device, no collective)
    group: Optional[Any] = None

    def __post_init__(self):
        if self.eval_log_psi_fn is None:
            object.__setattr__(self, "eval_log_psi_fn", self.log_psi_fn)

    def init_state(self, key: int, n_walkers: int, params, device="cpu",
                   rows: Optional[slice] = None) -> TrainState:
        """``rows``: keep only these of the ``n_walkers`` walkers drawn."""
        walkers = self.sampler.init_state(params, key, n_walkers,
                                          device=device, rows=rows)
        sr_aux = None
        if self.sr is not None and self.sr.momentum > 0:
            leaf = next(iter(params.values()))
            sr_aux = torch.zeros(sum(v.numel() for v in params.values()),
                                 device=leaf.device)
        return TrainState(params=params, opt_state=self.optimizer.init(params),
                          walkers=walkers, step=0, sr_aux=sr_aux)

    def step(self, state: TrainState, key: int, walker_ids: torch.Tensor,
             noise=None):
        """One training step. ``noise`` overrides the sampler's draws."""
        params = state.params
        walkers = self.sampler.reset_counters(state.walkers)
        walkers = self.sampler.refresh(params, walkers)
        walkers = self.sampler.sample(params, walkers, key, walker_ids,
                                      n_sweeps=self.n_sweeps, noise=noise)
        e_mean, e_var, grads, e_loc = energy_and_grad(
            self.log_psi_fn, self.ham, params, walkers,
            chunk_size=self.chunk_size, eval_log_psi_fn=self.eval_log_psi_fn,
            group=self.group)
        sr_iters = 0
        sr_residual = torch.zeros((), device=walkers.s.device)
        sr_aux = state.sr_aux
        if self.sr is not None and sr_aux is not None:
            grads, sr_iters, sr_residual, sr_aux = self.sr.solve_spring(
                self.log_psi_fn, params, walkers.s, grads, state.step,
                sr_aux, e_loc=e_loc, group=self.group)
        elif self.sr is not None:
            grads, sr_iters, sr_residual = self.sr.solve(
                self.log_psi_fn, params, walkers.s, grads, state.step,
                e_loc=e_loc, group=self.group)
        updates, opt_state = self.optimizer.update(grads, state.opt_state)
        new_params = {k: params[k] + updates[k] for k in params}
        metrics = StepMetrics(
            energy_re=e_mean.re, energy_im=e_mean.im, energy_var=e_var,
            accept_rate=pmean(self.sampler.acceptance_rate(walkers),
                              self.group),
            grad_norm=global_norm(grads), sr_iters=sr_iters,
            sr_residual=sr_residual)
        return TrainState(params=new_params, opt_state=opt_state,
                          walkers=walkers, step=state.step + 1,
                          sr_aux=sr_aux), metrics

    def thermalize(self, state: TrainState, key: int,
                   walker_ids: torch.Tensor, n_sweeps: int) -> TrainState:
        walkers = self.sampler.refresh(state.params, state.walkers)
        walkers = self.sampler.sample(state.params, walkers, key, walker_ids,
                                      n_sweeps=n_sweeps)
        return state._replace(walkers=walkers)

    def run_steps(self, state: TrainState, base_key: int,
                  walker_ids: torch.Tensor, n_steps: int):
        """n_steps training steps; the per-step key is
        fold_in(base_key, state.step), so chunking does not change the
        random streams. Returns (state, [StepMetrics per step])."""
        out: List[StepMetrics] = []
        for _ in range(n_steps):
            state, metrics = self.step(state, fold_in(base_key, state.step),
                                       walker_ids)
            out.append(metrics)
        return state, out
