"""The VMC driver: estimators, gradient and the training step (port of
``qmcnn_tpu/vmc.py``, single device, ground-state path).

One training step:
  refresh -> sample -> local energy -> covariance gradient (surrogate
  loss) -> [stochastic reconfiguration] -> optimizer update.

Gradient convention (real parameters): F_k = Re[<O_k* dE>] with
O_k = d log psi / d theta_k and dE = E_loc - <E>, the gradient of the
surrogate loss L = mean(Re[conj(dE) * log psi]). The true energy
derivative is 2F; the factor is absorbed into the learning rate, as in the
JAX package, so config learning rates carry over unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.func import grad

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sampler.metropolis import (MetropolisSampler,
                                                WalkerState, fold_in)


class TrainState(NamedTuple):
    params: Any      # flat Flax-keyed dict of tensors
    opt_state: Any
    walkers: WalkerState
    step: int


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
                    chunk_size: Optional[int] = None):
    """(e_mean C, e_var, grads dict, e_loc C[M]) from the walkers."""
    e_loc = local_energy(log_psi_fn, params, ham, walkers.s, walkers.log_psi,
                         chunk_size=chunk_size)
    e_mean = e_loc.mean()
    e_var = (e_loc - e_mean).abs2().mean()
    centered = e_loc - e_mean
    delta = C(centered.re.detach(), centered.im.detach())

    def loss_fn(p):
        lp = log_psi_fn(p, walkers.s)
        # L = mean Re[conj(dE) log psi]  ->  grad = Re[<O* dE>]
        return torch.mean(delta.re * lp.re + delta.im * lp.im)

    grads = grad(loss_fn)(params)
    return e_mean, e_var, grads, e_loc


@dataclasses.dataclass(frozen=True, eq=False)
class VMC:
    """Binds model, Hamiltonian, sampler and optimizer into a train step.

    ``step(state, key, walker_ids) -> (state, metrics)``. Excited-state
    penalties, deflation, sector targeting, SPRING and EMA are later
    slices (ROADMAP.md).
    """

    log_psi_fn: Callable[..., C]
    ham: Any
    sampler: MetropolisSampler
    optimizer: Any  # builder.Optimizer: init(params) / update(g, state)
    n_sweeps: int = 1
    sr: Optional[Any] = None
    chunk_size: Optional[int] = None

    def init_state(self, key: int, n_walkers: int, params,
                   device="cpu") -> TrainState:
        walkers = self.sampler.init_state(params, key, n_walkers,
                                          device=device)
        return TrainState(params=params, opt_state=self.optimizer.init(params),
                          walkers=walkers, step=0)

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
            chunk_size=self.chunk_size)
        sr_iters = 0
        sr_residual = torch.zeros((), device=walkers.s.device)
        if self.sr is not None:
            grads, sr_iters, sr_residual = self.sr.solve(
                self.log_psi_fn, params, walkers.s, grads, state.step,
                e_loc=e_loc)
        updates, opt_state = self.optimizer.update(grads, state.opt_state)
        new_params = {k: params[k] + updates[k] for k in params}
        metrics = StepMetrics(
            energy_re=e_mean.re, energy_im=e_mean.im, energy_var=e_var,
            accept_rate=MetropolisSampler.acceptance_rate(walkers),
            grad_norm=global_norm(grads), sr_iters=sr_iters,
            sr_residual=sr_residual)
        return TrainState(params=new_params, opt_state=opt_state,
                          walkers=walkers, step=state.step + 1), metrics

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
