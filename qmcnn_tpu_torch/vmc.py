"""The VMC driver: estimators, gradient and the training step (port of
``qmcnn_tpu/vmc.py``).

One training step:
  refresh -> sample -> local energy -> covariance gradient (surrogate
  loss) -> [stochastic reconfiguration] -> optimizer update -> [EMA].

Every estimator reads the sampler's physical chain (``sampler.physical``:
the b = 1 rows under parallel tempering). Excited states: the exact
deflation H + c sum_k |psi_k><psi_k| folded into E_loc
(``energy_and_grad(deflate=)``, ``ops/penalty.py``), or the additive
orthogonality penalty; momentum sectors: the Rayleigh quotient of P_q psi
under |psi|^2 (:func:`sector_energy_and_grad`). ``TrainState.ema`` is the
Polyak average of the params.

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
from qmcnn_tpu_torch.utils.memory import divided_chunk
from qmcnn_tpu_torch.utils.profiling import annotate, unit


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
    #: Polyak/EMA average of the params (optimizer.ema_decay > 0), updated
    #: as ema <- d ema + (1 - d) params after every update; a params-keyed
    #: dict, replicated over a walker group; None when unused
    ema: Optional[dict] = None


class StepMetrics(NamedTuple):
    """Per-step scalar metrics (0-d tensors, or ints for sr_iters)."""

    energy_re: torch.Tensor
    energy_im: torch.Tensor
    energy_var: torch.Tensor
    accept_rate: torch.Tensor
    grad_norm: torch.Tensor
    sr_iters: int            # 0 when SR is off
    sr_residual: torch.Tensor  # 0.0 when SR is off
    #: sum_k F_k against the frozen states, or the sector weight |<P_q>|
    #: in sector mode; 0.0 when neither is on
    overlap: torch.Tensor


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(v * v) for v in tree.values()))


def _surrogate_grads(log_psi_fn, params, s: torch.Tensor, centered: C,
                     group) -> dict:
    """Re[<O* dE>]: the gradient of L = mean Re[conj(dE) log psi] with dE
    held constant, averaged over the walker group."""
    delta = C(centered.re.detach(), centered.im.detach())

    def loss_fn(p):
        lp = log_psi_fn(p, s)
        return torch.mean(delta.re * lp.re + delta.im * lp.im)

    with annotate("gradient"):
        grads = grad(loss_fn)(params)
        return dict(zip(grads, pmean_all(list(grads.values()), group)))


def sector_chunk_size(chunk_size: Optional[int], lattice_shape,
                      m: int) -> Optional[int]:
    """The sector estimator's walker chunk: the E_loc chunk divided by the
    T translations the projector multiplies the working set by, rounded
    down to a divisor of M (None: unchunked)."""
    if chunk_size is None:
        return None
    t_trans = 1
    for d in lattice_shape:
        t_trans *= int(d)
    return divided_chunk(chunk_size, t_trans, m)


def sector_energy_and_grad(log_psi_fn, ham, params, walkers: WalkerState,
                           lattice_shape, momentum, kappa: float = 0.0,
                           chunk_size: Optional[int] = None,
                           eval_log_psi_fn: Optional[Callable[..., C]] = None,
                           group=None):
    """Momentum-sector Rayleigh-quotient gradient under |psi|^2 sampling.

    Minimizes E_q = <psi|H P_q|psi> / <psi|P_q|psi> with every expectation
    under the unprojected |psi|^2: with nhat(s) = (H P psi)(s)/psi(s),
    what(s) = (P psi)(s)/psi(s) (``ops/observables.sector_energy_ratio``)
    and N = E[nhat], D = E[what], the gradient is the covariance gradient of
    the effective local energy

        e_eff(s) = (nhat - E_q what - kappa (what - D)) / D,

    fed through the surrogate loss and, as raw residuals, into minSR and
    SPRING; the kappa term is the gradient of -kappa log D, which drives
    the sector weight D toward 1. The projector multiplies the connected
    working set by T translations, so the E_loc chunk is divided by T and
    rounded down to a divisor of M.

    Returns (e_q C, resid_var, grads, e_eff C[M] centered, weight |D|)."""
    from qmcnn_tpu_torch.ops.observables import sector_energy_ratio

    if eval_log_psi_fn is None:
        eval_log_psi_fn = log_psi_fn
    with annotate("e_loc"):
        num, den = sector_energy_ratio(
            eval_log_psi_fn, params, walkers.s, walkers.log_psi, ham,
            tuple(lattice_shape), tuple(momentum),
            chunk_size=sector_chunk_size(chunk_size, lattice_shape,
                                         walkers.s.shape[0]))
    n_mean = pmean_c(num.mean(), group)
    d_mean = pmean_c(den.mean(), group)
    e_q = n_mean / d_mean
    e_eff = (num - e_q * den - kappa * (den - d_mean)) / d_mean
    eff_mean = pmean_c(e_eff.mean(), group)  # 0 in expectation
    resid_var = pmean((e_eff - eff_mean).abs2().mean(), group)
    centered = e_eff - eff_mean
    grads = _surrogate_grads(log_psi_fn, params, walkers.s, centered, group)
    weight = torch.sqrt(d_mean.abs2())
    return e_q, resid_var, grads, centered, weight


def energy_and_grad(log_psi_fn, ham, params, walkers: WalkerState,
                    chunk_size: Optional[int] = None,
                    eval_log_psi_fn: Optional[Callable[..., C]] = None,
                    group=None, deflate: Optional[tuple] = None):
    """(e_mean C, e_var, grads dict, e_loc C[M], overlap) from the walkers.
    E_loc uses ``eval_log_psi_fn`` (None: the model, ``log_psi_fn``), the
    gradient ``log_psi_fn``; the means run over the walker ``group``.

    ``deflate``: optional (frozen_states, c): the exact deflation projector
    c sum_k |psi_k><psi_k| folded into E_loc
    (``ops/penalty.deflation_e_loc``), so the covariance gradient and the
    sample-space SR residuals optimize H + c P. The reported e_mean and
    e_var stay the physical <H>; the centering uses the deflated mean.
    ``overlap`` is the two-chain sum_k F_k (0 without deflation)."""
    if eval_log_psi_fn is None:
        eval_log_psi_fn = log_psi_fn
    with annotate("e_loc"):
        e_loc = local_energy(eval_log_psi_fn, params, ham, walkers.s,
                             walkers.log_psi, chunk_size=chunk_size)
        e_mean = pmean_c(e_loc.mean(), group)
        e_var = pmean((e_loc - e_mean).abs2().mean(), group)
        overlap = torch.zeros((), device=walkers.s.device)
        e_mean_a = e_mean
        if deflate is not None:
            from qmcnn_tpu_torch.ops.penalty import deflation_e_loc

            frozen, c = deflate
            with annotate("e_loc.deflation"):
                d_loc, overlap = deflation_e_loc(
                    eval_log_psi_fn, params, walkers.s, walkers.log_psi,
                    frozen, group=group, chunk_size=chunk_size)
            e_loc = e_loc + d_loc * c
            e_mean_a = pmean_c(e_loc.mean(), group)
    # L = mean Re[conj(dE) log psi]  ->  grad = Re[<O* dE>]
    grads = _surrogate_grads(log_psi_fn, params, walkers.s,
                             e_loc - e_mean_a, group)
    return e_mean, e_var, grads, e_loc, overlap


@dataclasses.dataclass(frozen=True, eq=False)
class VMC:
    """Binds model, Hamiltonian, sampler and optimizer into a train step.

    ``step(state, key, walker_ids) -> (state, metrics)``; with ``group``
    (a ``parallel.mesh.WalkerGroup``) the state holds this rank's walkers
    and the step runs over :mod:`qmcnn_tpu_torch.parallel.mesh`. With SR
    momentum > 0 the step solves SPRING (``SR.solve_spring``), carrying
    delta in ``TrainState.sr_aux``. ``walker_ids`` are the physical walkers'
    global ids (under tempering the state holds R rows per walker).
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
    #: excited states (ops/penalty.py): frozen states to stay orthogonal
    #: to, and the additive penalty's weight (choose it above the gap)
    penalty_states: tuple = ()
    penalty_beta: float = 0.0
    #: exact deflation H + c sum_k |psi_k><psi_k| folded into E_loc
    #: (c > E1 - E0); when > 0 it replaces the additive penalty
    deflate_c: float = 0.0
    #: momentum-sector targeting (sector_energy_and_grad); needs
    #: lattice_shape, and excludes deflation and the penalty
    sector_momentum: Optional[tuple] = None
    sector_kappa: float = 0.0
    lattice_shape: Optional[tuple] = None
    #: Polyak/EMA averaging of the params (0: off); see TrainState.ema
    ema_decay: float = 0.0

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
        ema = None
        if self.ema_decay > 0:
            ema = {k: v.clone() for k, v in params.items()}
        return TrainState(params=params, opt_state=self.optimizer.init(params),
                          walkers=walkers, step=0, sr_aux=sr_aux, ema=ema)

    def step(self, state: TrainState, key: int, walker_ids: torch.Tensor,
             noise=None):
        """One training step. ``noise`` overrides the sampler's draws.
        Its spans (``utils/profiling``) carry the step index: ``sampler``,
        ``e_loc``, ``gradient``, ``sr`` and ``update``."""
        params = state.params
        unit(state.step)
        with annotate("sampler"):
            walkers = self.sampler.reset_counters(state.walkers)
            with annotate("sampler.refresh", device=False):
                walkers = self.sampler.refresh(params, walkers)
            walkers = self.sampler.sample(params, walkers, key, walker_ids,
                                          n_sweeps=self.n_sweeps,
                                          noise=noise)
        # under tempering only the b = 1 rows are distributed as |psi|^2
        phys = self.sampler.physical(walkers)
        deflate = ((self.penalty_states, self.deflate_c)
                   if self.penalty_states and self.deflate_c > 0 else None)
        if self.sector_momentum is not None:
            # the effective local energy replaces E_loc downstream; the
            # overlap slot carries the sector weight |<P_q>|
            e_mean, e_var, grads, e_loc, overlap = sector_energy_and_grad(
                self.log_psi_fn, self.ham, params, phys, self.lattice_shape,
                self.sector_momentum, kappa=self.sector_kappa,
                chunk_size=self.chunk_size,
                eval_log_psi_fn=self.eval_log_psi_fn, group=self.group)
        else:
            e_mean, e_var, grads, e_loc, overlap = energy_and_grad(
                self.log_psi_fn, self.ham, params, phys,
                chunk_size=self.chunk_size,
                eval_log_psi_fn=self.eval_log_psi_fn, group=self.group,
                deflate=deflate)
        if self.penalty_states and deflate is None:
            from qmcnn_tpu_torch.ops.penalty import penalty_value_and_grad

            with annotate("gradient"):
                overlap, pen_grads = penalty_value_and_grad(
                    self.log_psi_fn, params, phys.s, self.penalty_states,
                    self.penalty_beta, group=self.group)
                grads = {k: grads[k] + pen_grads[k] for k in grads}
        sr_iters = 0
        sr_residual = torch.zeros((), device=walkers.s.device)
        sr_aux = state.sr_aux
        if self.sr is not None:
            with annotate("sr"):
                if sr_aux is not None:
                    grads, sr_iters, sr_residual, sr_aux = \
                        self.sr.solve_spring(
                            self.log_psi_fn, params, phys.s, grads,
                            state.step, sr_aux, e_loc=e_loc,
                            group=self.group)
                else:
                    grads, sr_iters, sr_residual = self.sr.solve(
                        self.log_psi_fn, params, phys.s, grads, state.step,
                        e_loc=e_loc, group=self.group)
        with annotate("update"):
            updates, opt_state = self.optimizer.update(grads,
                                                       state.opt_state)
            new_params = {k: params[k] + updates[k] for k in params}
            ema = state.ema
            if self.ema_decay > 0 and ema is not None:
                d = self.ema_decay
                ema = {k: d * ema[k] + (1.0 - d) * new_params[k]
                       for k in ema}
        metrics = StepMetrics(
            energy_re=e_mean.re, energy_im=e_mean.im, energy_var=e_var,
            accept_rate=pmean(self.sampler.acceptance_rate(walkers),
                              self.group),
            grad_norm=global_norm(grads), sr_iters=sr_iters,
            sr_residual=sr_residual, overlap=overlap)
        return TrainState(params=new_params, opt_state=opt_state,
                          walkers=walkers, step=state.step + 1,
                          sr_aux=sr_aux, ema=ema), metrics

    def thermalize(self, state: TrainState, key: int,
                   walker_ids: torch.Tensor, n_sweeps: int) -> TrainState:
        with annotate("sampler"):
            with annotate("sampler.refresh", device=False):
                walkers = self.sampler.refresh(state.params, state.walkers)
            walkers = self.sampler.sample(state.params, walkers, key,
                                          walker_ids, n_sweeps=n_sweeps)
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
