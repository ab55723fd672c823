"""Config -> framework objects (port of ``qmcnn_tpu/builder.py``, the CNN
training path on one device).

``build(cfg, device)`` wires lattice, ansatz, Hamiltonian, sampler,
optimizer and (optionally) SR into a :class:`qmcnn_tpu_torch.vmc.VMC`.

The optimizer is written out here with optax's formulas (``torch.optim``
differs: ``clip_grad_norm_`` adds 1e-6 to the norm, and its SGD momentum
and Adam bookkeeping differ): ``clip_by_global_norm`` chained before
``sgd`` (with or without momentum) or ``adam``, under a constant, cosine,
warmup_cosine or linear learning-rate schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from qmcnn_tpu_torch.configs import Config
from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.models.cnn import LogPsiCNN, log_psi_apply
from qmcnn_tpu_torch.ops.hamiltonians import TFIM, Heisenberg
from qmcnn_tpu_torch.sampler.metropolis import MetropolisSampler
from qmcnn_tpu_torch.sr import SR
from qmcnn_tpu_torch.vmc import VMC, global_norm


def build_lattice(cfg: Config) -> Lattice:
    return Lattice(tuple(cfg.lattice.shape), pbc=cfg.lattice.pbc,
                   geometry=cfg.lattice.geometry)


def build_hamiltonian(cfg: Config, lattice: Lattice):
    h = cfg.hamiltonian
    if h.kind == "tfim":
        return TFIM(lattice, j=h.j, h=h.h, hz=h.hz)
    if h.kind == "heisenberg":
        return Heisenberg(lattice, j=h.j, marshall=h.marshall, delta=h.delta)
    if h.kind == "j1j2":
        return Heisenberg(lattice, j=h.j, j2=h.j2, marshall=h.marshall,
                          delta=h.delta)
    if h.kind == "xyz":
        raise NotImplementedError("hamiltonian kind 'xyz' is not ported yet "
                                  "(ROADMAP.md)")
    raise ValueError(f"unknown hamiltonian kind {h.kind!r}")


_LATER_SLICE = ("translation_average", "point_group_average",
                "spin_flip_sector", "phase_bias", "jastrow", "jastrow_phase",
                "phase_net_channels", "lanczos_alpha")


def build_model(cfg: Config, lattice: Lattice) -> LogPsiCNN:
    """The plain CNN ansatz; other kinds and wrappers raise (later slices
    of the port, ROADMAP.md)."""
    m = cfg.model
    if m.kind != "cnn":
        raise NotImplementedError(f"model.kind={m.kind!r} is not ported yet "
                                  "(ROADMAP.md); only 'cnn'")
    for name in _LATER_SLICE:
        if getattr(m, name) not in (False, None, 0, ()):
            raise NotImplementedError(f"model.{name} is not ported yet "
                                      "(ROADMAP.md)")
    if m.momentum and any(m.momentum):
        raise ValueError("model.momentum requires translation_average: true")
    return LogPsiCNN(
        lattice_shape=tuple(lattice.shape),
        channels=tuple(m.channels),
        kernel_size=m.kernel_size,
        complex_params=m.complex_params,
        param_scale=m.param_scale,
        conv_impl=m.conv_impl,
        pbc=lattice.pbc,
        compute_dtype=m.compute_dtype,
        init_mode=m.init_mode,
        activation=m.activation,
        residual=m.residual,
        basis=lattice.basis,
    )


# ---------------------------------------------------------------------------
# optimizer (optax formulas)
# ---------------------------------------------------------------------------

Schedule = Callable[[int], float]


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("the cosine schedule requires positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def build_lr_schedule(cfg: Config) -> Schedule:
    o = cfg.optimizer
    decay = o.decay_steps or cfg.run.n_steps
    if o.schedule == "constant":
        return lambda count: o.lr
    if o.schedule == "cosine":
        return _cosine(o.lr, decay, o.lr_min_ratio)
    if o.schedule == "warmup_cosine":
        warm = max(o.warmup_steps, 1)
        end = o.lr * o.lr_min_ratio
        alpha = 0.0 if o.lr == 0.0 else end / o.lr
        first = _linear(0.0, o.lr, warm)
        second = _cosine(o.lr, decay - warm, alpha)
        return lambda count: (first(count) if count < warm
                              else second(count - warm))
    if o.schedule == "linear":
        return _linear(o.lr, o.lr * o.lr_min_ratio, decay)
    raise ValueError(f"unknown lr schedule {o.schedule!r}")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.chain([clip_by_global_norm], sgd(momentum) | adam) on flat
    param dicts. State: {'count', 'trace' | ('mu', 'nu')}; ``update``
    returns (updates, new state) and updates are added to the params."""

    kind: str
    lr: Schedule
    clip_norm: Optional[float] = None
    momentum: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> dict:
        state = {"count": 0}
        if self.kind == "sgd" and self.momentum is not None:
            state["trace"] = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.kind == "adam":
            state["mu"] = {k: torch.zeros_like(v) for k, v in params.items()}
            state["nu"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def update(self, grads, state: dict) -> Tuple[dict, dict]:
        g = dict(grads)
        if self.clip_norm:
            norm = global_norm(g)
            # optax: scale by max_norm / norm only when norm >= max_norm
            g = {k: torch.where(norm < self.clip_norm, v,
                                (v / norm) * self.clip_norm)
                 for k, v in g.items()}
        count = state["count"]
        new = {"count": count + 1}
        if self.kind == "sgd":
            if self.momentum is not None:
                g = {k: v + self.momentum * state["trace"][k]
                     for k, v in g.items()}
                new["trace"] = g
        elif self.kind == "adam":
            mu = {k: (1 - self.b1) * v + self.b1 * state["mu"][k]
                  for k, v in g.items()}
            nu = {k: (1 - self.b2) * (v * v) + self.b2 * state["nu"][k]
                  for k, v in g.items()}
            # bias corrections in float32, as optax computes them
            c1 = 1 - torch.tensor(self.b1) ** (count + 1)
            c2 = 1 - torch.tensor(self.b2) ** (count + 1)
            g = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
                 for k in g}
            new["mu"], new["nu"] = mu, nu
        else:
            raise ValueError(f"unknown optimizer kind {self.kind!r}")
        step = -self.lr(count)
        return {k: step * v for k, v in g.items()}, new


def build_optimizer(cfg: Config) -> Optimizer:
    o = cfg.optimizer
    if o.kind not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer kind {o.kind!r}")
    return Optimizer(kind=o.kind, lr=build_lr_schedule(cfg),
                     clip_norm=o.clip_norm or None,
                     momentum=o.momentum if o.kind == "sgd" else None)


# ---------------------------------------------------------------------------
# SR, moves, sampler backend
# ---------------------------------------------------------------------------

def model_log_psi_is_real(cfg: Config) -> bool:
    """True iff log psi(s) is real for all parameter values (SR may then
    skip the identically-zero J_im block)."""
    m = cfg.model
    if m.complex_params or m.spin_flip_sector == -1:
        return False
    if m.kind == "gcnn" and m.gcnn_character != "A1":
        return False
    if m.momentum and any(m.momentum):
        return False
    return not (m.phase_bias or m.jastrow_phase or m.phase_net_channels)


def build_sr(cfg: Config, lattice=None, ham=None,
             n_params: Optional[int] = None, device="cpu") -> Optional[SR]:
    s = cfg.sr
    if not s.enabled:
        return None
    solver = s.solver
    if solver == "auto":
        if n_params is None:
            raise ValueError("sr.solver='auto' needs the built model's "
                             "n_params to resolve (use builder.build)")
        from qmcnn_tpu_torch.sr import resolve_solver

        solver = resolve_solver(solver, cfg.sampler.n_walkers, n_params,
                                model_log_psi_is_real(cfg))
        cfg = dataclasses.replace(cfg, sr=dataclasses.replace(s, solver=solver))
    if s.momentum:
        raise NotImplementedError("sr.momentum (SPRING) is not ported yet "
                                  "(ROADMAP.md)")
    jacobian_chunk = s.jacobian_chunk
    if jacobian_chunk is None and lattice is not None and ham is not None:
        from qmcnn_tpu_torch.utils import memory

        jacobian_chunk = memory.auto_jacobian_chunk(
            cfg, lattice, ham, n_params, device=device)
    return SR(
        solver=solver,
        diag_shift0=s.diag_shift0,
        diag_shift_decay=s.diag_shift_decay,
        diag_shift_min=s.diag_shift_min,
        proportional_shift=s.proportional_shift,
        cg_tol=s.cg_tol,
        cg_maxiter=s.cg_maxiter,
        jacobian_chunk=jacobian_chunk,
        real_log_psi=model_log_psi_is_real(cfg),
    )


def resolve_move(cfg: Config) -> str:
    h = cfg.hamiltonian
    if cfg.sampler.move != "auto":
        return cfg.sampler.move
    if h.kind == "tfim":
        return "flip"
    return "exchange"


def kernel_eligible(cfg: Config) -> bool:
    """The CUDA sweep computes the plain real, f32, lncosh, skip-free,
    periodic CNN on a one-site-basis grid: the JAX eligibility rule plus
    the activation, residual and pbc checks it lacks."""
    m = cfg.model
    return (m.kind == "cnn"
            and m.lanczos_alpha is None
            and not m.complex_params
            and not m.translation_average
            and not m.point_group_average
            and not m.spin_flip_sector
            and not m.jastrow
            and not m.jastrow_phase
            and not m.phase_net_channels
            and not m.phase_bias
            and m.compute_dtype == "float32"
            and cfg.lattice.geometry not in ("honeycomb", "kagome")
            and m.activation == "lncosh"
            and not m.residual
            and cfg.lattice.pbc)


def resolve_sampler_backend(cfg: Config, device) -> str:
    """'torch' (plain sweep) or 'cuda' (the fused kernel).

    'auto' takes the kernel on a CUDA device for every eligible model and
    both flip and exchange moves; 'xla' is the plain torch sweep; 'pallas'
    is the kernel, or an error."""
    b = cfg.sampler.backend
    ok = kernel_eligible(cfg)
    on_cuda = torch.device(device).type == "cuda"
    if b == "auto":
        return "cuda" if ok and on_cuda else "torch"
    if b == "xla":
        return "torch"
    if b == "pallas":
        if not ok:
            raise ValueError(
                "sampler backend 'pallas' (the CUDA sweep kernel) supports "
                "only the plain real CNN: f32, lncosh, no residual skips, "
                "periodic boundaries, one-site basis, no symmetry "
                "projections, phase priors or jastrow")
        if not on_cuda:
            raise ValueError("sampler backend 'pallas' runs the CUDA sweep "
                             f"kernel; device is {device}")
        return "cuda"
    raise ValueError(f"unknown sampler backend {b!r}")


def build(cfg: Config, device="cuda") -> Tuple[VMC, dict, Lattice]:
    """Returns (vmc, initial params on ``device``, lattice)."""
    if cfg.sampler.kind not in ("auto", "metropolis"):
        raise NotImplementedError(f"sampler.kind={cfg.sampler.kind!r} is "
                                  "not ported yet (ROADMAP.md)")
    if cfg.sampler.tempering_betas is not None:
        raise NotImplementedError("sampler.tempering_betas is not ported "
                                  "yet (ROADMAP.md)")
    o = cfg.optimizer
    if (o.orthogonalize_to or o.deflate_c > 0 or o.ema_decay > 0
            or o.sector_momentum is not None):
        raise NotImplementedError(
            "excited-state, EMA and sector-optimization options are not "
            "ported yet (ROADMAP.md)")
    lattice = build_lattice(cfg)
    ham = build_hamiltonian(cfg, lattice)
    model = build_model(cfg, lattice)

    def log_psi_fn(params, s):
        return log_psi_apply(model, params, s)

    params = model.init(cfg.run.seed, device=device)
    move = resolve_move(cfg)
    sampler = MetropolisSampler(
        log_psi_fn,
        n_sites=lattice.n_sites,
        move=move,
        bonds=lattice.nn_bonds if move.startswith("exchange") else None,
        sweep_size=cfg.sampler.sweep_size,
        backend=resolve_sampler_backend(cfg, device),
        lattice_shape=tuple(lattice.shape),
    )
    n_params = sum(v.numel() for v in params.values())
    chunk_size = cfg.run.chunk_size
    if chunk_size is None:
        # null = auto: None (unchunked) when the E_loc batch fits
        from qmcnn_tpu_torch.utils import memory

        chunk_size = memory.auto_chunk_size(cfg, lattice, ham, n_params,
                                            device=device)
    vmc = VMC(
        log_psi_fn=log_psi_fn,
        ham=ham,
        sampler=sampler,
        optimizer=build_optimizer(cfg),
        n_sweeps=cfg.sampler.n_sweeps_per_step,
        sr=build_sr(cfg, lattice, ham, n_params, device=device),
        chunk_size=chunk_size,
    )
    return vmc, params, lattice
