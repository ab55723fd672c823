"""Config -> framework objects (port of ``qmcnn_tpu/builder.py``: every
model kind of the JAX package — the CNN with its translation and
point-group averaging, the square, triangular and kagome GCNNs, the RBM,
the ViT and the autoregressive ARNN with its direct sampler — their phase
priors, Jastrow factors and PhaseNet wrappers, every Hamiltonian, and SR
with SPRING).

``build(cfg, device)`` wires lattice, ansatz, Hamiltonian, sampler,
optimizer and (optionally) SR into a :class:`qmcnn_tpu_torch.vmc.VMC`;
``build_sharded(cfg, group)`` builds the same over a walker group
(:mod:`qmcnn_tpu_torch.parallel.mesh`).

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
from qmcnn_tpu_torch.models.arnn import LogPsiARNN, conditional_fn
from qmcnn_tpu_torch.models.cnn import (LogPsiCNN, PointGroupAveraged,
                                        TranslationAveraged, log_psi_apply)
from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN, SpinFlipSymmetrized
from qmcnn_tpu_torch.models.jastrow import Jastrow, wrap_jastrow
from qmcnn_tpu_torch.models.kgcnn import LogPsiKagomeGCNN
from qmcnn_tpu_torch.models.phase import PhaseBias, phase_half_angles
from qmcnn_tpu_torch.models.phasenet import wrap_phase_net
from qmcnn_tpu_torch.models.rbm import LogPsiRBM
from qmcnn_tpu_torch.models.tgcnn import LogPsiTriGCNN
from qmcnn_tpu_torch.models.vit import LogPsiViT
from qmcnn_tpu_torch.ops.hamiltonians import TFIM, XYZ, Heisenberg
from qmcnn_tpu_torch.sampler.direct import DirectSampler
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
        return XYZ(lattice, jx=h.jx, jy=h.jy, jz=h.jz, hx=h.hx, hz=h.hz,
                   marshall=h.marshall)
    raise ValueError(f"unknown hamiltonian kind {h.kind!r}")


_PRIORS = ("phase_bias", "jastrow", "jastrow_phase", "phase_net_channels")


def _set(value) -> bool:
    return value not in (False, None, 0, ())


def build_model(cfg: Config, lattice: Lattice):
    """Every model kind of the JAX package with the JAX guards, wrapping
    order and parameter names: the CNN (optionally translation- and
    point-group-averaged), the GCNN (C4v on the square lattice, D6 on the
    triangular and kagome ones), the RBM and the ViT, each with its phase
    priors, Jastrow factor and PhaseNet and optionally spin-flip projected,
    and the ARNN with its phase prior baked in (a pure-phase Jastrow factor
    may wrap it). ``model.lanczos_alpha`` wraps the composed model in
    :func:`build` (``ops/lanczos.py``)."""
    m = cfg.model
    if m.translation_average and not lattice.pbc:
        raise ValueError("translation averaging requires periodic boundaries")
    if lattice.basis > 1:
        # honeycomb (2-site basis): only cell translations are symmetries
        for flag, name in ((m.translation_average, "translation_average"),
                           (m.point_group_average, "point_group_average")):
            if flag:
                raise ValueError(
                    f"model.{name} rolls the flat site grid — not a "
                    f"symmetry of geometry={lattice.geometry!r}; the CNN's "
                    f"spatial-sum readout already gives exact cell-"
                    f"translation invariance")
        if m.kind == "rbm" and m.rbm_tie_translations:
            raise ValueError("rbm_tie_translations ties per-site shifts — "
                             f"not a symmetry of {lattice.geometry!r}; use "
                             "rbm_tie_translations: false")
        if m.kind == "arnn" and m.arnn_conv_kernel:
            raise ValueError("the PixelCNN ARNN trunk rasterizes a 1-site-"
                             f"basis grid; {lattice.geometry!r} needs the "
                             "MADE trunk (arnn_conv_kernel: 0)")
    if m.momentum and any(m.momentum):
        if m.kind != "cnn":
            raise ValueError(
                f"model.momentum is only supported by the cnn ansatz via "
                f"translation averaging (got kind={m.kind!r})")
        if not m.translation_average:
            raise ValueError("model.momentum requires translation_average: "
                             "true (the sector is defined by the projection)")
    if m.kind == "rbm":
        if m.rbm_tie_translations and not lattice.pbc:
            raise ValueError("tied-RBM weights require periodic boundaries")
        return _maybe_spin_flip(_maybe_priors(LogPsiRBM(
            lattice_shape=tuple(lattice.shape), alpha=m.rbm_alpha,
            complex_params=m.complex_params,
            tie_translations=m.rbm_tie_translations,
            param_scale=m.param_scale), m, lattice), m)
    if m.kind == "arnn":
        return _arnn(cfg, lattice)
    if m.kind == "gcnn":
        return _maybe_spin_flip(_maybe_priors(_gcnn(m, lattice), m, lattice),
                                m)
    if m.kind == "vit":
        if not lattice.pbc:
            raise ValueError("vit projects translations by rolling the "
                             "grid — periodic boundaries required")
        if lattice.geometry != "hypercubic" or lattice.basis > 1:
            raise ValueError("vit patchifies the hypercubic site grid; "
                             f"geometry={lattice.geometry!r} is not "
                             "supported")
        if m.translation_average:
            raise ValueError("vit is already exactly translation invariant "
                             "(relpos attention + sub-patch projection); "
                             "drop translation_average")
        inner = _maybe_priors(LogPsiViT(
            lattice_shape=tuple(lattice.shape), channels=tuple(m.channels),
            patch=m.vit_patch, n_heads=m.vit_heads,
            mlp_ratio=m.vit_mlp_ratio, factored=m.vit_factored,
            complex_params=m.complex_params, param_scale=m.param_scale,
            compute_dtype=m.compute_dtype), m, lattice)
        if m.point_group_average:
            if len(lattice.shape) != 2:
                raise ValueError("point_group_average needs a 2D lattice")
            inner = PointGroupAveraged(inner, tuple(lattice.shape))
        return _maybe_spin_flip(inner, m)
    if m.kind != "cnn":
        raise ValueError(f"unknown model kind {m.kind!r}")
    inner = _maybe_priors(_cnn(m, lattice), m, lattice)
    if m.translation_average:
        inner = TranslationAveraged(inner, tuple(lattice.shape),
                                    shift_stride=m.shift_stride,
                                    momentum=tuple(m.momentum or ()))
    if m.point_group_average:
        if len(lattice.shape) != 2 or not lattice.pbc:
            raise ValueError("point_group_average needs a periodic 2D "
                             "lattice")
        if lattice.geometry != "hypercubic":
            raise ValueError("point_group_average applies the square C4v "
                             "group — not a symmetry of "
                             f"geometry={lattice.geometry!r}")
        inner = PointGroupAveraged(inner, tuple(lattice.shape))
    return _maybe_spin_flip(inner, m)


def _gcnn(m, lattice: Lattice):
    if len(lattice.shape) != 2 or not lattice.pbc:
        raise ValueError("gcnn needs a periodic 2D lattice")
    if lattice.geometry not in ("hypercubic", "triangular", "kagome"):
        raise ValueError("gcnn is point-group equivariant for square "
                         "(C4v), triangular (D6) and kagome (D6 via "
                         "the depleted-triangular embedding) lattices "
                         f"only — not geometry={lattice.geometry!r}")
    if m.translation_average or m.point_group_average:
        raise ValueError("gcnn is already fully space-group symmetric; "
                         "drop translation/point_group averaging")
    kw = dict(channels=tuple(m.channels), complex_params=m.complex_params,
              param_scale=m.param_scale, character=m.gcnn_character,
              init_mode=m.init_mode, activation=m.activation,
              residual=m.residual, compute_dtype=m.compute_dtype)
    if lattice.geometry == "hypercubic":
        return LogPsiGCNN(lattice_shape=tuple(lattice.shape),
                          kernel_size=m.kernel_size, **kw)
    # kernel_size names the enclosing grid: 3 -> the radius-1 star of 7
    # taps, 5 -> the radius-2 star of 19 taps
    radius = max((m.kernel_size - 1) // 2, 1)
    if lattice.geometry == "kagome":
        return LogPsiKagomeGCNN(cell_shape=tuple(lattice.shape),
                                radius=radius, **kw)
    return LogPsiTriGCNN(lattice_shape=tuple(lattice.shape), radius=radius,
                         **kw)


def _arnn(cfg: Config, lattice: Lattice):
    """The ARNN with the JAX guards: no averaging, spin-flip projection,
    Jastrow amplitude or PhaseNet (each breaks exact sampling or the
    conditional contract); the phase prior is baked into its phase, and a
    pure-phase Jastrow factor may wrap it."""
    m = cfg.model
    for flag, name in ((m.translation_average, "translation_average"),
                       (m.point_group_average, "point_group_average"),
                       (m.spin_flip_sector, "spin_flip_sector")):
        if flag:
            raise ValueError(
                f"model.{name} is incompatible with the autoregressive "
                f"ansatz: symmetrized sums of normalized amplitudes are "
                f"no longer normalized, which breaks exact sampling")
    if m.jastrow:
        raise ValueError(
            "model.jastrow is incompatible with the autoregressive "
            "ansatz: a configuration-dependent amplitude factor breaks "
            "the exact-sampling normalization (jastrow_phase — a pure "
            "phase, |psi| untouched — composes fine)")
    if m.phase_net_channels:
        raise ValueError(
            "model.phase_net_channels is not wired for the "
            "autoregressive ansatz (it already has per-site phase "
            "heads; the CNN-trunk wrapper cannot forward the exact-"
            "sampling conditional contract)")
    sz_zero = resolve_arnn_sector(cfg)
    if sz_zero and lattice.n_sites % 2:
        raise ValueError("sz0 sector needs an even number of sites")
    if m.arnn_conv_kernel and len(lattice.shape) != 2:
        raise ValueError("arnn_conv_kernel (PixelCNN trunk) needs a 2D "
                         "lattice; chains use the MADE trunk (0)")
    half = phase_half_angles(m.phase_bias, lattice) if m.phase_bias else None
    arnn = LogPsiARNN(
        n_sites=lattice.n_sites, hidden=tuple(m.channels),
        complex_params=m.complex_params, sz_zero=sz_zero,
        param_scale=m.param_scale,
        # the ARNN's default activation stands in for the CNN's default
        activation=m.activation if m.activation != "lncosh" else "selu",
        conv_kernel=m.arnn_conv_kernel, lattice_shape=tuple(lattice.shape),
        phase_half_angles=half)
    if m.jastrow_phase:
        return wrap_jastrow(arnn, lattice, amplitude=False, phase=True)
    return arnn


def _maybe_priors(inner, m, lattice: Lattice):
    """The JAX wrapping order, all inside the spin-flip projection:
    PhaseNet innermost, then the Jastrow factor, then the phase prior
    outermost (each factor is isometry-invariant and Z2-even, so the
    order only fixes the parameter names)."""
    if m.phase_net_channels:
        inner = wrap_phase_net(inner, lattice, channels=m.phase_net_channels,
                               kernel_size=m.phase_net_kernel)
    if m.jastrow or m.jastrow_phase:
        inner = wrap_jastrow(inner, lattice, amplitude=m.jastrow,
                             phase=m.jastrow_phase)
    if not m.phase_bias:
        return inner
    return PhaseBias(inner, phase_half_angles(m.phase_bias, lattice))


def _maybe_spin_flip(inner, m):
    if not m.spin_flip_sector:
        return inner
    return SpinFlipSymmetrized(inner=inner, sector=m.spin_flip_sector)


def _cnn(m, lattice: Lattice) -> LogPsiCNN:
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
    if m.lanczos_alpha is not None:
        # arg(1 + alpha E_loc) puts a phase on phi even for a real model
        # (the JAX rule misses it and drops the score's imaginary block)
        return False
    if m.kind == "gcnn" and m.gcnn_character != "A1":
        return False
    if m.momentum and any(m.momentum):
        return False
    return not (m.phase_bias or m.jastrow_phase or m.phase_net_channels)


def build_sr(cfg: Config, lattice=None, ham=None,
             n_params: Optional[int] = None, device="cpu",
             world_size: int = 1) -> Optional[SR]:
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
    if s.momentum and solver != "minsr":
        raise ValueError("sr.momentum (SPRING) requires solver='minsr' "
                         f"(resolved solver: {solver!r})")
    jacobian_chunk = s.jacobian_chunk
    if jacobian_chunk is None and lattice is not None and ham is not None:
        from qmcnn_tpu_torch.utils import memory

        jacobian_chunk = memory.auto_jacobian_chunk(
            cfg, lattice, ham, n_params, device=device,
            world_size=world_size)
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
        minsr_assembly=s.minsr_assembly,
        momentum=s.momentum,
    )


def resolve_arnn_sector(cfg: Config) -> bool:
    """True iff the ARNN conditionals bake in the S^z = 0 sector."""
    sec = cfg.model.arnn_sector
    if sec == "auto":
        return cfg.hamiltonian.kind in ("heisenberg", "j1j2")
    if sec == "sz0":
        return True
    if sec == "none":
        return False
    raise ValueError(f"unknown model.arnn_sector {sec!r}")


def resolve_sampler_kind(cfg: Config) -> str:
    """'direct' (exact ancestral sampling, the ARNN only) or
    'metropolis'; 'auto' takes direct for the ARNN."""
    k = cfg.sampler.kind
    if k == "auto":
        return "direct" if cfg.model.kind == "arnn" else "metropolis"
    if k == "direct" and cfg.model.kind != "arnn":
        raise ValueError("sampler.kind='direct' requires the autoregressive "
                         "ansatz (model.kind='arnn'); other models are not "
                         "normalized and cannot be sampled ancestrally")
    if k not in ("metropolis", "direct"):
        raise ValueError(f"unknown sampler.kind {k!r}")
    return k


def resolve_move(cfg: Config) -> str:
    """The Metropolis move: 'auto' flips spins for TFIM and for an XYZ
    model that breaks S^z, and exchanges them otherwise; exchange moves on
    such an XYZ model raise (they would freeze the chain in one sector)."""
    h = cfg.hamiltonian
    xyz_conserves_sz = h.jx == h.jy and h.hx == 0.0
    if cfg.sampler.move != "auto":
        if (h.kind == "xyz" and not xyz_conserves_sz
                and cfg.sampler.move.startswith("exchange")):
            raise ValueError(
                "xyz with jx != jy or hx != 0 does not conserve S^z; "
                "exchange moves would freeze the sampler in one sector — "
                "use sampler.move: flip (or auto)")
        return cfg.sampler.move
    if h.kind == "tfim":
        return "flip"
    if h.kind == "xyz":
        return "exchange" if xyz_conserves_sz else "flip"
    return "exchange"


def cnn_forward_eligible(cfg: Config) -> bool:
    """The CUDA sweep kernel's forward computes the plain real, f32,
    lncosh, skip-free, periodic CNN on a one-site-basis grid, with one
    walker's activations and the weights within a block's shared memory:
    the JAX eligibility rule (without its move condition) plus the
    activation, residual, pbc and shared-memory checks it lacks. A bf16 or
    complex CNN samples with the torch sweep and evaluates with the model,
    as in JAX."""
    m = cfg.model
    if not (m.kind == "cnn"
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
            and cfg.lattice.pbc):
        return False
    from qmcnn_tpu_torch.kernels.metropolis_sweep import smem_bytes
    from qmcnn_tpu_torch.kernels.nvcc import MAX_SMEM_BYTES

    shape = tuple(cfg.lattice.shape)
    ksz = m.kernel_size
    if isinstance(ksz, int):
        ksz = (ksz,) * len(shape)
    taps = math.prod(min(k, n) for k, n in zip(ksz, shape))
    return smem_bytes(math.prod(shape), taps,
                      [1] + list(m.channels)) <= MAX_SMEM_BYTES


def kernel_eligible(cfg: Config) -> bool:
    """The CUDA sweep runs an eligible CNN forward
    (:func:`cnn_forward_eligible`) with flip or exchange moves."""
    return (resolve_move(cfg) in ("flip", "exchange")
            and cnn_forward_eligible(cfg))


def gcnn_kernel_eligible(cfg: Config) -> bool:
    """The fused GCNN forward computes the bare square-lattice GCNN
    (optionally spin-flip projected) in float32 or bfloat16 (its two
    routes) with equal channel widths, one configuration's activations per
    block in shared memory at the route's element size: no priors, Jastrow
    factors or (1 + alpha H) wrapping, and no lattice x width too large for
    a block (16x16 at W = 8C = 80 is, in float32)."""
    m, lat = cfg.model, cfg.lattice
    if not (m.kind == "gcnn"
            and lat.geometry == "hypercubic"
            and len(lat.shape) == 2
            and lat.pbc
            and len(set(m.channels)) == 1
            and m.compute_dtype in ("float32", "bfloat16")
            and m.lanczos_alpha is None
            and not any(_set(getattr(m, name)) for name in _PRIORS)):
        return False
    from qmcnn_tpu_torch.kernels.gcnn_forward import G, smem_bytes
    from qmcnn_tpu_torch.kernels.nvcc import MAX_SMEM_BYTES
    from qmcnn_tpu_torch.models.gcnn import effective_kernel

    shape = tuple(lat.shape)
    k = effective_kernel(m.kernel_size, shape)
    return smem_bytes(shape[0] * shape[1], G * m.channels[0], k * k,
                      m.complex_params, 1, m.compute_dtype) <= MAX_SMEM_BYTES


def uses_fused_gcnn_forward(cfg: Config, device) -> bool:
    """True when the sampler and E_loc evaluate through the fused GCNN
    forward: backend 'auto' on a CUDA device for an eligible GCNN. 'xla'
    keeps the plain model; 'pallas' raises for a GCNN
    (:func:`resolve_sampler_backend`)."""
    return (cfg.sampler.backend == "auto"
            and torch.device(device).type == "cuda"
            and gcnn_kernel_eligible(cfg))


def uses_fused_cnn_forward(cfg: Config, device) -> bool:
    """True when the sampler and E_loc evaluate the CNN through the sweep
    kernel's recompute forward: backend 'auto' on a CUDA device for an
    eligible CNN, whatever the move. 'xla' keeps the plain model."""
    return (cfg.sampler.backend == "auto"
            and torch.device(device).type == "cuda"
            and cnn_forward_eligible(cfg))


def resolve_sampler_backend(cfg: Config, device) -> str:
    """The sweep engine: 'torch' (the plain proposal loop over the
    evaluation forward) or 'cuda' (the fused sweep kernel).

    'auto' takes the kernel on a CUDA device for the plain real CNN with
    flip or exchange moves. 'xla' is the plain loop; 'pallas' is the
    kernel, or an error (as in the JAX package, also for a GCNN)."""
    b = cfg.sampler.backend
    ok = kernel_eligible(cfg)
    on_cuda = torch.device(device).type == "cuda"
    if b == "auto":
        return "cuda" if on_cuda and ok else "torch"
    if b == "xla":
        return "torch"
    if b == "pallas":
        if not ok:
            raise ValueError(
                "sampler backend 'pallas' (the CUDA sweep kernel) supports "
                "only the plain real CNN: f32, lncosh, no residual skips, "
                "periodic boundaries, one-site basis, flip or exchange "
                "moves, no symmetry projections, phase priors or jastrow, "
                "and one walker within a block's shared memory")
        if not on_cuda:
            raise ValueError("sampler backend 'pallas' runs the CUDA sweep "
                             f"kernel; device is {device}")
        return "cuda"
    raise ValueError(f"unknown sampler backend {b!r}")


def build(cfg: Config, device="cuda", group=None
          ) -> Tuple[VMC, dict, Lattice]:
    """Returns (vmc, initial params on ``device``, lattice). With a walker
    ``group`` the VMC's means all-reduce over its ranks, and the memory
    estimates count this rank's walkers.

    Options beyond the ground state, with the JAX guards: parallel
    tempering (``sampler.tempering_betas``; the torch sweep, its evaluation
    forward still the fused one), the (1 + alpha H) ansatz
    (``model.lanczos_alpha``), frozen states for the penalty or the
    deflation (``optimizer.orthogonalize_to``, each drawn once here), the
    parameter EMA and momentum-sector optimization."""
    world = 1 if group is None else group.world_size
    direct = resolve_sampler_kind(cfg) == "direct"
    betas = cfg.sampler.tempering_betas
    if direct and betas is not None:
        raise ValueError("tempering_betas is a Metropolis mixing aid — "
                         "exact ancestral sampling draws i.i.d. "
                         "samples and needs no tempering")
    o = cfg.optimizer
    if o.sector_momentum is not None and (o.orthogonalize_to
                                          or o.deflate_c > 0):
        raise ValueError(
            "optimizer.sector_momentum is incompatible with "
            "orthogonalize_to/deflate_c: both redefine the effective "
            "local energy the solvers see")
    lattice = build_lattice(cfg)
    ham = build_hamiltonian(cfg, lattice)
    model = build_model(cfg, lattice)

    def log_psi_fn(params, s):
        return log_psi_apply(model, params, s)

    # a functional_call of the leaves it is given: graph-safe where the
    # model declares itself so (utils/cuda_graph.GraphSafe)
    log_psi_fn.graph_safe = getattr(model, "graph_safe", None)
    params = model.init(cfg.run.seed, device=device)
    if cfg.model.lanczos_alpha is not None:
        # phi = (1 + alpha H) psi: wrapped after the model is composed
        # (priors and projections inside), before the sampler (the walk
        # targets |phi|^2); alpha is a leaf of its own
        from qmcnn_tpu_torch.ops.lanczos import (ALPHA_KEY,
                                                 lanczos_init_alpha,
                                                 lanczos_wrap)

        if direct:
            raise ValueError(
                "model.lanczos_alpha needs Metropolis sampling: the ARNN "
                "conditionals sample |psi|^2, not |(1+aH)psi|^2")
        if cfg.sampler.backend == "pallas":
            raise ValueError(
                "model.lanczos_alpha runs on the xla sampler backend (the "
                "fused Pallas sweep computes the bare CNN forward only)")
        log_psi_fn = lanczos_wrap(log_psi_fn, ham)
        params = dict(params)
        params[ALPHA_KEY] = lanczos_init_alpha(cfg.model.lanczos_alpha,
                                               device)
    eval_log_psi_fn = evaluation_forward(cfg, lattice, device, log_psi_fn)
    if direct:
        # a pure-phase Jastrow factor leaves |psi|^2 alone: the sampler
        # draws from the inner ARNN's conditionals (its params under
        # inner/), while log psi stays the wrapped model's
        if isinstance(model, Jastrow):
            cond_fn = conditional_fn(model.inner, prefix="params/inner/")
        else:
            cond_fn = conditional_fn(model)
        sampler = DirectSampler(log_psi_fn, cond_fn,
                                n_sites=lattice.n_sites,
                                sz_zero=resolve_arnn_sector(cfg))
    else:
        move = resolve_move(cfg)
        if (betas is not None and cfg.sampler.backend == "pallas"
                and kernel_eligible(cfg)):
            raise ValueError("tempering_betas runs on the xla backend")
        backend = resolve_sampler_backend(cfg, device)
        if betas is not None:
            backend = "torch"  # an auto-selected sweep kernel defers
        sampler = MetropolisSampler(
            eval_log_psi_fn,
            n_sites=lattice.n_sites,
            move=move,
            bonds=lattice.nn_bonds if move.startswith("exchange") else None,
            sweep_size=cfg.sampler.sweep_size,
            backend=backend,
            lattice_shape=tuple(lattice.shape),
            betas=tuple(betas) if betas is not None else None,
        )
    n_params = sum(v.numel() for v in params.values())
    from qmcnn_tpu_torch.utils import memory

    chunk_size = memory.run_chunk_size(cfg, lattice, ham, n_params,
                                       device=device, world_size=world)
    sr = build_sr(cfg, lattice, ham, n_params, device=device,
                  world_size=world)
    penalty_states = tuple(
        frozen_state(cfg, lattice, sampler, params, path, i, device,
                     log_psi_fn)
        for i, path in enumerate(o.orthogonalize_to or ()))
    if (penalty_states and o.deflate_c <= 0 and sr is not None
            and sr.solver == "minsr"):
        import warnings

        # the sample-space minSR metric projects the update onto the span
        # of the current state's scores, which suppresses the penalty's
        # move-away direction (the JAX package's measured failure mode)
        warnings.warn(
            "optimizer.orthogonalize_to with sr.solver='minsr' is a "
            "documented silent-collapse mode: the sample-space natural-"
            "gradient metric suppresses the orthogonality-penalty "
            "direction and the run converges back onto the reference "
            "state. Use sr.solver='dense' or 'pcg' (or sr.enabled=false) "
            "for penalty/excited-state runs, or set optimizer.deflate_c "
            "(exact H + c|psi0><psi0| deflation folded into e_loc, "
            "which the sample-space solvers see natively).", stacklevel=2)
    vmc = VMC(
        log_psi_fn=log_psi_fn,
        ham=ham,
        sampler=sampler,
        optimizer=build_optimizer(cfg),
        n_sweeps=cfg.sampler.n_sweeps_per_step,
        sr=sr,
        chunk_size=chunk_size,
        eval_log_psi_fn=eval_log_psi_fn,
        group=group,
        penalty_states=penalty_states,
        penalty_beta=o.orth_beta,
        deflate_c=o.deflate_c,
        sector_momentum=(tuple(o.sector_momentum)
                         if o.sector_momentum is not None else None),
        sector_kappa=o.sector_kappa,
        lattice_shape=tuple(lattice.shape),
        ema_decay=o.ema_decay,
    )
    # the memory preflight: surface dangerous-looking configs before any
    # step runs (the JAX builder's warning, SR only)
    if cfg.sr.enabled:
        est = memory.peak_estimate(
            cfg, lattice, ham, n_params, solver=sr.solver,
            chunk_size=chunk_size, jacobian_chunk=sr.jacobian_chunk,
            device=device, world_size=world)
        msg = memory.preflight_message(est)
        if msg:
            print(f"WARNING: {msg}", flush=True)
    return vmc, params, lattice


def evaluation_forward(cfg: Config, lattice: Lattice, device, log_psi_fn):
    """The evaluation-only forward of the sampler and E_loc: a fresh fused
    GCNN forward (K2) or sweep-kernel recompute forward (K1) where the
    config is eligible on ``device``, else ``log_psi_fn`` (the model). Each
    call makes a new instance, so each parameter set (the live params, a
    frozen state's) keeps its own weight cache."""
    if uses_fused_gcnn_forward(cfg, device):
        return fused_gcnn_log_psi(cfg, lattice)
    if uses_fused_cnn_forward(cfg, device):
        from qmcnn_tpu_torch.kernels.metropolis_sweep import FusedCNNLogPsi

        return FusedCNNLogPsi(lattice_shape=tuple(lattice.shape))
    return log_psi_fn


def frozen_state(cfg: Config, lattice: Lattice, sampler, params, path: str,
                 index: int, device, log_psi_fn):
    """The ``index``-th ``optimizer.orthogonalize_to`` state: its params
    from ``path`` (a ``.npz`` snapshot or a port checkpoint, every leaf
    matching this run's model), its own evaluation forward, and a batch of
    ``n_walkers`` drawn once from |psi_k|^2 with max(n_therm_sweeps, 20)
    sweeps from prng_key(seed + 7919 (index + 1)). Under tempering the
    batch is the b = 1 chain (the physical ids drive the draw); every rank
    of a walker group draws the same whole batch."""
    from qmcnn_tpu_torch.ops.penalty import make_frozen_state
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                transfer_params)

    p_k, _, n_fresh = transfer_params(params, load_checkpoint_params(path))
    if n_fresh:
        raise ValueError(
            f"orthogonalize_to checkpoint {path!r} does not match this "
            f"run's model ({n_fresh} leaves missing/mismatched) — "
            f"frozen states must use the same model config")
    fwd = evaluation_forward(cfg, lattice, device, log_psi_fn)
    k_sampler = dataclasses.replace(sampler, log_psi_fn=fwd)
    m = cfg.sampler.n_walkers
    key = prng_key(cfg.run.seed + 7919 * (index + 1))
    st = k_sampler.init_state(p_k, key, m, device=device)
    st = k_sampler.sample(p_k, st, fold_in(key, 1),
                          torch.arange(m, device=device),
                          n_sweeps=max(cfg.sampler.n_therm_sweeps, 20))
    return make_frozen_state(fwd, p_k, k_sampler.physical(st).s)


def build_sharded(cfg: Config, group):
    """(ShardedVMC over ``group``, initial params on its device, lattice):
    this rank's part of a run over the walker group (JAX ``build_sharded``;
    ``run.n_devices`` is checked against the world size by
    ``parallel.mesh.walker_group``)."""
    from qmcnn_tpu_torch.parallel.mesh import make_sharded_vmc

    vmc, params, lattice = build(cfg, device=group.device, group=group)
    return make_sharded_vmc(vmc, group), params, lattice


def fused_gcnn_log_psi(cfg: Config, lattice: Lattice):
    """(params, s) -> C: the configured GCNN's log psi through the fused
    forward (``kernels/gcnn_forward.py``); evaluation only."""
    from qmcnn_tpu_torch.kernels.gcnn_forward import FusedLogPsi

    m = cfg.model
    return FusedLogPsi(
        lattice_shape=tuple(lattice.shape), channels=tuple(m.channels),
        kernel_size=m.kernel_size, complex_params=m.complex_params,
        character=m.gcnn_character, activation=m.activation,
        residual=m.residual, spin_flip_sector=m.spin_flip_sector,
        compute_dtype=m.compute_dtype)
