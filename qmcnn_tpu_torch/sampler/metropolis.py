"""Metropolis-Hastings sampler over |psi(s)|^2 (port of
``qmcnn_tpu/sampler/metropolis.py``).

M walkers advance in lock-step on the leading axis; a sweep is
``sweep_size`` proposal steps, each evaluating log psi on the whole walker
batch. Proposals:
  * ``flip``     — single-spin flip;
  * ``exchange`` — swap the spins of a random lattice bond. Aligned bonds
    propose the identity (always accepted, state unchanged); anti-aligned
    swaps flip both spins. Conserves total S^z.

Two sweep engines make the same decisions from the same noise: the plain
torch loop (``backend='torch'``, any model) and the fused CUDA kernel
(``backend='cuda'``, the plain real CNN; ``kernels/metropolis_sweep.py``).

Random draws: JAX's threefry streams are not reproduced. Every draw is a
counter-based hash of (step key, proposal index t, global walker id), so a
walker's stream does not depend on how walkers are split over devices or
chunks — the contract of the reference sampler. Keys are 64-bit Python
ints derived with :func:`fold_in`. Callers may inject ``noise=(choices,
log_u)`` instead (the parity tests feed the JAX sampler's draws).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep
from qmcnn_tpu_torch.ops.cplx import C

LogPsiFn = Callable[..., C]  # (params, s [B, N]) -> C [B]

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32 without int64 overflow; works on
    Python ints and int64 tensors alike."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """32-bit avalanche hash (xorshift-multiply, 'lowbias32' constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix64(x: int) -> int:
    """splitmix64 finalizer on a Python int."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def prng_key(seed: int) -> int:
    """Root key of a run (the counterpart of ``jax.random.key(seed)``)."""
    return _mix64(int(seed) & _M64)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (``jax.random.fold_in``)."""
    return _mix64(key ^ _mix64(int(data) & _M64))


def sweep_noise(step_key: int, walker_ids: torch.Tensor, n_props: int,
                n_choices: int):
    """(choices [n_props, M] int32, log_u [n_props, M] f32) on the device
    of ``walker_ids``: at proposal t, walker w draws from a hash of
    (fold_in(step_key, t), w)."""
    dev = walker_ids.device
    keys = [fold_in(step_key, t) for t in range(n_props)]
    k_lo = torch.tensor([k & _M32 for k in keys], dtype=torch.int64,
                        device=dev)[:, None]
    k_hi = torch.tensor([k >> 32 for k in keys], dtype=torch.int64,
                        device=dev)[:, None]
    w = _mix32(walker_ids.to(torch.int64)[None, :] & _M32)
    h = _mix32(_mix32(k_lo ^ w) ^ k_hi)
    choices = (_mix32(h ^ 0x68E31DA4) % n_choices).to(torch.int32)
    u = ((_mix32(h ^ 0xB5297A4D) >> 8).to(torch.float64) + 0.5) * 2.0 ** -24
    return choices, torch.log(u).to(torch.float32)


class WalkerState(NamedTuple):
    """Per-walker MCMC state."""

    s: torch.Tensor         # [M, N] float32 in {-1, +1}
    log_psi: C              # [M] pair
    n_accept: torch.Tensor  # [M] int32, proposals accepted since last reset
    n_prop: torch.Tensor    # [M] int32, proposals attempted since last reset


def init_walkers(key: int, n_walkers: int, n_sites: int,
                 sector: Optional[str] = None, device="cpu") -> torch.Tensor:
    """Random initial configurations [n_walkers, n_sites] (drawn on the host
    from ``key``, so every device starts from the same walkers).

    sector=None: i.i.d. uniform spins. sector='sz0': the minimal-|S^z|
    sector (S^z = 0 for even N, +1/2 for odd N) that exchange moves keep.
    """
    gen = torch.Generator().manual_seed(key & 0x7FFFFFFFFFFFFFFF)
    if sector is None:
        s = 2.0 * torch.randint(0, 2, (n_walkers, n_sites),
                                generator=gen) - 1.0
    elif sector == "sz0":
        n_up = n_sites // 2 + (n_sites % 2)
        base = torch.cat([torch.ones(n_up), -torch.ones(n_sites - n_up)])
        perm = torch.argsort(torch.rand(n_walkers, n_sites, generator=gen),
                             dim=1)
        s = base[perm]
    else:
        raise ValueError(f"unknown sector {sector!r}")
    return s.to(device=device, dtype=torch.float32)


def _propose(s: torch.Tensor, choice: torch.Tensor, move: str,
             bonds: Optional[torch.Tensor]) -> torch.Tensor:
    """Proposal s' for every walker. choice: [M] site (flip) or bond."""
    idx = torch.arange(s.shape[1], device=s.device)[None, :]
    if move == "flip":
        return torch.where(idx == choice[:, None], -s, s)
    a = bonds[choice, 0][:, None]
    b = bonds[choice, 1][:, None]
    anti = s.gather(1, a) * s.gather(1, b) < 0
    return torch.where(((idx == a) | (idx == b)) & anti, -s, s)


@dataclasses.dataclass(frozen=True, eq=False)
class MetropolisSampler:
    """Walker-batched Metropolis sampler bound to a log-amplitude function.

    Args:
      log_psi_fn: ``(params, s [B, N]) -> C [B]`` log-amplitudes.
      n_sites: number of lattice sites.
      move: 'flip' | 'exchange' ('exchange_anti' is a later slice).
      bonds: [n_bonds, 2] site pairs (required for exchange moves).
      sweep_size: proposals per sweep; defaults to n_sites.
      backend: 'torch' (plain loop, every model) or 'cuda' (fused kernel;
        plain real CNNs, checked by the builder).
      lattice_shape: required for backend='cuda'.
    """

    log_psi_fn: LogPsiFn
    n_sites: int
    move: str = "flip"
    bonds: Optional[np.ndarray] = None
    sweep_size: Optional[int] = None
    backend: str = "torch"
    lattice_shape: Optional[tuple] = None

    def __post_init__(self):
        if self.move == "exchange_anti":
            raise NotImplementedError(
                "move 'exchange_anti' is not ported yet (ROADMAP.md)")
        if self.move not in ("flip", "exchange"):
            raise ValueError(f"unknown move {self.move!r}")
        if self.move == "exchange" and self.bonds is None:
            raise ValueError("exchange moves require bonds")
        if self.backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "cuda" and self.lattice_shape is None:
            raise ValueError("backend='cuda' requires lattice_shape")

    @property
    def _sweep_size(self) -> int:
        return self.sweep_size or self.n_sites

    @property
    def n_choices(self) -> int:
        return self.n_sites if self.move == "flip" else len(self.bonds)

    def init_state(self, params, key: int, n_walkers: int,
                   device="cpu") -> WalkerState:
        sector = "sz0" if self.move == "exchange" else None
        s = init_walkers(key, n_walkers, self.n_sites, sector=sector,
                         device=device)
        zeros = torch.zeros(n_walkers, dtype=torch.int32, device=device)
        return self.refresh(params, WalkerState(
            s=s, log_psi=C(torch.zeros(n_walkers, device=device),
                           torch.zeros(n_walkers, device=device)),
            n_accept=zeros, n_prop=zeros.clone()))

    def refresh(self, params, state: WalkerState) -> WalkerState:
        """Recompute stored log psi (call after every parameter update)."""
        return state._replace(log_psi=self.log_psi_fn(params, state.s))

    def _proposal_step(self, params, state: WalkerState,
                       choice: torch.Tensor, log_u: torch.Tensor,
                       bonds: Optional[torch.Tensor]) -> WalkerState:
        """One Metropolis proposal for every walker from one noise row."""
        s_new = _propose(state.s, choice.long(), self.move, bonds)
        log_psi_new = self.log_psi_fn(params, s_new)
        accept = log_u < 2.0 * (log_psi_new.re - state.log_psi.re)
        return WalkerState(
            s=torch.where(accept[:, None], s_new, state.s),
            log_psi=C(torch.where(accept, log_psi_new.re, state.log_psi.re),
                      torch.where(accept, log_psi_new.im, state.log_psi.im)),
            n_accept=state.n_accept + accept.to(torch.int32),
            n_prop=state.n_prop + 1,
        )

    def sample(self, params, state: WalkerState, step_key: int,
               walker_ids: torch.Tensor, n_sweeps: int,
               noise=None) -> WalkerState:
        """Advance every walker by ``n_sweeps`` sweeps.

        walker_ids: [M] *global* walker indices (the streams are keyed by
        them). ``noise=(choices, log_u)`` ([n_props, M] each) replaces the
        generated draws.
        """
        n_props = n_sweeps * self._sweep_size
        if noise is None:
            noise = sweep_noise(step_key, walker_ids.to(state.s.device),
                                n_props, self.n_choices)
        if self.backend == "cuda":
            s, lp, acc = metropolis_sweep(
                params, state.s, state.log_psi.re,
                lattice_shape=self.lattice_shape, n_props=n_props,
                move=self.move, bonds=self.bonds, noise=noise)
            return WalkerState(s=s, log_psi=C(lp, torch.zeros_like(lp)),
                               n_accept=state.n_accept + acc,
                               n_prop=state.n_prop + n_props)
        choices, log_u = (x.to(state.s.device) for x in noise)
        bonds = (None if self.bonds is None else torch.as_tensor(
            np.asarray(self.bonds, np.int64), device=state.s.device))
        for t in range(n_props):
            state = self._proposal_step(params, state, choices[t], log_u[t],
                                        bonds)
        return state

    @staticmethod
    def acceptance_rate(state: WalkerState) -> torch.Tensor:
        return state.n_accept.sum() / torch.clamp(state.n_prop.sum(), min=1)

    @staticmethod
    def reset_counters(state: WalkerState) -> WalkerState:
        return state._replace(n_accept=torch.zeros_like(state.n_accept),
                              n_prop=torch.zeros_like(state.n_prop))
