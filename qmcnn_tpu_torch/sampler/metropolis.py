"""Metropolis-Hastings sampler over |psi(s)|^2 (port of
``qmcnn_tpu/sampler/metropolis.py``).

M walkers advance in lock-step on the leading axis; a sweep is
``sweep_size`` proposal steps, each evaluating log psi on the whole walker
batch. Proposals:
  * ``flip``     — single-spin flip;
  * ``exchange`` — swap the spins of a random lattice bond. Aligned bonds
    propose the identity (always accepted, state unchanged); anti-aligned
    swaps flip both spins. Conserves total S^z.
  * ``exchange_anti`` — swap a bond drawn uniformly from the anti-aligned
    bonds only, with the Hastings correction n_anti(s)/n_anti(s') in the
    acceptance rule; every proposal changes the state. Conserves S^z.

Two sweep engines make the same decisions from the same noise: the plain
torch loop (``backend='torch'``, any model and move; its log psi may be the
fused GCNN forward, ``kernels/gcnn_forward.py``, or the sweep kernel's
recompute forward, ``FusedCNNLogPsi``) and the fused CUDA sweep
kernel (``backend='cuda'``, the plain real CNN with flip or exchange moves;
``kernels/metropolis_sweep.py``). On a card, the torch loop of a forward
declared graph-safe (``utils/cuda_graph.GraphSafe``) is captured once per
shape as a CUDA graph of one sweep (:class:`SweepGraph`) and replayed once
a sweep: the same ``_proposal_step`` calls, so the same kernels in the same
order, with no host launches between them. Tempering, the ``utils/debug``
checked mode and undeclared forwards keep the eager loop
(:meth:`MetropolisSampler.graphs_sweep`).

Parallel tempering (``betas``): R replicas per walker, row ``i*R + r``
sampling |psi|^{2 b_r}, with one replica-exchange pass of adjacent pairs
after every sweep; only the b = 1 rows (``physical``) feed the estimators.

Random draws: JAX's threefry streams are not reproduced. Every draw is a
counter-based hash of (step key, proposal index t, global walker id), so a
walker's stream does not depend on how walkers are split over devices or
chunks — the contract of the reference sampler. Keys are 64-bit Python
ints derived with :func:`fold_in`. Callers may inject ``noise=(choices,
log_u)`` instead (``(u_move, log_u)`` for exchange_anti; with tempering
``(choices, log_u, swap_log_u)``; the parity tests feed the JAX sampler's
draws).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.utils import cuda_graph, debug
from qmcnn_tpu_torch.utils.profiling import annotate, count

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


def _noise_hash(step_key: int, walker_ids: torch.Tensor, n_props: int):
    """[n_props, M] int64 hash of (fold_in(step_key, t), walker id)."""
    dev = walker_ids.device
    keys = [fold_in(step_key, t) for t in range(n_props)]
    k_lo = torch.tensor([k & _M32 for k in keys], dtype=torch.int64,
                        device=dev)[:, None]
    k_hi = torch.tensor([k >> 32 for k in keys], dtype=torch.int64,
                        device=dev)[:, None]
    w = _mix32(walker_ids.to(torch.int64)[None, :] & _M32)
    return _mix32(_mix32(k_lo ^ w) ^ k_hi)


def _uniform(h: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform in (0, 1), float64, from 24 bits of a salted hash."""
    return ((_mix32(h ^ salt) >> 8).to(torch.float64) + 0.5) * 2.0 ** -24


def swap_noise(swap_key: int, walker_ids: torch.Tensor, n_sweeps: int,
               n_pairs: int) -> torch.Tensor:
    """log-uniforms [n_sweeps, n_pairs, M] f32 of the replica-exchange
    passes: sweep u, pair j, walker w from a hash of
    (fold_in(fold_in(swap_key, u), j), w)."""
    return torch.stack([
        torch.log(_uniform(_noise_hash(fold_in(swap_key, u), walker_ids,
                                       n_pairs), 0x1B873593))
        for u in range(n_sweeps)]).to(torch.float32)


def sweep_noise(step_key: int, walker_ids: torch.Tensor, n_props: int,
                n_choices: Optional[int]):
    """Noise for ``n_props`` proposals on the device of ``walker_ids``: at
    proposal t, walker w draws from a hash of (fold_in(step_key, t), w).

    Returns (choices [n_props, M] int32, log_u [n_props, M] f32) for flip
    and exchange moves; with ``n_choices=None`` (exchange_anti) the first
    entry is u_move [n_props, M] f32, a uniform in (0, 1) from the same
    hash."""
    h = _noise_hash(step_key, walker_ids, n_props)
    if n_choices is None:
        first = _uniform(h, 0x68E31DA4).to(torch.float32)
    else:
        first = (_mix32(h ^ 0x68E31DA4) % n_choices).to(torch.int32)
    return first, torch.log(_uniform(h, 0xB5297A4D)).to(torch.float32)


class WalkerState(NamedTuple):
    """Per-walker MCMC state."""

    s: torch.Tensor         # [M, N] float32 in {-1, +1}
    log_psi: C              # [M] pair
    n_accept: torch.Tensor  # [M] int32, proposals accepted since last reset
    n_prop: torch.Tensor    # [M] int32, proposals attempted since last reset


def init_walkers(key: int, n_walkers: int, n_sites: int,
                 sector: Optional[str] = None, device="cpu") -> torch.Tensor:
    """Random initial configurations [n_walkers, n_sites] (drawn on the host
    from ``key``, so every device and every rank draws the same walkers).

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
    choice = choice.long()
    if move == "flip":
        return torch.where(idx == choice[:, None], -s, s)
    a = bonds[choice, 0][:, None]
    b = bonds[choice, 1][:, None]
    anti = s.gather(1, a) * s.gather(1, b) < 0
    return torch.where(((idx == a) | (idx == b)) & anti, -s, s)


def _anti_mask(s: torch.Tensor, bonds: torch.Tensor) -> torch.Tensor:
    """[M, n_bonds] bool: the bond is anti-aligned in the walker."""
    return s[:, bonds[:, 0]] * s[:, bonds[:, 1]] < 0


def _propose_exchange_anti(s: torch.Tensor, u: torch.Tensor,
                           bonds: torch.Tensor):
    """Swap one bond drawn uniformly (u [M] in [0, 1)) from the
    anti-aligned bonds. Returns (s' [M, N], log_correction [M]) with the
    Hastings term log[n_anti(s) / n_anti(s')]; when n_anti = 0 the proposal
    is the identity and the term 0."""
    anti = _anti_mask(s, bonds)                               # [M, B]
    n_anti = anti.sum(dim=1)                                  # [M]
    k_idx = torch.floor(u * torch.clamp(n_anti, min=1).to(torch.float32)
                        ).to(torch.int64)
    k_idx = torch.minimum(k_idx, torch.clamp(n_anti - 1, min=0))
    ranks = torch.cumsum(anti.to(torch.int64), dim=1)         # 1-based
    sel = anti & (ranks == (k_idx + 1)[:, None])
    bond = torch.argmax(sel.to(torch.int8), dim=1)
    idx = torch.arange(s.shape[1], device=s.device)[None, :]
    on_bond = ((idx == bonds[bond, 0][:, None])
               | (idx == bonds[bond, 1][:, None]))
    valid = (n_anti > 0)[:, None]
    s_prop = torch.where(on_bond & valid, -s, s)
    n_anti_new = _anti_mask(s_prop, bonds).sum(dim=1)
    log_corr = (torch.log(torch.clamp(n_anti, min=1).to(torch.float32))
                - torch.log(torch.clamp(n_anti_new, min=1).to(torch.float32)))
    return s_prop, torch.where(n_anti > 0, log_corr, 0.0)


def _inputs(fwd, params):
    """What a captured call of ``fwd`` reads: ``fwd.graph_inputs(params)``
    where the forward has it, else the params in the order of their keys."""
    derive = getattr(fwd, "graph_inputs", None)
    if derive is not None:
        return derive(params)
    return {k: params[k] for k in sorted(params)}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class SweepGraph:
    """One sweep of the torch loop on a card as a CUDA graph: static buffers
    for the walkers, both parts of the stored log psi, the two counters, one
    sweep's noise rows, the bond table and the forward's inputs (the params,
    or what its ``graph_inputs`` makes of them), and ``sweep_size`` calls of
    ``step`` (the sampler's ``_proposal_step``) over them, the last writing
    its state back into the static walkers, so sweeps replay back to back.
    ``run`` copies a call's inputs in, runs its sweeps and returns clones,
    so the caller's state never aliases the graph. It takes ``step`` at
    each call and holds no reference to the sampler, so a graph is freed
    with its sampler and never by the cycle collector, which may run in the
    middle of another capture.

    The first sweep runs eagerly on the capture stream, which warms it up,
    and is then captured (``utils/cuda_graph.capture``); every later sweep
    is a replay. Replays run no Python: they open the span the forward's
    ``graph_safe`` declaration names and add the tallies it names, as the
    captured calls counted them. Counts ``sampler.graph.captures`` and
    ``sampler.graph.replays`` (sweeps)."""

    def __init__(self, fwd, params, state: WalkerState,
                 choices: torch.Tensor, log_u: torch.Tensor,
                 bonds: Optional[torch.Tensor]):
        self.fwd, self.bonds = fwd, bonds
        self.inputs = tree_map(_clone, _inputs(fwd, params))
        self.state = tree_map(_clone, state)
        self.choices, self.log_u = choices.clone(), log_u.clone()
        self.graph, self.change = None, {}

    def _sweep(self, step) -> None:
        out = self.state
        for t in range(self.choices.shape[0]):
            out = step(self.inputs, out, self.choices[t], self.log_u[t],
                       self.bonds)
        torch._foreach_copy_(_tensors(self.state), _tensors(out))

    def run(self, step, params, state: WalkerState, choices: torch.Tensor,
            log_u: torch.Tensor, n_sweeps: int) -> WalkerState:
        n = self.choices.shape[0]
        torch._foreach_copy_(_tensors(self.inputs),
                             _tensors(_inputs(self.fwd, params)))
        torch._foreach_copy_(_tensors(self.state), _tensors(state))
        first = 0
        if self.graph is None:
            self.choices.copy_(choices[:n])
            self.log_u.copy_(log_u[:n])
            sweep = functools.partial(self._sweep, step)
            self.graph, _, self.change = cuda_graph.capture(
                sweep, sweep, self.state.s.device,
                self.fwd.graph_safe.tallies)
            count("sampler.graph.captures")
            first = 1
        if n_sweeps > first:
            span = self.fwd.graph_safe.span
            with annotate(span) if span else contextlib.nullcontext():
                for u in range(first, n_sweeps):
                    self.choices.copy_(choices[u * n:(u + 1) * n])
                    self.log_u.copy_(log_u[u * n:(u + 1) * n])
                    self.graph.replay()
            cuda_graph.add_tallies(self.change, n_sweeps - first)
            count("sampler.graph.replays", n_sweeps - first)
        return tree_map(_clone, self.state)


@dataclasses.dataclass(frozen=True, eq=False)
class MetropolisSampler:
    """Walker-batched Metropolis sampler bound to a log-amplitude function.

    Args:
      log_psi_fn: ``(params, s [B, N]) -> C [B]`` log-amplitudes.
      n_sites: number of lattice sites.
      move: 'flip' | 'exchange' | 'exchange_anti'.
      bonds: [n_bonds, 2] site pairs (required for exchange moves).
      sweep_size: proposals per sweep; defaults to n_sites.
      backend: 'torch' (plain loop, every model and move) or 'cuda' (fused
        sweep kernel; plain real CNNs with flip/exchange, checked by the
        builder).
      lattice_shape: required for backend='cuda'.
      betas: parallel tempering, a strictly decreasing ladder
        (1.0, b_1, ..., b_{R-1}] of exponents: replica r samples
        |psi|^{2 b_r}, and after every sweep adjacent replicas swap their
        configurations (and stored log psi) with the replica-exchange
        acceptance. Only the b = 1 rows (``physical``) feed the
        estimators. None: plain Metropolis. Runs on the torch loop.

    The sweep graphs (:class:`SweepGraph`) live on the sampler object, not
    in a field: ``dataclasses.replace(sampler, log_psi_fn=...)`` starts
    with none, so it never replays a graph that reads another forward's
    inputs.
    """

    log_psi_fn: LogPsiFn
    n_sites: int
    move: str = "flip"
    bonds: Optional[np.ndarray] = None
    sweep_size: Optional[int] = None
    backend: str = "torch"
    lattice_shape: Optional[tuple] = None
    betas: Optional[tuple] = None

    def __post_init__(self):
        if self.move not in ("flip", "exchange", "exchange_anti"):
            raise ValueError(f"unknown move {self.move!r}")
        if self.move.startswith("exchange") and self.bonds is None:
            raise ValueError("exchange moves require bonds")
        if self.backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "cuda" and self.lattice_shape is None:
            raise ValueError("backend='cuda' requires lattice_shape")
        if self.backend == "cuda" and self.move == "exchange_anti":
            raise ValueError("backend='cuda' (the sweep kernel) supports "
                             "flip/exchange moves")
        if self.backend == "cuda" and self.betas is not None:
            raise ValueError("tempering runs on the torch backend")
        if self.betas is not None:
            b = tuple(float(x) for x in self.betas)
            if len(b) < 2:
                raise ValueError("tempering needs >= 2 replicas "
                                 "(betas=None for plain Metropolis)")
            if b[0] != 1.0:
                raise ValueError(f"betas[0] must be 1.0 (the physical "
                                 f"chain), got {b[0]}")
            if any(x <= 0.0 or x > 1.0 for x in b):
                raise ValueError(f"betas must lie in (0, 1], got {b}")
            if any(b[i + 1] >= b[i] for i in range(len(b) - 1)):
                raise ValueError(f"betas must be strictly decreasing: {b}")
        object.__setattr__(self, "_graphs", {})

    @property
    def n_replicas(self) -> int:
        return len(self.betas) if self.betas is not None else 1

    @property
    def _sweep_size(self) -> int:
        return self.sweep_size or self.n_sites

    @property
    def n_choices(self) -> Optional[int]:
        """Range of the integer draw; None for exchange_anti, whose draw is
        a uniform."""
        if self.move == "exchange_anti":
            return None
        return self.n_sites if self.move == "flip" else len(self.bonds)

    def _row_betas(self, n_rows: int, device) -> torch.Tensor:
        """[n_rows] per-row exponent, replica-fastest layout."""
        return torch.tensor(self.betas, dtype=torch.float32,
                            device=device).repeat(n_rows // self.n_replicas)

    def init_state(self, params, key: int, n_walkers: int, device="cpu",
                   rows: Optional[slice] = None) -> WalkerState:
        """``n_walkers`` physical walkers drawn from ``key`` on the host;
        with tempering the state holds n_walkers * R rows (replica-fastest:
        row i*R + r is walker i's replica r). ``rows`` (physical walkers)
        keeps (and evaluates) only those walkers' rows (a rank's shard)."""
        sector = "sz0" if self.move.startswith("exchange") else None
        r = self.n_replicas
        s = init_walkers(key, n_walkers * r, self.n_sites, sector=sector)
        if rows is not None:
            s = s[rows.start * r:rows.stop * r]
        s = s.to(device)
        m = s.shape[0]
        zeros = torch.zeros(m, dtype=torch.int32, device=device)
        return self.refresh(params, WalkerState(
            s=s, log_psi=C(torch.zeros(m, device=device),
                           torch.zeros(m, device=device)),
            n_accept=zeros, n_prop=zeros.clone()))

    def physical(self, state: WalkerState) -> WalkerState:
        """The beta = 1 chain (rows [::R]) that the estimators consume;
        the state itself when tempering is off."""
        if self.betas is None:
            return state
        r = self.n_replicas
        return WalkerState(s=state.s[::r],
                           log_psi=C(state.log_psi.re[::r],
                                     state.log_psi.im[::r]),
                           n_accept=state.n_accept[::r],
                           n_prop=state.n_prop[::r])

    def refresh(self, params, state: WalkerState) -> WalkerState:
        """Recompute stored log psi (call after every parameter update)."""
        return state._replace(log_psi=self.log_psi_fn(params, state.s))

    def _proposal_step(self, params, state: WalkerState,
                       choice: torch.Tensor, log_u: torch.Tensor,
                       bonds: Optional[torch.Tensor],
                       beta_rows: Optional[torch.Tensor] = None
                       ) -> WalkerState:
        """One Metropolis proposal for every walker from one noise row
        (choice: the site or bond, or u_move for exchange_anti).
        beta_rows: per-row tempering exponent (None: 1 everywhere)."""
        log_corr = 0.0
        if self.move == "exchange_anti":
            s_new, log_corr = _propose_exchange_anti(state.s, choice, bonds)
        else:
            s_new = _propose(state.s, choice, self.move, bonds)
        log_psi_new = self.log_psi_fn(params, s_new)
        # accept with prob min(1, q(s'->s)/q(s->s') |psi'/psi|^{2 beta});
        # the Hastings counting correction is beta-independent
        factor = 2.0 if beta_rows is None else beta_rows * 2.0
        accept = log_u < factor * (log_psi_new.re - state.log_psi.re) \
            + log_corr
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
        them; with tempering the M physical ids). ``noise=(choices,
        log_u)`` ([n_props, M] each; choices are u_move for exchange_anti)
        replaces the generated draws; with tempering ``(choices, log_u,
        swap_log_u)``: [n_props, M * R] for every row, and the exchange
        passes' [n_sweeps, R - 1, M]. Where :meth:`graphs_sweep` holds, the
        torch loop replays as a CUDA graph of one sweep.
        """
        n_props = n_sweeps * self._sweep_size
        if self.betas is not None:
            return self._sample_tempered(params, state, step_key, walker_ids,
                                         n_sweeps, noise)
        if noise is None:
            with annotate("sampler.noise", device=False):
                noise = sweep_noise(step_key, walker_ids.to(state.s.device),
                                    n_props, self.n_choices)
        with annotate("sampler.sweep", device=False):
            if self.backend == "cuda":
                s, lp, acc = metropolis_sweep(
                    params, state.s, state.log_psi.re,
                    lattice_shape=self.lattice_shape, n_props=n_props,
                    move=self.move, bonds=self.bonds, noise=noise)
                return WalkerState(s=s, log_psi=C(lp, torch.zeros_like(lp)),
                                   n_accept=state.n_accept + acc,
                                   n_prop=state.n_prop + n_props)
            dev = state.s.device
            choices, log_u = (x.to(dev) for x in noise)
            if n_props and self.graphs_sweep(dev):
                with torch.no_grad():
                    graph = self._sweep_graph(params, state, choices, log_u)
                    return graph.run(self._proposal_step, params, state,
                                     choices, log_u, n_sweeps)
            if dev.type == "cuda":
                count("sampler.graph.eager", n_sweeps)
            bonds = self._bonds(dev)
            for t in range(n_props):
                state = self._proposal_step(params, state, choices[t],
                                            log_u[t], bonds)
            return state

    def graphs_sweep(self, device) -> bool:
        """Whether ``sample`` replays the torch loop on ``device`` as a CUDA
        graph (:class:`SweepGraph`): a CUDA device, the torch backend, no
        tempering (its exchange pass builds host tensors), a forward
        declared graph-safe (its ``graph_safe`` attribute a
        ``utils/cuda_graph.GraphSafe``), and the checked mode of
        ``utils/debug`` off (its index checks read the device)."""
        return (torch.device(device).type == "cuda"
                and self.backend == "torch" and self.betas is None
                and isinstance(getattr(self.log_psi_fn, "graph_safe", None),
                               cuda_graph.GraphSafe)
                and not debug.active())

    def _sweep_graph(self, params, state: WalkerState, choices: torch.Tensor,
                     log_u: torch.Tensor) -> SweepGraph:
        """The sweep graph of this device and shape, made at first use."""
        key = (state.s.device, tuple(state.s.shape), choices.dtype,
               log_u.dtype, tuple((k, tuple(v.shape), v.dtype)
                                  for k, v in sorted(params.items())))
        graph = self._graphs.get(key)
        if graph is None:
            ss = self._sweep_size
            graph = self._graphs[key] = SweepGraph(
                self.log_psi_fn, params, state, choices[:ss], log_u[:ss],
                self._bonds(state.s.device))
        return graph

    def _bonds(self, device) -> Optional[torch.Tensor]:
        return (None if self.bonds is None else torch.as_tensor(
            np.asarray(self.bonds, np.int64), device=device))

    def _sample_tempered(self, params, state: WalkerState, step_key: int,
                         walker_ids: torch.Tensor, n_sweeps: int,
                         noise=None) -> WalkerState:
        """Replica-exchange sampling: per-replica Metropolis sweeps with
        |psi|^{2 b_r} acceptance, then one adjacent-pair exchange pass per
        sweep. Row r of walker i draws its proposals from stream id
        i * R + r under fold_in(step_key, 0), the exchange passes from the
        physical id under fold_in(step_key, 1), so a sharded run stays
        walker for walker the 1-rank run."""
        r, ss = self.n_replicas, self._sweep_size
        dev = state.s.device
        ids = walker_ids.to(dev)
        if noise is None:
            with annotate("sampler.noise", device=False):
                row_ids = (ids[:, None] * r + torch.arange(r, device=dev)
                           ).reshape(-1)
                noise = sweep_noise(fold_in(step_key, 0), row_ids,
                                    n_sweeps * ss, self.n_choices) + (
                    swap_noise(fold_in(step_key, 1), ids, n_sweeps, r - 1),)
        if dev.type == "cuda":
            count("sampler.graph.eager", n_sweeps)
        with annotate("sampler.sweep", device=False):
            choices, log_u, swap_log_u = (x.to(dev) for x in noise)
            beta_rows = self._row_betas(state.s.shape[0], dev)
            bonds = self._bonds(dev)
            for u in range(n_sweeps):
                for i in range(ss):
                    t = u * ss + i
                    state = self._proposal_step(params, state, choices[t],
                                                log_u[t], bonds, beta_rows)
                state = self._swap_step(state, swap_log_u[u])
            return state

    def _swap_step(self, state: WalkerState,
                   log_u: torch.Tensor) -> WalkerState:
        """One replica-exchange pass over the pairs (j, j+1) in order, with
        log-uniforms [R - 1, M]: the swap is accepted with
          min(1, exp(2 (b_j - b_{j+1}) (log|psi(s_{j+1})| - log|psi(s_j)|))).
        Configurations and both parts of log psi travel together (log psi
        does not depend on b), so the pass costs no forward; the
        acceptance counters are per-row Metropolis statistics and stay."""
        r = self.n_replicas
        m = state.s.shape[0] // r
        betas = torch.tensor(self.betas, dtype=torch.float32)
        s = state.s.reshape(m, r, -1).clone()
        lp_re = state.log_psi.re.reshape(m, r).clone()
        lp_im = state.log_psi.im.reshape(m, r).clone()
        for j in range(r - 1):
            gap = float(2.0 * (betas[j] - betas[j + 1]))
            acc = log_u[j] < gap * (lp_re[:, j + 1] - lp_re[:, j])
            for arr in (s, lp_re, lp_im):
                a, b = arr[:, j].clone(), arr[:, j + 1].clone()
                sel = acc[:, None] if arr.dim() == 3 else acc
                arr[:, j] = torch.where(sel, b, a)
                arr[:, j + 1] = torch.where(sel, a, b)
        return state._replace(s=s.reshape(m * r, -1),
                              log_psi=C(lp_re.reshape(-1),
                                        lp_im.reshape(-1)))

    @staticmethod
    def acceptance_rate(state: WalkerState) -> torch.Tensor:
        return state.n_accept.sum() / torch.clamp(state.n_prop.sum(), min=1)

    @staticmethod
    def reset_counters(state: WalkerState) -> WalkerState:
        return state._replace(n_accept=torch.zeros_like(state.n_accept),
                              n_prop=torch.zeros_like(state.n_prop))
