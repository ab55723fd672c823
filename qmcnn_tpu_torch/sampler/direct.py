"""Direct (ancestral) sampler for the autoregressive ansatz (port of
``qmcnn_tpu/sampler/direct.py``).

|psi|^2 of ``models/arnn.py`` is exactly normalized and factorizes over
the sites, so one pass over the sites draws an exact i.i.d. sample: no
chain, no thermalization, no autocorrelation. The pass fills site 0, 1,
..., N-1 in order. Where the conditional function carries a
``site_cache`` (the PixelCNN trunk, ``models/arnn.SiteCache``), each site
computes only its own position at every layer from the activations cached
so far; otherwise each site runs one full conditional forward on the
walker batch (the walkers start at -1, and a site's conditional ignores
the sites at and after it). The sampler has the interface of
``MetropolisSampler`` and the same ``WalkerState``, so the VMC step,
walker sharding and checkpoints take it unchanged.

Random draws: the uniform of walker w at site i comes from the counter
hash of ``sampler/metropolis.py`` keyed by (fold_in(step_key, i), global
walker id), so n ranks draw what 1 rank draws. ``sample(..., noise=u)``
takes injected uniforms ``u [N, M]`` instead.

Tracing (``utils/profiling``): the span ``sampler.direct`` (with a CUDA
event pair) covers a pass's N site conditionals and its closing log psi;
the counters ``sampler.direct.sites`` (sites drawn) and
``sampler.direct.cached_sites`` (sites drawn through a ``site_cache``)
are always on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Optional

import torch

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import (WalkerState, _noise_hash,
                                                _uniform, init_walkers)
from qmcnn_tpu_torch.utils.profiling import annotate, count

#: salt of the site uniforms in the counter hash
_SALT = 0x3C6EF372


def site_uniforms(step_key: int, walker_ids: torch.Tensor, n_sites: int
                  ) -> torch.Tensor:
    """[N, M] float64 uniforms in (0, 1): site i, walker w from a hash of
    (fold_in(step_key, i), w), on the device of ``walker_ids``."""
    return _uniform(_noise_hash(step_key, walker_ids, n_sites), _SALT)


class _FullForwards:
    """A pass without a cache: site i's conditional is column i of one
    full conditional forward of the walkers drawn so far (``s``, filled
    in place by the pass)."""

    def __init__(self, conditional_fn: Callable[..., tuple], params,
                 s: torch.Tensor):
        self.conditional_fn, self.params, self.s = conditional_fn, params, s

    def log_p_up(self, i: int) -> torch.Tensor:
        return self.conditional_fn(self.params, self.s)[0][:, i]

    def place(self, i: int, spins: torch.Tensor) -> None:
        """Nothing to keep: ``s`` already holds the spins."""


@dataclasses.dataclass(frozen=True, eq=False)
class DirectSampler:
    """Exact ancestral sampler bound to an autoregressive conditional fn.

    Args:
      log_psi_fn: (params, s [B, N]) -> C [B], the stored walker log psi.
      conditional_fn: (params, s [B, N]) -> (log_p_up, log_p_dn) [B, N],
        column i a function of s_<i only; where it has the attribute
        ``site_cache`` ((params, m, device) -> an object with
        ``log_p_up(i)`` [m] and ``place(i, spins)``), a pass draws
        through that instead.
      n_sites: lattice sites.
      sz_zero: draw the placeholder walkers of ``init_state`` in the
        S^z = 0 sector (the conditionals then keep every sample on it).
    """

    log_psi_fn: Callable[..., C]
    conditional_fn: Callable[..., tuple]
    n_sites: int
    sz_zero: bool = False
    #: the site conditionals of one pass, as ``MetropolisSampler``'s
    #: proposals of one sweep: None means ``n_sites`` (a pass fills every
    #: site)
    sweep_size: ClassVar[Optional[int]] = None

    def init_state(self, params, key: int, n_walkers: int, device="cpu",
                   rows: Optional[slice] = None) -> WalkerState:
        """Placeholder walkers (the first ``sample`` regenerates them all;
        only the shape and the sector matter); ``rows`` keeps a rank's."""
        s = init_walkers(key, n_walkers, self.n_sites,
                         sector="sz0" if self.sz_zero else None)
        if rows is not None:
            s = s[rows]
        s = s.to(device)
        zero = torch.zeros(s.shape[0], dtype=torch.int32, device=device)
        return WalkerState(s=s, log_psi=self.log_psi_fn(params, s),
                           n_accept=zero, n_prop=zero.clone())

    def physical(self, state: WalkerState) -> WalkerState:
        """Every walker is physical (no tempering replicas)."""
        return state

    def refresh(self, params, state: WalkerState) -> WalkerState:
        """No-op: ``sample`` regenerates every walker."""
        return state

    def sample(self, params, state: WalkerState, step_key: int,
               walker_ids: torch.Tensor, n_sweeps: int = 1,
               noise=None) -> WalkerState:
        """A fresh exact batch (``n_sweeps`` is ignored: the samples are
        i.i.d.). ``noise``: uniforms [N, M] replacing the hashed ones."""
        m, n = state.s.shape
        dev = state.s.device
        if noise is None:
            noise = site_uniforms(step_key, walker_ids.to(dev), n)
        u = noise.to(dev)
        s = -torch.ones((m, n), dtype=torch.float32, device=dev)
        site_cache = getattr(self.conditional_fn, "site_cache", None)
        with annotate("sampler.direct"), torch.no_grad():
            sites = (_FullForwards(self.conditional_fn, params, s)
                     if site_cache is None else site_cache(params, m, dev))
            for i in range(n):
                p_up = torch.exp(sites.log_p_up(i))
                # compared in float64, u's dtype
                spins = torch.where(u[i] < p_up, 1.0, -1.0)
                s[:, i] = spins
                sites.place(i, spins)
            count("sampler.direct.sites", n)
            count("sampler.direct.cached_sites",
                  0 if site_cache is None else n)
            lp = self.log_psi_fn(params, s)
        return WalkerState(s=s, log_psi=lp,
                           n_accept=state.n_accept + 1,  # all "accepted"
                           n_prop=state.n_prop + 1)

    @staticmethod
    def acceptance_rate(state: WalkerState) -> torch.Tensor:
        return state.n_accept.sum() / torch.clamp(state.n_prop.sum(), min=1)

    @staticmethod
    def reset_counters(state: WalkerState) -> WalkerState:
        return state._replace(n_accept=torch.zeros_like(state.n_accept),
                              n_prop=torch.zeros_like(state.n_prop))
