"""The benchmark's own spans and counts around the program's layers, taken
without a hook in the program: ``VMC`` holds its sampler and its SR solver
as fields, so ``dataclasses.replace(vmc, sampler=SamplerProxy(...),
sr=SRProxy(...))`` gives the same step with thin proxies that record CUDA
events around ``refresh``/``sample`` and ``solve``, count the work the
walkers ask for, and (during the checked steps of set-up) keep what the
correctness check reads. Everything else passes through.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from benchmark.reference import hamiltonian


class Recorder:
    """Per-step CUDA events and counts of one run.

    ``step_start()`` marks each step's start (every run: the step tail
    reads their intervals); with ``spans`` the sampler and SR spans are
    recorded and with ``counts`` the E_loc rows and the sweep's changing
    proposals the walkers need (the traced run only); with ``stash`` a dict
    receives what the check reads."""

    def __init__(self, cfg: dict, device, spans: bool = False,
                 counts: bool = False):
        self.cfg = cfg
        self.cuda = torch.device(device).type == "cuda"
        self.spans = spans and self.cuda
        self.counts = counts
        self.starts: List = []
        self.sampler_ev: List = []
        self.sr_ev: List = []
        self.nnz: List[torch.Tensor] = []
        self.sweep_rows: List[torch.Tensor] = []
        self.stash: Optional[dict] = None
        pairs, _, _ = hamiltonian.bonds(cfg)
        self._pairs = torch.as_tensor(pairs, device=device)
        self._nn = torch.as_tensor(hamiltonian.lattice(cfg).nn(cfg),
                                   device=device)

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def step_start(self) -> None:
        self.starts.append(self.event())

    def sweep_need(self, s: torch.Tensor, n_props: int) -> torch.Tensor:
        """Proposals of the coming sweeps that change a walker: for
        ``exchange`` moves the share of anti-aligned nearest-neighbour bonds
        at the sweep's start times the proposals (a bond drawn uniformly),
        for ``flip`` and ``exchange_anti`` every proposal."""
        m = s.shape[0]
        if self.cfg["sampler"]["move"] == "exchange":
            share = hamiltonian.anti_aligned(s, self._nn).float().mean()
            return share * m * n_props
        return torch.tensor(float(m * n_props), device=s.device)

    def nonzero_rows(self, s: torch.Tensor) -> torch.Tensor:
        return hamiltonian.anti_aligned(s, self._pairs).sum()


class SamplerProxy:
    """The program's sampler with the sampler span around ``refresh`` ...
    ``sample`` of a step, and its counts."""

    def __init__(self, inner, rec: Recorder):
        self._inner = inner
        self._rec = rec
        self._open = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def refresh(self, params, state):
        rec = self._rec
        if rec.spans:
            self._open = rec.event()
        if rec.stash is not None:
            rec.stash["params_in"].append(
                {k: v.detach().clone() for k, v in params.items()})
            rec.stash["s_in"].append(state.s.detach().clone())
        return self._inner.refresh(params, state)

    def sample(self, params, state, step_key, walker_ids, n_sweeps,
               noise=None):
        rec = self._rec
        n_props = n_sweeps * (self._inner.sweep_size or self._inner.n_sites)
        if rec.counts:
            rec.sweep_rows.append(rec.sweep_need(state.s, n_props))
        out = self._inner.sample(params, state, step_key, walker_ids,
                                 n_sweeps, noise=noise)
        if rec.spans and self._open is not None:
            rec.sampler_ev.append((self._open, rec.event()))
            self._open = None
        if rec.counts:
            rec.nnz.append(rec.nonzero_rows(self._inner.physical(out).s))
        if rec.stash is not None:
            phys = self._inner.physical(out)
            rec.stash["s_out"].append(phys.s.detach().clone())
            rec.stash["lp_out"].append(
                (phys.log_psi.re.detach().clone(),
                 phys.log_psi.im.detach().clone()))
        return out


class SRProxy:
    """The program's SR solver with the SR span around ``solve``."""

    def __init__(self, inner, rec: Recorder):
        self._inner = inner
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def solve(self, *args, **kwargs):
        rec = self._rec
        start = rec.event() if rec.spans else None
        out = self._inner.solve(*args, **kwargs)
        if start is not None:
            rec.sr_ev.append((start, rec.event()))
        return out


def span_ms(pairs) -> List[float]:
    """Device milliseconds of each recorded (start, end) event pair."""
    return [a.elapsed_time(b) for a, b in pairs]
