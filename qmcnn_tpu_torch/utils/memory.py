"""Memory-estimate-driven auto-chunking (port of
``qmcnn_tpu/utils/memory.py``: ``model_footprint``, ``auto_chunk_size``,
``auto_jacobian_chunk``).

``chunk_size: null`` / ``jacobian_chunk: null`` mean "fit it for me": the
estimators return None (no chunking) whenever the unchunked batch fits the
budget. The memory size is the device's own: ``total_memory`` of the CUDA
device, or the host's physical memory for a CPU run.

Model: peak memory of a batched conv forward ~ batch x (live-layer window
of activations), ~2 layers for a forward-only pass and ~all layers for a
backward pass (saved activations). The window constants are the JAX
package's; they have not been recalibrated against PyTorch's allocator.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

#: live activation window of a forward-only pass, in layers
_FWD_WINDOW = 2.0
#: fraction of device memory the transient forward batch may claim
_BUDGET_FRACTION = 0.45


def device_memory_bytes(device="cuda") -> int:
    """Physical memory of ``device`` (CUDA: total_memory; CPU: host RAM)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


@dataclasses.dataclass(frozen=True)
class ModelFootprint:
    """Per-configuration activation cost of one log-psi forward."""

    n_sites: int
    max_width: int
    n_layers: int

    def fwd_bytes(self) -> float:
        """Transient bytes per config of a forward-only pass."""
        return _FWD_WINDOW * self.n_sites * self.max_width * 4.0

    def bwd_bytes(self) -> float:
        """Transient bytes per config of a value+grad pass."""
        return self.n_layers * self.n_sites * self.max_width * 4.0 * 2.0


def model_footprint(cfg, n_sites: int) -> ModelFootprint:
    """Footprint of the real CNN ansatz (the only model this port builds;
    the JAX version also sizes complex, symmetrized and other families)."""
    channels = tuple(cfg.model.channels) or (1,)
    return ModelFootprint(n_sites=n_sites, max_width=max(channels),
                          n_layers=len(channels))


def _largest_pow2_divisor_leq(m: int, target: float) -> int:
    """Largest power-of-two divisor of m that is <= target (>= 1)."""
    best = 1
    d = 1
    while m % (d * 2) == 0:
        d *= 2
        if d <= target:
            best = d
    return best


def _persistent_bytes(cfg, n_params: Optional[int], m_local: int) -> float:
    """Jacobian + Gram + a generous pad for params/opt/walker state."""
    pad = 256 * 1024**2
    if not cfg.sr.enabled or cfg.sr.solver == "cg" or not n_params:
        return pad
    from qmcnn_tpu_torch.builder import model_log_psi_is_real

    parts = 1 if model_log_psi_is_real(cfg) else 2
    jac = float(m_local) * n_params * 4.0 * parts
    gram = 0.0
    if cfg.sr.solver == "dense":
        gram = float(n_params) ** 2 * 4.0 * 3.0
    return pad + jac + gram


def _budget(cfg, n_params, mem: int) -> float:
    m_local = cfg.sampler.n_walkers
    budget = _BUDGET_FRACTION * mem - _persistent_bytes(cfg, n_params, m_local)
    return max(budget, 0.05 * mem)


def auto_chunk_size(cfg, lattice, ham, n_params: Optional[int] = None,
                    mem_bytes: Optional[int] = None,
                    device="cuda") -> Optional[int]:
    """Local-energy walker chunk (run.chunk_size) or None for unchunked."""
    mem = device_memory_bytes(device) if mem_bytes is None else mem_bytes
    m_local = cfg.sampler.n_walkers
    k1 = ham.n_conn + 1
    fp = model_footprint(cfg, lattice.n_sites)
    budget = _budget(cfg, n_params, mem)
    if m_local * k1 * fp.fwd_bytes() <= budget:
        return None
    return _largest_pow2_divisor_leq(m_local, budget / (k1 * fp.fwd_bytes()))


def auto_jacobian_chunk(cfg, lattice, ham, n_params: Optional[int] = None,
                        mem_bytes: Optional[int] = None,
                        device="cuda") -> Optional[int]:
    """Sample chunk for the materialized SR Jacobian, or None."""
    mem = device_memory_bytes(device) if mem_bytes is None else mem_bytes
    m_local = cfg.sampler.n_walkers
    fp = model_footprint(cfg, lattice.n_sites)
    budget = _budget(cfg, n_params, mem)
    if m_local * fp.bwd_bytes() <= budget:
        return None
    return _largest_pow2_divisor_leq(m_local, budget / fp.bwd_bytes())
