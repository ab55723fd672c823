"""Memory-estimate-driven auto-chunking (port of
``qmcnn_tpu/utils/memory.py``: ``model_footprint``, ``auto_chunk_size``,
``auto_jacobian_chunk``, the JAX builder's chunk rules for the
(1 + alpha H) ansatz and sector optimization in :func:`run_chunk_size`,
and the builder's memory preflight: :func:`connected_k`,
:func:`peak_estimate`, :func:`preflight_message`, :func:`describe`).

``chunk_size: null`` / ``jacobian_chunk: null`` mean "fit it for me": the
estimators return None (no chunking) whenever the unchunked batch fits the
budget. The memory size is the device's own: ``total_memory`` of the CUDA
device, or the host's physical memory for a CPU run. The walker count is
the per-rank one: M / world size under walker sharding (one rank per
card).

Model: peak memory of a batched conv forward ~ batch x (live-layer window
of activations), ~2 layers for a forward-only pass and ~all layers for a
backward pass (saved activations); a GCNN's width is G-expanded (C4v or
D6, kagome's fine torus folded in), a PhaseNet trunk adds its layers, complex
stacks count two parts and a wider window, the spin-flip projection doubles
the batch and the CNN's translation and point-group averaging multiply it
by N and 8, and the per-sample gradients of the expanded group kernels
add to the backward pass. A frozen state's batch (``orthogonalize_to``:
M x N spins and M log psi, replicated on every rank) is counted as JAX
counts it: inside the persistent pad (256 KiB at the 8x8 M = 1024 run,
against a 256 MiB pad). The RBM, the ARNN and the ViT have footprints of
their own (:func:`model_footprint`). The constants are the JAX package's;
they have not been recalibrated against PyTorch's allocator.
"""
from __future__ import annotations

import dataclasses
import math
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


def connected_k(ham, n_sites: int) -> int:
    """Connected-state count K of ``ham``, counted from its enumeration on
    one configuration (the JAX package's abstract evaluation of
    ``ham.connected``)."""
    _, mel, _ = ham.connected_batch(torch.ones((1, n_sites)))
    return int(mel.shape[1])


@dataclasses.dataclass(frozen=True)
class ModelFootprint:
    """Per-configuration activation cost of one log-psi forward."""

    n_sites: int
    max_width: int        # widest layer's channel count (G-expanded: gcnn)
    n_layers: int
    n_parts: int = 1      # 2 when activations are (re, im) pairs
    sym_batch: int = 1    # internal batch blow-up (spin-flip wrapper: 2)
    fwd_window: float = _FWD_WINDOW   # live layer-buffers per part
    bwd_param_bytes: float = 0.0      # per-sample expanded-kernel grads

    def fwd_bytes(self) -> float:
        """Transient bytes per config of a forward-only pass."""
        return (self.fwd_window * self.n_sites * self.max_width
                * self.n_parts * self.sym_batch * 4.0)

    def bwd_bytes(self) -> float:
        """Transient bytes per config of a value+grad pass: every layer's
        saved activations, plus (group convs) the per-sample gradient of
        every layer's G-expanded kernel."""
        return (self.n_layers * self.n_sites * self.max_width
                * self.n_parts * self.sym_batch * 4.0 * 2.0
                + self.bwd_param_bytes)


def model_footprint(cfg, n_sites: int) -> ModelFootprint:
    """Footprint of every model kind, with the JAX package's constants: a
    GCNN's width is G-expanded (C4v: 8 on the square lattice; D6: 12 on the
    triangular and kagome ones, the kagome width also times the 4/3
    fine-torus points per site); an RBM is one layer of alpha hidden units
    per site; an ARNN's masked dense activations (MADE) are [B, width] plus
    the [B, 3N] heads, reported as one site of that width, and its
    PixelCNN trunk holds C channels at each of the N sites per layer (the
    JAX package counts it as a MADE, which understates it by about N C /
    max(C, 3N)); a ViT's widest
    tensor is the MLP hidden (the p^d shift copies and the N / p^d tokens
    cancel); a PhaseNet trunk adds its layers and may raise the width; the
    CNN's translation and point-group averaging multiply the batch by N and
    8."""
    m = cfg.model
    channels = tuple(m.channels) or (1,)
    geometry = cfg.lattice.geometry
    tri = geometry in ("triangular", "kagome")
    g = (12 if tri else 8) if m.kind == "gcnn" else 1
    if m.kind == "rbm":
        width, n_layers = max(1, int(m.rbm_alpha)), 1
    elif m.kind == "arnn" and m.arnn_conv_kernel:
        return ModelFootprint(n_sites=n_sites, max_width=max(channels),
                              n_layers=len(channels) + 1)
    elif m.kind == "arnn":
        return ModelFootprint(n_sites=1,
                              max_width=max(max(channels), 3 * n_sites),
                              n_layers=len(channels) + 1)
    elif m.kind == "vit":
        width = max(channels) * max(1, int(m.vit_mlp_ratio))
        n_layers = len(channels)
    else:
        width_group = g
        if m.kind == "gcnn" and geometry == "kagome":
            width_group = int(math.ceil(g * 4.0 / 3.0))
        width = max(channels) * width_group
        n_layers = len(channels)
    if m.phase_net_channels:
        width = max(width, max(m.phase_net_channels))
        n_layers += len(m.phase_net_channels)
    n_parts = 2 if m.complex_params else 1
    sym = 2 if m.spin_flip_sector else 1
    if m.kind == "cnn" and m.translation_average:
        sym *= n_sites  # one forward per translation (shift_stride aside)
    if m.kind == "cnn" and m.point_group_average:
        sym *= 8
    bwd_param = 0.0
    if m.kind == "gcnn":
        # per-sample expanded-kernel gradients: sum over layers of
        # G_in * G * taps * Cin * Cout floats (the lift layer has G_in = 1;
        # hexagonal stars carry 1 + 3r(r + 1) taps, square kernels k^2);
        # 1.5: liveness beyond one buffer
        ksz = int(m.kernel_size or 3)
        if tri:
            r = max(1, (ksz - 1) // 2)
            taps = 1 + 3 * r * (r + 1)
        else:
            taps = ksz * ksz
        floats, cin = 0.0, 1
        for cout in channels:
            floats += (1 if cin == 1 else g) * g * taps * cin * cout
            cin = cout
        bwd_param = floats * 4.0 * n_parts * 1.5
    return ModelFootprint(
        n_sites=n_sites, max_width=width, n_layers=n_layers,
        n_parts=n_parts, sym_batch=sym,
        # complex conv stacks keep four real conv outputs live per layer
        fwd_window=(4.0 if m.kind in ("cnn", "gcnn") and m.complex_params
                    else _FWD_WINDOW),
        bwd_param_bytes=bwd_param)


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
    if cfg.sr.solver == "minsr":
        gram = (parts * m_local) ** 2 * 4.0 * 3.0  # gram + Cholesky workspace
    if cfg.sr.solver == "dense":
        gram = float(n_params) ** 2 * 4.0 * 3.0
    return pad + jac + gram


def _local_walkers(cfg, world_size: int) -> int:
    return max(1, cfg.sampler.n_walkers // max(1, world_size))


def _budget(cfg, n_params, mem: int, m_local: int) -> float:
    budget = _BUDGET_FRACTION * mem - _persistent_bytes(cfg, n_params, m_local)
    return max(budget, 0.05 * mem)


def auto_chunk_size(cfg, lattice, ham, n_params: Optional[int] = None,
                    mem_bytes: Optional[int] = None, device="cuda",
                    world_size: int = 1) -> Optional[int]:
    """Local-energy walker chunk (run.chunk_size) or None for unchunked."""
    mem = device_memory_bytes(device) if mem_bytes is None else mem_bytes
    m_local = _local_walkers(cfg, world_size)
    k1 = ham.n_conn + 1
    fp = model_footprint(cfg, lattice.n_sites)
    budget = _budget(cfg, n_params, mem, m_local)
    if m_local * k1 * fp.fwd_bytes() <= budget:
        return None
    return _largest_pow2_divisor_leq(m_local, budget / (k1 * fp.fwd_bytes()))


def auto_jacobian_chunk(cfg, lattice, ham, n_params: Optional[int] = None,
                        mem_bytes: Optional[int] = None, device="cuda",
                        world_size: int = 1) -> Optional[int]:
    """Sample chunk for the materialized SR Jacobian, or None."""
    mem = device_memory_bytes(device) if mem_bytes is None else mem_bytes
    m_local = _local_walkers(cfg, world_size)
    fp = model_footprint(cfg, lattice.n_sites)
    budget = _budget(cfg, n_params, mem, m_local)
    if m_local * fp.bwd_bytes() <= budget:
        return None
    return _largest_pow2_divisor_leq(m_local, budget / fp.bwd_bytes())


def divided_chunk(chunk: int, factor: int, m: int) -> int:
    """``chunk // factor`` (at least 1) rounded down to a divisor of ``m``:
    the walker chunk of a pass whose every walker expands into ``factor``
    times the configurations of an E_loc pass."""
    target = max(1, chunk // factor)
    while m % target:
        target -= 1
    return target


def run_chunk_size(cfg, lattice, ham, n_params: Optional[int] = None,
                   device="cuda", world_size: int = 1) -> Optional[int]:
    """``run.chunk_size`` as the train step uses it: the configured value,
    or (null) :func:`auto_chunk_size` with the JAX builder's two rules.
    The (1 + alpha H) ansatz expands each forward by K more (its own
    E_loc), so its chunk is divided by K = ham.n_conn and rounded down to a
    divisor of the walker count. Sector optimization divides the chunk it
    gets by the T translations, so "E_loc fits unchunked" becomes the
    walker count, which chunks the sector pass at ~M / T walkers."""
    if cfg.run.chunk_size is not None:
        return cfg.run.chunk_size
    chunk = auto_chunk_size(cfg, lattice, ham, n_params, device=device,
                            world_size=world_size)
    m_local = _local_walkers(cfg, world_size)
    if cfg.model.lanczos_alpha is not None:
        target = divided_chunk(chunk or m_local, ham.n_conn, m_local)
        chunk = None if target >= m_local else target
    if cfg.optimizer.sector_momentum is not None and chunk is None:
        chunk = m_local
    return chunk


def peak_estimate(cfg, lattice, ham, n_params: Optional[int] = None,
                  mem_bytes: Optional[int] = None,
                  solver: Optional[str] = None,
                  chunk_size: Optional[int] = None,
                  jacobian_chunk: Optional[int] = None, device="cuda",
                  world_size: int = 1) -> dict:
    """Rough per-card peak-memory estimate for the configured train step
    (the JAX package's model and keys; ``hbm_bytes`` is the card's memory,
    :func:`device_memory_bytes` unless ``mem_bytes`` pins it).

    persistent (SR Jacobian/Gram + pad) + max(E_loc transient, Jacobian-
    materialization transient) at the *given* chunk sizes. A lower-bound
    sanity model (workspaces, copies during the chunked Jacobian assembly
    and fragmentation are not itemized): read fractions near 1 as "will run
    out of memory" and above ~0.8 as risky."""
    mem = device_memory_bytes(device) if mem_bytes is None else mem_bytes
    m_local = _local_walkers(cfg, world_size)
    fp = model_footprint(cfg, lattice.n_sites)
    k1 = connected_k(ham, lattice.n_sites) + 1
    if solver is not None:
        cfg = dataclasses.replace(
            cfg, sr=dataclasses.replace(cfg.sr, solver=solver))
    persistent = _persistent_bytes(cfg, n_params, m_local)
    cs = chunk_size or m_local
    eloc_t = cs * k1 * fp.fwd_bytes()
    jac_t = 0.0
    if cfg.sr.enabled and cfg.sr.solver != "cg" and n_params:
        jac_t = (jacobian_chunk or m_local) * fp.bwd_bytes()
    transient = max(eloc_t, jac_t)
    peak = persistent + transient
    return {"hbm_bytes": float(mem), "persistent_bytes": persistent,
            "transient_bytes": transient, "peak_bytes": peak,
            "fraction": peak / mem}


def preflight_message(est: dict) -> Optional[str]:
    """A warning string when the estimate looks dangerous (above 0.8 of
    the card's memory), else None."""
    frac = est["fraction"]
    if frac <= 0.8:
        return None
    return (f"estimated peak HBM {est['peak_bytes'] / 2**30:.1f} GiB of "
            f"{est['hbm_bytes'] / 2**30:.0f} GiB ({100 * frac:.0f}%; "
            f"persistent SR buffers {est['persistent_bytes'] / 2**30:.1f} "
            "GiB). Running out of the card's memory raises "
            "torch.OutOfMemoryError and ends the run — consider fewer "
            "walkers (sampler.n_walkers), sr.solver=cg, or more devices.")


def describe(cfg, lattice, ham, n_params: Optional[int] = None,
             mem_bytes: Optional[int] = None, device="cuda",
             world_size: int = 1) -> str:
    cs = auto_chunk_size(cfg, lattice, ham, n_params, mem_bytes, device,
                         world_size)
    jc = auto_jacobian_chunk(cfg, lattice, ham, n_params, mem_bytes, device,
                             world_size)
    return (f"auto-chunking: chunk_size={cs or 'off'} "
            f"jacobian_chunk={jc or 'off'}")
