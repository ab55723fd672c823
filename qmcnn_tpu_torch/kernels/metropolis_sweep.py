"""Fused Metropolis sweep: the CUDA kernel's wrapper and its plain version
(port of ``qmcnn_tpu/kernels/metropolis_pallas.py``).

``metropolis_sweep`` runs ``n_props`` sequential Metropolis proposals for
every walker of the real, lncosh, skip-free, periodic ``LogPsiCNN`` in one
kernel launch (``csrc/metropolis_sweep.cu``; that file's header note gives
the design and the bound). On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs ``sweep_reference``, the plain PyTorch
version with the same contract. Nothing falls back silently.

Noise comes in from outside, as in the TPU kernel: ``noise=(choices,
log_u)``, both ``[n_props, M]`` (flip: the site; exchange: the bond index).
Identical noise gives identical Metropolis decisions in the kernel, in
``sweep_reference``, in the port's torch sampler and in the JAX sampler,
up to forward-pass rounding at the acceptance threshold.

Build: the kernel is compiled at first use with ``nvcc`` for ``sm_90a``
into ``qmcnn_tpu_torch/_build/`` (git-ignored), from this repository's
sources only, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qmcnn_tpu_torch.kernels.nvcc import CSRC, MAX_SMEM_BYTES, build_library
from qmcnn_tpu_torch.models.cnn import LogPsiCNN, _tap_offsets, log_psi_apply

SOURCE = CSRC / "metropolis_sweep.cu"
MAX_LAYERS = 16

_LIB: Dict[str, ctypes.CDLL] = {}


def build():
    """Compile the kernel library if needed: (library path, compiler log)."""
    return build_library(SOURCE)


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("sweep")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.metropolis_sweep_launch.argtypes = [vp] * 11 + [ci] * 6 + [
            vp, ci, ci, vp]
        lib.metropolis_sweep_launch.restype = ci
        _LIB["sweep"] = lib
    return lib


@functools.lru_cache(maxsize=None)
def source_sites(lattice_shape: Tuple[int, ...], kernel: Tuple[int, ...]
                 ) -> np.ndarray:
    """[taps, N] int32: output site p reads input site ``table[t, p]``
    through tap t under periodic wrap (the circular padding of
    ``models.cnn._circular_pad``)."""
    n = int(np.prod(lattice_shape))
    coords = np.stack(np.unravel_index(np.arange(n), lattice_shape), -1)
    offs = _tap_offsets(kernel)
    table = np.zeros((len(offs), n), np.int32)
    for t, off in enumerate(offs):
        src = (coords + np.asarray(off)) % np.asarray(lattice_shape)
        table[t] = np.ravel_multi_index(src.T, lattice_shape)
    return table


def conv_layers(params, lattice_shape: Sequence[int]):
    """[(kernel [*k, Cin, Cout], bias [Cout])] of a plain real LogPsiCNN;
    raises for anything else (complex or wrapped models)."""
    layers = []
    while f"params/RealConv_{len(layers)}/kernel" in params:
        i = len(layers)
        layers.append((params[f"params/RealConv_{i}/kernel"],
                       params[f"params/RealConv_{i}/bias"]))
    if not layers or len(params) != 2 * len(layers):
        raise ValueError("the sweep kernel takes a plain real LogPsiCNN "
                         "(params/RealConv_i/{kernel,bias} only); got keys "
                         f"{sorted(params)[:4]}...")
    nd = len(lattice_shape)
    cin = 1
    for kern, bias in layers:
        k = tuple(kern.shape[:-2])
        if len(k) != nd or any(a > L for a, L in zip(k, lattice_shape)):
            raise ValueError(f"kernel shape {tuple(kern.shape)} does not fit "
                             f"lattice {tuple(lattice_shape)}")
        if kern.shape[-2] != cin or bias.shape != (kern.shape[-1],):
            raise ValueError("RealConv channel counts do not chain (the "
                             "sweep kernel needs basis 1)")
        cin = kern.shape[-1]
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {len(layers)}")
    return layers


def _site_noise(s, move, bonds, n_props, noise):
    """Validate the inputs; return (site_a, site_b, log_u), each
    [n_props, M] on the device of ``s`` (None when n_props == 0)."""
    if s.dim() != 2 or s.dtype != torch.float32:
        raise ValueError(f"s must be [M, N] float32, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if move not in ("flip", "exchange"):
        raise ValueError(f"the sweep supports flip/exchange, got {move!r}")
    if move == "exchange" and bonds is None:
        raise ValueError("exchange move requires bonds")
    if n_props < 0:
        raise ValueError(f"n_props must be >= 0, got {n_props}")
    if n_props == 0:
        return None, None, None
    if noise is None:
        raise ValueError("n_props > 0 needs noise=(choices, log_u)")
    m, n = s.shape
    choices, log_u = noise
    if tuple(choices.shape) != (n_props, m) or tuple(log_u.shape) != (
            n_props, m):
        raise ValueError(f"noise must be [n_props={n_props}, M={m}], got "
                         f"{tuple(choices.shape)} / {tuple(log_u.shape)}")
    if log_u.dtype != torch.float32:
        raise ValueError(f"log_u must be float32, got {log_u.dtype}")
    n_choices = n if move == "flip" else len(bonds)
    lo, hi = int(choices.min()), int(choices.max())
    if lo < 0 or hi >= n_choices:
        raise ValueError(f"choices must lie in [0, {n_choices}), got "
                         f"[{lo}, {hi}]")
    choices = choices.to(device=s.device, dtype=torch.long)
    log_u = log_u.to(s.device)
    if move == "exchange":
        b = torch.as_tensor(np.asarray(bonds, np.int64), device=s.device)
        return b[choices, 0], b[choices, 1], log_u
    return choices, choices, log_u


def _check_log_psi(s, log_psi_re):
    if log_psi_re.shape != (s.shape[0],) or log_psi_re.dtype != torch.float32:
        raise ValueError("log_psi_re must be [M] float32, got "
                         f"{tuple(log_psi_re.shape)} {log_psi_re.dtype}")


def sweep_reference(params, s: torch.Tensor, log_psi_re: torch.Tensor, *,
                    lattice_shape: Sequence[int], n_props: int,
                    move: str = "flip", bonds: Optional[np.ndarray] = None,
                    noise=None):
    """Plain PyTorch version of the kernel, same contract: a Python loop
    over proposals, each one batched over walkers through ``LogPsiCNN``.

    Returns (s_out [M, N] f32, log_psi_out [M] f32, n_accept [M] int32).
    """
    lattice_shape = tuple(lattice_shape)
    layers = conv_layers(params, lattice_shape)
    site_a, site_b, log_u = _site_noise(s, move, bonds, n_props, noise)
    _check_log_psi(s, log_psi_re)
    model = LogPsiCNN(lattice_shape,
                      channels=[int(k.shape[-1]) for k, _ in layers],
                      kernel_size=tuple(layers[0][0].shape[:-2]))
    m, n = s.shape
    n_acc = torch.zeros(m, dtype=torch.int32, device=s.device)
    if n_props == 0:
        return s.clone(), log_psi_apply(model, params, s).re, n_acc
    idx = torch.arange(n, device=s.device)[None, :]
    s_cur, lp = s.clone(), log_psi_re.clone()
    for t in range(n_props):
        a, b = site_a[t][:, None], site_b[t][:, None]
        if move == "flip":
            flip = idx == a
        else:
            anti = s_cur.gather(1, a) * s_cur.gather(1, b) < 0.0
            flip = ((idx == a) | (idx == b)) & anti
        s_prop = torch.where(flip, -s_cur, s_cur)
        lp_prop = log_psi_apply(model, params, s_prop).re
        accept = log_u[t] < 2.0 * (lp_prop - lp)
        s_cur = torch.where(accept[:, None], s_prop, s_cur)
        lp = torch.where(accept, lp_prop, lp)
        n_acc += accept.to(torch.int32)
    return s_cur, lp, n_acc


def smem_bytes(n_sites: int, taps: int, channels: Sequence[int]) -> int:
    """Shared memory one block of the kernel needs (``channels`` includes
    the input channel count first). Mirrors ``smem_layout`` in the .cu
    source, which checks that the two agree at every launch."""
    def r4(x):
        return (x + 3) // 4 * 4

    coutp = [(c + 15) // 16 * 16 for c in channels[1:]]
    w_total = sum(taps * channels[i] * coutp[i] for i in range(len(coutp)))
    floats = (r4(w_total) + r4(sum(coutp)) + 2 * r4(max(channels[1:]) * n_sites)
              + 2 * r4(n_sites) + 32)
    return 4 * (floats + taps * n_sites)


def metropolis_sweep(params, s: torch.Tensor, log_psi_re: torch.Tensor, *,
                     lattice_shape: Sequence[int], n_props: int,
                     move: str = "flip", bonds: Optional[np.ndarray] = None,
                     noise=None):
    """Fused Metropolis sweep (see the module docstring).

    Args:
      params: flat Flax-keyed LogPsiCNN params (real, lncosh, no skips,
        periodic; the builder checks the model, this checks the params).
      s: [M, N] float32 walker configurations; log_psi_re: [M] cached
        Re log psi.
      n_props: proposals per walker (0 = recompute log psi only).
      move: 'flip' | 'exchange' (needs ``bonds`` [n_bonds, 2]).
      noise: (choices, log_u), each [n_props, M].

    Returns (s_out [M, N] f32, log_psi_out [M] f32, n_accept [M] int32).
    """
    if s.device.type == "cpu":
        return sweep_reference(params, s, log_psi_re,
                               lattice_shape=lattice_shape, n_props=n_props,
                               move=move, bonds=bonds, noise=noise)
    if s.device.type != "cuda":
        raise ValueError(f"metropolis_sweep runs on cuda or cpu tensors, got "
                         f"{s.device}")
    lattice_shape = tuple(lattice_shape)
    layers = conv_layers(params, lattice_shape)
    site_a, site_b, log_u = _site_noise(s, move, bonds, n_props, noise)
    _check_log_psi(s, log_psi_re)
    m, n = s.shape
    if n != int(np.prod(lattice_shape)):
        raise ValueError(f"s has {n} sites, lattice {lattice_shape} has "
                         f"{int(np.prod(lattice_shape))}")
    dev = s.device
    kernel = tuple(int(k) for k in layers[0][0].shape[:-2])
    taps = int(np.prod(kernel))
    channels = [1] + [int(k.shape[-1]) for k, _ in layers]
    ws, bs = [], []
    for kern, bias in layers:
        cin, cout = int(kern.shape[-2]), int(kern.shape[-1])
        pad = (cout + 15) // 16 * 16 - cout
        w = kern.detach().to(dev, torch.float32).reshape(taps, cin, cout)
        ws.append(torch.nn.functional.pad(w, (0, pad)).reshape(-1))
        bs.append(torch.nn.functional.pad(
            bias.detach().to(dev, torch.float32), (0, pad)))
    weights = torch.cat(ws).contiguous()
    biases = torch.cat(bs).contiguous()
    nbr = torch.as_tensor(source_sites(lattice_shape, kernel), device=dev)
    if n_props == 0:
        zeros = torch.zeros((1, m), dtype=torch.int32, device=dev)
        site_a = site_b = zeros
        log_u = torch.zeros((1, m), dtype=torch.float32, device=dev)
    site_a = site_a.to(torch.int32).contiguous()
    site_b = site_b.to(torch.int32).contiguous()
    log_u = log_u.contiguous()
    s_in = s.contiguous()
    lp_in = log_psi_re.contiguous()
    for name, x in (("s", s_in), ("log_psi_re", lp_in), ("noise", log_u)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, s on {dev}")
    smem = smem_bytes(n, taps, channels)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the sweep kernel needs {smem} bytes of shared "
                         f"memory per block, above Hopper's {MAX_SMEM_BYTES}")
    threads = min(1024, (n + 31) // 32 * 32)
    s_out = torch.empty_like(s_in)
    lp_out = torch.empty_like(lp_in)
    n_acc = torch.empty(m, dtype=torch.int32, device=dev)
    ch = (ctypes.c_int * len(channels))(*channels)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().metropolis_sweep_launch(
            s_in.data_ptr(), lp_in.data_ptr(), site_a.data_ptr(),
            site_b.data_ptr(), log_u.data_ptr(), weights.data_ptr(),
            biases.data_ptr(), nbr.data_ptr(), s_out.data_ptr(),
            lp_out.data_ptr(), n_acc.data_ptr(), m, n, taps, n_props,
            int(move == "exchange"), len(layers),
            ctypes.cast(ch, ctypes.c_void_p), threads, smem, stream)
    metropolis_sweep.launches += 1
    if err != 0:
        raise RuntimeError(f"metropolis_sweep launch failed: CUDA error {err}")
    return s_out, lp_out, n_acc


#: launches of the CUDA kernel since the last reset (CPU calls, which run
#: the plain version, do not count)
metropolis_sweep.launches = 0
