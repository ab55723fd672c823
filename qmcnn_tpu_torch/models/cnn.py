"""CNN log-amplitude ansatz log psi_theta(s), real branch (port of
``qmcnn_tpu/models/cnn.py``).

Stacked circular convolutions matching the lattice PBC, lncosh or selu
activations, optional residual skips, and a spatial-sum readout that makes
log psi exactly translation invariant.

Layouts: parameters keep the Flax names and layouts at the public boundary
(``params/RealConv_0/kernel`` is ``[*k, Cin, Cout]``, ``.../bias`` is
``[Cout]``); activations run channels-first (``[B, C, *spatial]``) inside,
and each conv permutes its kernel to torch's ``[Cout, Cin, *k]``. Both
frameworks compute a cross-correlation, so no kernel flip is needed.

Numerics: with ``compute_dtype='float32'`` every forward runs with TF32 off
for cuDNN convolutions and matmuls (:func:`true_f32`). cuDNN's default TF32
keeps ~3 decimal digits, which would bias the Metropolis acceptance ratios
and the local energies against the f32 sweep kernel.

API: ``log_psi_apply(model, params, s)`` with ``s`` of shape
``[batch, n_sites]`` (values +-1.) returns a ``C`` pair of ``[batch]``
float32 log-amplitudes (im identically zero).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

Params = Dict[str, torch.Tensor]

_SKIP_SCALE = 0.7071067811865476


@contextlib.contextmanager
def true_f32():
    """Full-f32 convolutions and matmuls for the enclosed block; restores
    the caller's settings on exit (nothing is set globally on import)."""
    cudnn = torch.backends.cudnn
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _circular_pad(x: torch.Tensor, kernel: Tuple[int, ...], pbc: bool = True
                  ) -> torch.Tensor:
    """Pad the spatial dims of [batch, C, *spatial] for a 'VALID' conv:
    lo = (k-1)//2 before, k-1-lo after (asymmetric for even k); wrap-pad
    under periodic boundaries, zero-pad for open boundaries. Built from
    slices and ``cat`` so it batches under ``torch.func.vmap``."""
    for d, k in enumerate(kernel):
        lo = (k - 1) // 2
        hi = k - 1 - lo
        if lo == 0 and hi == 0:
            continue
        dim = 2 + d
        if pbc:
            size = x.shape[dim]
            parts = [x.narrow(dim, size - lo, lo)] if lo else []
            parts.append(x)
            if hi:
                parts.append(x.narrow(dim, 0, hi))
            x = torch.cat(parts, dim)
        else:
            pads = [0, 0] * (x.dim() - 2)
            back = x.dim() - 1 - dim  # F.pad lists the last dim first
            pads[2 * back], pads[2 * back + 1] = lo, hi
            x = F.pad(x, pads)
    return x


def _tap_offsets(kernel: Tuple[int, ...]):
    """Offsets per tap matching a conv with (k-1)//2 left wrap-padding."""
    ranges = [[t - (k - 1) // 2 for t in range(k)] for k in kernel]
    return list(itertools.product(*ranges))


def kernel_std(init_mode: str, param_scale: float, fan_in: int,
               n_parts: int = 1) -> float:
    """Per-part normal() std for a conv kernel: ``fixed`` -> param_scale;
    ``fan_in`` -> param_scale / sqrt(n_parts * fan_in) (variance-preserving
    with param_scale as the gain). See the JAX docstring for the rationale."""
    if init_mode == "fixed":
        return param_scale
    if init_mode == "fan_in":
        return param_scale / float(np.sqrt(n_parts * fan_in))
    raise ValueError(f"unknown init_mode {init_mode!r}")


class RealConv(nn.Module):
    """Circular real convolution; Flax-layout ``kernel [*k, Cin, Cout]``
    and ``bias [Cout]``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, ...], pbc: bool = True,
                 std: float = 0.05):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.pbc = pbc
        self.std = std
        self.kernel = nn.Parameter(
            torch.zeros(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = len(self.kernel_size)
        # [*k, Cin, Cout] -> [Cout, Cin, *k]
        w = self.kernel.permute(nd + 1, nd, *range(nd))
        conv = F.conv1d if nd == 1 else F.conv2d
        out = conv(_circular_pad(x, self.kernel_size, self.pbc), w)
        return out + self.bias.reshape(-1, *([1] * nd))


class LogPsiCNN(nn.Module):
    """log psi(s): stacked circular convs + activation, spatial-sum readout.

    Same fields as the JAX ``LogPsiCNN``. ``complex_params=True`` and
    ``compute_dtype='bfloat16'`` are later slices of the port and raise.
    ``conv_impl`` names TPU compute paths of one function; every value
    takes the direct convolution here.
    """

    def __init__(self, lattice_shape: Tuple[int, ...],
                 channels: Sequence[int] = (8, 8),
                 kernel_size: int | Tuple[int, ...] = 3,
                 complex_params: bool = False, param_scale: float = 0.05,
                 conv_impl: str = "auto", pbc: bool = True,
                 compute_dtype: str = "float32", init_mode: str = "fixed",
                 activation: str = "lncosh", residual: bool = False,
                 basis: int = 1):
        super().__init__()
        if complex_params:
            raise NotImplementedError(
                "complex_params=True: the complex CNN is slice 2 of the "
                "PyTorch port (ROADMAP.md, Queue A)")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: reduced-precision stacks "
                "are not ported yet (ROADMAP.md, Queue A)")
        if conv_impl not in ("auto", "direct", "roll", "circulant"):
            raise ValueError(f"unknown conv impl {conv_impl!r}")
        if activation not in cplx.ACTIVATIONS:
            raise KeyError(activation)
        self.lattice_shape = tuple(lattice_shape)
        self.channels = tuple(channels)
        ksz = kernel_size
        if isinstance(ksz, int):
            ksz = (ksz,) * len(self.lattice_shape)
        self.kernel_size = tuple(min(k, L)
                                 for k, L in zip(ksz, self.lattice_shape))
        self.pbc = pbc
        self.activation = activation
        self.residual = residual
        self.basis = basis
        self.init_mode = init_mode
        cin = basis
        taps = int(np.prod(self.kernel_size))
        for i, c in enumerate(self.channels):
            std = kernel_std(init_mode, param_scale, fan_in=taps * cin)
            if init_mode == "fan_in" and i == len(self.channels) - 1:
                # shrink the last layer so the spatial-sum readout starts
                # near-uniform (see the JAX LogPsiGCNN)
                std *= 0.1 / float(np.sqrt(np.prod(self.lattice_shape) * c))
            self.add_module(f"RealConv_{i}",
                            RealConv(cin, c, self.kernel_size, pbc, std))
            cin = c

    def _skip(self, i: int, c: int) -> bool:
        return (self.residual and 0 < i < len(self.channels) - 1
                and c == self.channels[i - 1])

    def forward(self, s: torch.Tensor) -> C:
        batch = s.shape[0]
        act = cplx.ACTIVATIONS[self.activation][1]
        x = s.reshape(batch, *self.lattice_shape, self.basis)
        x = x.movedim(-1, 1).to(torch.float32)
        with true_f32():
            for i, c in enumerate(self.channels):
                x_in = x
                x = act(getattr(self, f"RealConv_{i}")(x))
                if self._skip(i, c):
                    x = (x + x_in) * _SKIP_SCALE
        out = x.reshape(batch, -1).sum(-1)
        return C(out, torch.zeros_like(out))

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh parameters as a flat Flax-keyed dict (normal(std) kernels,
        zero biases). The draws come from a torch generator, so they differ
        from the JAX init of the same seed."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for i in range(len(self.channels)):
            conv = getattr(self, f"RealConv_{i}")
            out[f"params/RealConv_{i}/bias"] = torch.zeros(
                conv.bias.shape, device=device)
            out[f"params/RealConv_{i}/kernel"] = (torch.randn(
                conv.kernel.shape, generator=gen) * conv.std).to(device)
        return out


def module_names(params: Params) -> Params:
    """Flax flat keys -> module parameter names
    ('params/RealConv_0/kernel' -> 'RealConv_0.kernel')."""
    out = {}
    for k, v in params.items():
        head, _, rest = k.partition("/")
        if head != "params" or not rest:
            raise KeyError(f"not a Flax params key: {k!r}")
        out[rest.replace("/", ".")] = v
    return out


def log_psi_apply(model: nn.Module, params: Params, s: torch.Tensor) -> C:
    """Uniform entry point: log psi of ``s`` [B, N] under flat ``params``."""
    return torch.func.functional_call(model, module_names(params), (s,),
                                      strict=True)
