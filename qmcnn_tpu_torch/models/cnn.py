"""CNN log-amplitude ansatz log psi_theta(s), real and complex, and the
translation and point-group averaging wrappers (port of
``qmcnn_tpu/models/cnn.py``).

Stacked circular convolutions matching the lattice PBC, lncosh or selu
activations, optional residual skips, and a spatial-sum readout that makes
log psi exactly translation invariant. ``complex_params=True`` gives
complex amplitudes: each layer is a ``ComplexConv`` (two real convolutions
for a real input, three for a complex one, Karatsuba).

Layouts: parameters keep the Flax names and layouts at the public boundary
(``params/RealConv_0/kernel`` is ``[*k, Cin, Cout]``, ``.../bias`` is
``[Cout]``; ``params/ComplexConv_0/kernel_re|kernel_im|bias_re|bias_im``);
activations run channels-first (``[B, C, *spatial]``) inside, and each conv
permutes its kernel to torch's ``[Cout, Cin, *k]``. Both frameworks compute
a cross-correlation, so no kernel flip is needed.

Numerics: with ``compute_dtype='float32'`` every forward runs with TF32 off
for cuDNN convolutions and matmuls (:func:`true_f32`). cuDNN's default TF32
keeps ~3 decimal digits, which would bias the Metropolis acceptance ratios
and the local energies against the f32 sweep kernel. With
``compute_dtype='bfloat16'`` the stack runs end to end in bf16, rounding
where the JAX model rounds: the spins are cast once, every convolution
takes bf16 operands (the f32 kernels rounded once) with f32 accumulation
inside cuDNN / oneDNN and a bf16 output, the bias is added in bf16, the
activation is computed in f32 and rounded back (:func:`activations`), the
residual skip is a bf16 add and a bf16 multiply by 1/sqrt(2) rounded to
bf16 (:func:`skip_scale`), and the readout sums in f32.

API: ``log_psi_apply(model, params, s)`` with ``s`` of shape
``[batch, n_sites]`` (values +-1.) returns a ``C`` pair of ``[batch]``
float32 log-amplitudes (im identically zero for real parameters).
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
#: compute dtypes by config name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}; pick one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


def skip_scale(dtype: torch.dtype) -> float:
    """The residual skip's 1/sqrt(2) as the JAX package multiplies by it:
    a Python float times a bf16 array is a bf16 constant there (0.70703125),
    while torch would keep the float's f32 value."""
    if dtype == torch.float32:
        return _SKIP_SCALE
    return float(torch.tensor(_SKIP_SCALE, dtype=dtype))


def activations(name: str, dtype: torch.dtype):
    """(complex, real) activation of ``name`` for activations stored in
    ``dtype``: under bf16 the math runs in f32 and the result is rounded
    once to bf16 (lncosh near 0 cancels O(1) terms, which bf16 math would
    turn into a bias; the JAX models do the same)."""
    act_c, act_r = cplx.ACTIVATIONS[name]
    if dtype == torch.float32:
        return act_c, act_r

    def real(x):
        return act_r(x.to(torch.float32)).to(dtype)

    def complex_(z):
        out = act_c(C(z.re.to(torch.float32), z.im.to(torch.float32)))
        return C(out.re.to(dtype), out.im.to(dtype))

    return complex_, real


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


def conv_nd(x: torch.Tensor, w: torch.Tensor, pbc: bool = True
            ) -> torch.Tensor:
    """Circular (or zero-padded) VALID convolution of channels-first x
    ``[B, Cin, *spatial]`` with a Flax-layout kernel ``[*k, Cin, Cout]``,
    in the dtype of x: the kernel is cast to it (bf16 operands keep their
    f32 accumulation inside cuDNN / oneDNN and return bf16)."""
    nd = w.dim() - 2
    w = w.to(x.dtype).permute(nd + 1, nd, *range(nd))  # [Cout, Cin, *k]
    conv = F.conv1d if nd == 1 else F.conv2d
    return conv(_circular_pad(x, tuple(w.shape[2:]), pbc), w)


class RealConv(nn.Module):
    """Circular real convolution; Flax-layout ``kernel [*k, Cin, Cout]``
    and ``bias [Cout]``. Runs in the dtype of its input; the bias is cast to
    it (an f32 add would promote a bf16 stack)."""

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
        out = conv_nd(x, self.kernel, self.pbc)
        return out + self.bias.to(out.dtype).reshape(-1, *([1] * nd))


class ComplexConv(nn.Module):
    """Circular complex convolution; weights are (``kernel_re``,
    ``kernel_im``) ``[*k, Cin, Cout]`` and (``bias_re``, ``bias_im``)
    ``[Cout]``. A real input takes two real convolutions; a complex one
    z = x + iy takes three (Karatsuba), with W = A + iB:
    p1 = A x, p2 = B y, p3 = (A + B)(x + y); Re = p1 - p2,
    Im = p3 - p1 - p2. Runs in the dtype of its input (A + B is summed in
    f32 and rounded once)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, ...], pbc: bool = True,
                 std: float = 0.05):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.pbc = pbc
        self.std = std
        shape = (*self.kernel_size, in_features, features)
        self.kernel_re = nn.Parameter(torch.zeros(shape))
        self.kernel_im = nn.Parameter(torch.zeros(shape))
        self.bias_re = nn.Parameter(torch.zeros(features))
        self.bias_im = nn.Parameter(torch.zeros(features))

    def forward(self, z) -> C:
        a, b = self.kernel_re, self.kernel_im
        if isinstance(z, C):
            p1 = conv_nd(z.re, a, self.pbc)
            p2 = conv_nd(z.im, b, self.pbc)
            p3 = conv_nd(z.re + z.im, a + b, self.pbc)
            out = C(p1 - p2, p3 - p1 - p2)
        else:
            out = C(conv_nd(z, a, self.pbc), conv_nd(z, b, self.pbc))
        shape = (-1, *([1] * len(self.kernel_size)))
        return C(out.re + self.bias_re.to(out.re.dtype).reshape(shape),
                 out.im + self.bias_im.to(out.im.dtype).reshape(shape))


class LogPsiCNN(nn.Module):
    """log psi(s): stacked circular convs + activation, spatial-sum readout.

    Same fields as the JAX ``LogPsiCNN``: real or complex parameters, in
    float32 or end-to-end bfloat16 (see the module docstring).
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
        self.dtype = compute_dtype_of(compute_dtype)
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
        self.complex_params = complex_params
        self.layer = "ComplexConv" if complex_params else "RealConv"
        conv = ComplexConv if complex_params else RealConv
        cin = basis
        taps = int(np.prod(self.kernel_size))
        for i, c in enumerate(self.channels):
            std = kernel_std(init_mode, param_scale, fan_in=taps * cin,
                             n_parts=2 if complex_params else 1)
            if init_mode == "fan_in" and i == len(self.channels) - 1:
                # shrink the last layer so the spatial-sum readout starts
                # near-uniform (see the JAX LogPsiGCNN)
                std *= 0.1 / float(np.sqrt(np.prod(self.lattice_shape) * c))
            self.add_module(f"{self.layer}_{i}",
                            conv(cin, c, self.kernel_size, pbc, std))
            cin = c

    def _skip(self, i: int, c: int) -> bool:
        return (self.residual and 0 < i < len(self.channels) - 1
                and c == self.channels[i - 1])

    def forward(self, s: torch.Tensor) -> C:
        batch = s.shape[0]
        act_c, act_r = activations(self.activation, self.dtype)
        act = act_c if self.complex_params else act_r
        scale = skip_scale(self.dtype)
        x = s.reshape(batch, *self.lattice_shape, self.basis)
        x = x.movedim(-1, 1).to(self.dtype)
        with true_f32():
            for i, c in enumerate(self.channels):
                x_in = x
                x = act(getattr(self, f"{self.layer}_{i}")(x))
                if self._skip(i, c):
                    x = (x + x_in) * scale

        def readout(t):  # accumulated in f32
            return t.reshape(batch, -1).to(torch.float32).sum(-1)

        if self.complex_params:
            return C(readout(x.re), readout(x.im))
        out = readout(x)
        return C(out, torch.zeros_like(out))

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh parameters as a flat Flax-keyed dict (normal(std) kernels,
        zero biases). The draws come from a torch generator, so they differ
        from the JAX init of the same seed."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for i in range(len(self.channels)):
            conv = getattr(self, f"{self.layer}_{i}")
            for name, p in sorted(conv.named_parameters()):
                key = f"params/{self.layer}_{i}/{name}"
                if name.startswith("kernel"):
                    out[key] = (torch.randn(p.shape, generator=gen)
                                * conv.std).to(device)
                else:
                    out[key] = torch.zeros(p.shape, device=device)
        return out


class TranslationAveraged(nn.Module):
    """Projection onto a momentum sector by explicit translation averaging:
    log psi_k(s) = logmeanexp_a [log psi(T_a s) + i k.a] over the shifts a
    of the lattice grid, every ``shift_stride``-th along each dimension.
    ``momentum`` gives integer wavenumbers m_d (k_d = 2 pi m_d / L_d); ()
    is the zero-momentum sector. One inner forward per shift; the inner
    model's parameters nest under ``inner/``."""

    def __init__(self, inner: nn.Module, lattice_shape: Tuple[int, ...],
                 shift_stride: int = 1, momentum: Tuple[int, ...] = ()):
        super().__init__()
        self.inner = inner
        self.lattice_shape = tuple(lattice_shape)
        self.shifts = list(itertools.product(
            *[range(0, n, shift_stride) for n in self.lattice_shape]))
        self.phases = None
        if momentum and any(momentum):
            if len(momentum) != len(self.lattice_shape):
                raise ValueError("momentum needs one wavenumber per "
                                 "lattice dimension")
            k = [2.0 * np.pi * m / n
                 for m, n in zip(momentum, self.lattice_shape)]
            self.phases = torch.tensor(np.asarray(
                [sum(kd * ad for kd, ad in zip(k, shift))
                 for shift in self.shifts], dtype=np.float32))

    def forward(self, s: torch.Tensor) -> C:
        batch = s.shape[0]
        grid = s.reshape(batch, *self.lattice_shape)
        dims = tuple(range(1, 1 + len(self.lattice_shape)))
        stacked = torch.stack([torch.roll(grid, sh, dims=dims)
                               .reshape(batch, -1) for sh in self.shifts])
        t = stacked.shape[0]
        logs = cplx.as_c(self.inner(stacked.reshape(t * batch, -1)))
        logs = logs.reshape(t, batch)
        if self.phases is not None:
            logs = C(logs.re, logs.im + self.phases.to(s.device)[:, None])
        return cplx.logmeanexp(logs, dim=0)

    def init(self, seed: int, device="cpu") -> Params:
        return nest_params("inner", self.inner.init(seed, device=device))


class PointGroupAveraged(nn.Module):
    """Projection onto the trivial representation of the square lattice's
    point group: log psi = logmeanexp_g log psi(g s) over the 8 elements of
    C4v (rot90^k after an optional flip of the second axis), or the 4 of
    C2v on a rectangular lattice. The inner model's parameters nest under
    ``inner/``."""

    def __init__(self, inner: nn.Module, lattice_shape: Tuple[int, ...]):
        super().__init__()
        if len(lattice_shape) != 2:
            raise ValueError("PointGroupAveraged needs a 2D lattice")
        self.inner = inner
        self.lattice_shape = tuple(lattice_shape)

    def forward(self, s: torch.Tensor) -> C:
        batch = s.shape[0]
        grid = s.reshape(batch, *self.lattice_shape)
        square = self.lattice_shape[0] == self.lattice_shape[1]
        transforms = []
        for flip in (False, True):
            g0 = torch.flip(grid, dims=(2,)) if flip else grid
            for k in ((0, 1, 2, 3) if square else (0, 2)):
                transforms.append(torch.rot90(g0, k, dims=(1, 2)))
        stacked = torch.stack([g.reshape(batch, -1) for g in transforms])
        g = stacked.shape[0]
        logs = cplx.as_c(self.inner(stacked.reshape(g * batch, -1)))
        return cplx.logmeanexp(logs.reshape(g, batch), dim=0)

    def init(self, seed: int, device="cpu") -> Params:
        return nest_params("inner", self.inner.init(seed, device=device))


def nest_params(prefix: str, params: Params) -> Params:
    """``params`` of a submodule named ``prefix`` within its parent
    ('params/X' -> 'params/<prefix>/X')."""
    return {f"params/{prefix}/" + k[len("params/"):]: v
            for k, v in params.items()}


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
