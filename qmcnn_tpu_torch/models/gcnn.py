"""Group-equivariant CNN log-amplitude ansatz on the square lattice (port of
``qmcnn_tpu/models/gcnn.py``: ``LogPsiGCNN`` and ``SpinFlipSymmetrized``).

A group convolution over C4v is one dense circular convolution with
G-expanded channels: the expanded kernel ``[k, k, G*Cin, G*Cout]`` is a pure
gather of the base parameters with constant indices (``c4v_tables``).
Expanded channel ``g*C + c`` is feature ``c`` of group element ``g``.
Projecting the per-element readout sums onto a one-dimensional C4v irrep
makes log psi exactly symmetric under the space group p4m.

Layouts: parameters keep the Flax names and layouts
(``params/GroupConv_0/kernel_re`` is ``[k, k, 1, C]`` for the lift layer and
``[G, k, k, C, C]`` for a group layer; biases ``[C]``, tiled over G);
activations run channels-first (``[B, G*C, H, W]``) inside. Complex weights
are (re, im) pairs and a complex group conv is three real convolutions
(Karatsuba), as in the JAX model. A float32 forward runs in true float32
(``models.cnn.true_f32``); ``compute_dtype='bfloat16'`` runs the stack end to
end in bf16 with the JAX model's rounding points (``models/cnn.py``): bf16
convolution operands (the expanded f32 kernel rounded once; the Karatsuba
weight sum A + B summed in f32 first) with f32 accumulation and a bf16
output, the bias added in bf16, f32 activation math rounded back, the bf16
residual skip, and f32 readout sums.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qmcnn_tpu_torch.models.cnn import (Params, _circular_pad, activations,
                                        compute_dtype_of, kernel_std,
                                        nest_params, skip_scale, true_f32)
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

#: C4v one-dimensional irrep characters on the generators (R = 90 degree
#: rotation, M = mirror)
_CHARACTERS = {
    "A1": (1, 1),
    "A2": (1, -1),
    "B1": (-1, 1),
    "B2": (-1, -1),
}


@functools.lru_cache(maxsize=None)
def c4v_tables(k: int) -> tuple:
    """Group tables for C4v acting on a k x k conv kernel (k odd).

    Returns (G, inv, elem_idx, tap_perm, chars, grid_ops) as numpy arrays,
    the same arrays as the JAX function:
      * G = 8; elements are R^r M^m, r in 0..3, m in 0..1 (r fastest);
      * inv[g]: index of g^-1; elem_idx[g, h]: index of g^-1 h;
      * tap_perm[g, t]: (g.w)[tap t] = w[tap_perm[g, t]] (row-major taps);
      * chars[irrep][g]: characters of the four one-dim irreps;
      * grid_ops[g] = (r, m): rot90^r after flip^m on an [H, W] grid.
    """
    if k % 2 != 1:
        raise ValueError(f"GCNN needs an odd kernel size, got {k}")
    # R: (i, j) -> (j, -i), matching rot90 over (H, W); M: (i, j) -> (i, -j)
    R = np.array([[0, 1], [-1, 0]])
    M = np.array([[1, 0], [0, -1]])
    mats, words = [], []
    for m in range(2):
        for r in range(4):
            mats.append(np.linalg.matrix_power(R, r)
                        @ np.linalg.matrix_power(M, m))
            words.append((r, m))
    G = len(mats)

    def find(mat) -> int:
        for i, m_ in enumerate(mats):
            if np.array_equal(m_, mat):
                return i
        raise AssertionError("not closed under composition")

    inv = np.array([find(np.round(np.linalg.inv(m)).astype(int))
                    for m in mats])
    elem_idx = np.array([[find(mats[inv[g]] @ mats[h]) for h in range(G)]
                         for g in range(G)])
    half = (k - 1) // 2
    offs = [(i, j) for i in range(-half, half + 1)
            for j in range(-half, half + 1)]
    off_index = {o: t for t, o in enumerate(offs)}
    tap_perm = np.zeros((G, k * k), np.int32)
    for g in range(G):
        gi = mats[inv[g]]
        for t, o in enumerate(offs):
            tap_perm[g, t] = off_index[tuple(gi @ np.asarray(o))]
    chars = {
        name: np.array([cr ** r * cm ** m for (r, m) in words], np.float32)
        for name, (cr, cm) in _CHARACTERS.items()
    }
    return G, inv, elem_idx, tap_perm, chars, np.array(words, np.int32)


def effective_kernel(kernel_size: int, lattice_shape: Tuple[int, ...]) -> int:
    """The kernel the model uses: at most the lattice, and odd."""
    k = min(kernel_size, min(lattice_shape))
    return k - 1 if k % 2 == 0 else k


def grid_transform(grid: torch.Tensor, r: int, m: int) -> torch.Tensor:
    """Apply group element R^r M^m to [..., H, W] (last two axes)."""
    h_ax, w_ax = grid.dim() - 2, grid.dim() - 1
    if m:
        grid = torch.flip(grid, dims=(w_ax,))
    return torch.rot90(grid, k=r, dims=(h_ax, w_ax))


def _lift_kernel(w: torch.Tensor, tap_perm: np.ndarray, k: int
                 ) -> torch.Tensor:
    """[k,k,Cin,Cout] base -> [k,k,Cin,G*Cout] with block g = (g.w)."""
    G = tap_perm.shape[0]
    cin, cout = w.shape[-2], w.shape[-1]
    idx = torch.as_tensor(tap_perm.astype(np.int64), device=w.device)
    big = w.reshape(k * k, cin, cout)[idx]       # [G, k*k, Cin, Cout]
    return big.permute(1, 2, 0, 3).reshape(k, k, cin, G * cout)


def _group_kernel(w: torch.Tensor, elem_idx: np.ndarray, tap_perm: np.ndarray,
                  k: int) -> torch.Tensor:
    """[G,k,k,Cin,Cout] base -> [k,k,G*Cin,G*Cout]: output block (g, h) is
    g.(w[g^-1 h])."""
    G = elem_idx.shape[0]
    cin, cout = w.shape[-2], w.shape[-1]
    comb = elem_idx[:, :, None] * (k * k) + tap_perm[:, None, :]
    idx = torch.as_tensor(comb.reshape(-1).astype(np.int64), device=w.device)
    big = w.reshape(G * k * k, cin, cout)[idx]
    big = big.reshape(G, G, k * k, cin, cout).permute(2, 1, 3, 0, 4)
    return big.reshape(k, k, G * cin, G * cout)


def conv_expanded(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Circular VALID conv of channels-first x [B, Cin, H, W] with a
    Flax-layout kernel [k, k, Cin, Cout] (periodic lattices only), in the
    dtype of x (the kernel is cast to it)."""
    k = tuple(w.shape[:2])
    return F.conv2d(_circular_pad(x, k), w.to(x.dtype).permute(3, 2, 0, 1))


class GroupConv(nn.Module):
    """One equivariant layer: lifting (lift=True) or C4v group conv. The
    parameters are the base kernels; the expanded kernel is gathered each
    call. The bias is shared over the group axis. Runs in the dtype of its
    input."""

    #: group order (C4v)
    G = 8

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 lift: bool = False, complex_params: bool = False,
                 std: float = 0.05):
        super().__init__()
        self.k = kernel_size
        self.lift = lift
        self.complex_params = complex_params
        self.std = std
        shape = self.base_shape(in_features, features)
        self.kernel_re = nn.Parameter(torch.zeros(shape))
        self.bias_re = nn.Parameter(torch.zeros(features))
        if complex_params:
            self.kernel_im = nn.Parameter(torch.zeros(shape))
            self.bias_im = nn.Parameter(torch.zeros(features))

    def base_shape(self, cin: int, cout: int) -> Tuple[int, ...]:
        """Shape of the base kernel parameter (the Flax layout)."""
        k = self.k
        return (k, k, cin, cout) if self.lift else (self.G, k, k, cin, cout)

    def expand(self, w: torch.Tensor) -> torch.Tensor:
        _, _, elem_idx, tap_perm, _, _ = c4v_tables(self.k)
        if self.lift:
            return _lift_kernel(w, tap_perm, self.k)
        return _group_kernel(w, elem_idx, tap_perm, self.k)

    def forward(self, z):
        G = self.G
        a = self.expand(self.kernel_re)
        if self.complex_params:
            b = self.expand(self.kernel_im)
            if isinstance(z, C):
                p1 = conv_expanded(z.re, a)
                p2 = conv_expanded(z.im, b)
                p3 = conv_expanded(z.re + z.im, a + b)
                out = C(p1 - p2, p3 - p1 - p2)
            else:
                out = C(conv_expanded(z, a), conv_expanded(z, b))
            br = self.bias_re.repeat(G).to(out.re.dtype).reshape(-1, 1, 1)
            bi = self.bias_im.repeat(G).to(out.im.dtype).reshape(-1, 1, 1)
            return C(out.re + br, out.im + bi)
        x0 = z.re if isinstance(z, C) else z
        out = conv_expanded(x0, a)
        return out + self.bias_re.repeat(G).to(out.dtype).reshape(-1, 1, 1)


class LogPsiGCNN(nn.Module):
    """log psi(s) with exact p4m symmetry: lifting group conv -> activation
    -> group convs -> activation -> per-element sums S_g over space and
    channels -> log((1/G) sum_g chi(g) exp(S_g)), with chi(g) = -1 entered
    as +i pi on S_g. Same fields as the JAX model."""

    #: group order, and the layer class's name (the Flax module name)
    G = 8
    layer = "GroupConv"

    def __init__(self, lattice_shape: Tuple[int, ...],
                 channels: Sequence[int] = (8, 8), kernel_size: int = 3,
                 complex_params: bool = False, param_scale: float = 0.05,
                 character: str = "A1", init_mode: str = "fixed",
                 activation: str = "lncosh", residual: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        if len(lattice_shape) != 2:
            raise ValueError("LogPsiGCNN needs a 2D lattice")
        if character not in _CHARACTERS:
            raise ValueError(f"unknown C4v character {character!r}; pick "
                             f"one of {sorted(_CHARACTERS)}")
        self.dtype = compute_dtype_of(compute_dtype)
        if activation not in cplx.ACTIVATIONS:
            raise KeyError(activation)
        self.lattice_shape = tuple(lattice_shape)
        self.channels = tuple(channels)
        self.complex_params = complex_params
        self.character = character
        self.activation = activation
        self.residual = residual
        self.k = self._kernel(kernel_size)
        G = self.G
        n_parts = 2 if complex_params else 1
        cin = 1
        for i, c in enumerate(self.channels):
            extra = 1.0
            if init_mode == "fan_in" and i == len(self.channels) - 1:
                # shrink the last layer so the H*W*G*C readout sum starts
                # near-uniform (see the JAX model)
                extra = 0.1 / np.sqrt(float(np.prod(self.lattice_shape))
                                      * G * c)
            fan_in = self._taps() * (cin if i == 0 else G * cin)
            std = extra * kernel_std(init_mode, param_scale, fan_in,
                                     n_parts=n_parts)
            self.add_module(f"{self.layer}_{i}", self._new_layer(
                cin, c, lift=(i == 0), complex_params=complex_params,
                std=float(std)))
            cin = c

    def _kernel(self, kernel_size: int) -> int:
        return effective_kernel(kernel_size, self.lattice_shape)

    def _taps(self) -> int:
        return self.k * self.k

    def _new_layer(self, cin: int, c: int, **kw) -> nn.Module:
        return GroupConv(cin, c, self.k, **kw)

    def _characters(self) -> dict:
        return c4v_tables(self.k)[4]

    def _activations(self):
        return activations(self.activation, self.dtype)

    def forward(self, s: torch.Tensor) -> C:
        s_g = self.group_sums(s)
        chi = self._characters()[self.character]
        phase = torch.as_tensor(np.where(chi < 0, np.pi, 0.0).astype(
            np.float32), device=s.device)
        return cplx.logmeanexp(C(s_g.re, s_g.im + phase[None, :]), dim=1)

    def group_sums(self, s: torch.Tensor) -> C:
        """The per-element readout sums S_g [B, G] (re, im) before the
        character projection: the fused forward's contract."""
        G = self.G
        batch = s.shape[0]
        act_c, act_r = self._activations()
        scale = skip_scale(self.dtype)
        z = s.reshape(batch, 1, *self.lattice_shape).to(self.dtype)
        n_layers = len(self.channels)
        with true_f32():
            for i, c in enumerate(self.channels):
                z_in = z
                z = getattr(self, f"{self.layer}_{i}")(z)
                z = act_c(z) if isinstance(z, C) else act_r(z)
                if (self.residual and 0 < i < n_layers - 1
                        and c == self.channels[i - 1]):
                    z = (z + z_in) * scale
        c_last = self.channels[-1]
        z = cplx.as_c(z)

        def sums(t):  # accumulated in f32
            return t.reshape(batch, G, c_last, -1).to(torch.float32).sum(
                (2, 3))

        return C(sums(z.re), sums(z.im))

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh parameters as a flat Flax-keyed dict (normal(std) kernels,
        zero biases) from a torch generator: they differ from the JAX init
        of the same seed."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for i in range(len(self.channels)):
            layer = getattr(self, f"{self.layer}_{i}")
            for name, p in sorted(layer.named_parameters()):
                key = f"params/{self.layer}_{i}/{name}"
                if name.startswith("kernel"):
                    out[key] = (torch.randn(p.shape, generator=gen)
                                * layer.std).to(device)
                else:
                    out[key] = torch.zeros(p.shape, device=device)
        return out


class SpinFlipSymmetrized(nn.Module):
    """Z2 spin-inversion projection psi(s) + sector * psi(-s): a
    logmeanexp over {f(s), f(-s) (+ i pi if sector = -1)}. The inner
    model's parameters nest under ``inner/``."""

    def __init__(self, inner: nn.Module, sector: int = 1):
        super().__init__()
        if sector not in (1, -1):
            raise ValueError("spin-flip sector must be +1 or -1")
        self.inner = inner
        self.sector = sector

    def forward(self, s: torch.Tensor) -> C:
        batch = s.shape[0]
        logs = cplx.as_c(self.inner(torch.cat([s, -s], dim=0)))
        pair = logs.reshape(2, batch)
        if self.sector == -1:
            shift = torch.tensor([0.0, np.pi], dtype=torch.float32,
                                 device=s.device)[:, None]
            pair = C(pair.re, pair.im + shift)
        return cplx.logmeanexp(pair, dim=0)

    def init(self, seed: int, device="cpu") -> Params:
        return nest_params("inner", self.inner.init(seed, device=device))
