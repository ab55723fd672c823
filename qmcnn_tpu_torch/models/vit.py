"""Vision-Transformer log-amplitude ansatz (port of
``qmcnn_tpu/models/vit.py``).

The periodic lattice is cut into p^d-site patches, T = prod(L_i / p)
tokens embedded by one dense layer; pre-LN residual blocks (layer norm,
attention, layer norm, GELU MLP) run on the tokens; each head's attention
carries a learned bias indexed by the periodic displacement between two
patches, so every block is equivariant under patch translations. With
``factored=True`` the attention matrix is softmax(bias) alone, shared by
the batch; otherwise it is softmax(q k^T / sqrt(hd) + bias), the logits in
float32. A real or complex lncosh head sums over tokens and features, and
the p^d sub-patch shifts are projected out by a logmeanexp over rolled
copies of the input, which makes log psi exactly translation invariant.

Flax's conventions are kept where torch's differ: ``nn.gelu`` is the tanh
approximation, ``nn.LayerNorm`` has epsilon 1e-6 and computes the variance
as E[x^2] - E[x]^2 (clamped at 0), and ``DenseGeneral((H, hd))`` maps
``[..., D]`` to ``[..., H, hd]`` with a ``[D, H, hd]`` kernel. Parameters
keep the Flax keys and layouts (``params/block0/attn/v/kernel``
``[D, H, hd]``, ``params/block0/attn/relpos_bias`` ``[H, T]``). The
attention is written as explicit einsums, in true float32
(``models/cnn.py:true_f32``). The bfloat16 trunk is not ported.
"""
from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qmcnn_tpu_torch.models.cnn import Params, true_f32
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

_LN_EPS = 1e-6
#: std of a standard normal truncated to [-2, 2] (Flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978


@functools.lru_cache(maxsize=None)
def _relpos_index(grid: Tuple[int, ...]) -> np.ndarray:
    """[T, T] int table: entry (i, j) is the flat index of the periodic
    displacement (pos_i - pos_j) mod grid on the patch torus."""
    t = int(np.prod(grid))
    coords = np.stack(np.unravel_index(np.arange(t), grid), -1)  # [T, d]
    diff = (coords[:, None, :] - coords[None, :, :]) % np.asarray(grid)
    return np.ravel_multi_index(
        tuple(np.moveaxis(diff, -1, 0)), grid).astype(np.int64)


def _patchify(grid: torch.Tensor, lattice_shape: Tuple[int, ...],
              patch: int) -> torch.Tensor:
    """[B, *lattice_shape] -> [B, T, patch**d]: row-major patch grid, the
    spins inside a patch in row-major site order."""
    b = grid.shape[0]
    d = len(lattice_shape)
    split = [b]
    for length in lattice_shape:
        split += [length // patch, patch]
    perm = [0] + [1 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    t = int(np.prod([length // patch for length in lattice_shape]))
    return grid.reshape(split).permute(perm).reshape(b, t, patch ** d)


class _Leaf(nn.Module):
    """A module owning parameters; ``inits`` maps each name to its
    initializer ('lecun' with the fan-in, 'normal' with the std, 'zeros' or
    'ones')."""

    def _param(self, name: str, shape, kind: str, arg=None) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.inits[name] = (kind, arg)

    def __init__(self):
        super().__init__()
        self.inits = {}


class _Dense(_Leaf):
    """Flax ``nn.Dense``: kernel [in, out], bias [out]."""

    def __init__(self, d_in: int, d_out: int, std=None):
        super().__init__()
        if std is None:
            self._param("kernel", (d_in, d_out), "lecun", d_in)
        else:
            self._param("kernel", (d_in, d_out), "normal", std)
        self._param("bias", (d_out,), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class _DenseGeneral(_Leaf):
    """Flax ``nn.DenseGeneral((H, hd))``: [..., D] -> [..., H, hd]."""

    def __init__(self, d: int, heads: int, hd: int):
        super().__init__()
        self._param("kernel", (d, heads, hd), "lecun", d)
        self._param("bias", (heads, hd), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, heads, hd = self.kernel.shape
        y = x @ self.kernel.reshape(d, heads * hd)
        return y.reshape(*x.shape[:-1], heads, hd) + self.bias


class _LayerNorm(_Leaf):
    """Flax ``nn.LayerNorm``: epsilon 1e-6, var = max(E[x^2] - E[x]^2, 0)."""

    def __init__(self, d: int):
        super().__init__()
        self._param("scale", (d,), "ones")
        self._param("bias", (d,), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.scale
        return (x - mean) * mul + self.bias


class _Attention(_Leaf):
    """Multi-head attention with a learned relative-position bias on the
    patch torus; ``factored`` drops q k^T and uses the bias alone."""

    def __init__(self, grid: Tuple[int, ...], d: int, n_heads: int,
                 factored: bool):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"d_model {d} not divisible by n_heads "
                             f"{n_heads}")
        self.grid = tuple(grid)
        self.n_heads = n_heads
        self.factored = factored
        self.hd = d // n_heads
        self._rel = {}  # the relative-position table on each device
        t = int(np.prod(grid))
        self._param("relpos_bias", (n_heads, t), "normal", 0.5)
        self.v = _DenseGeneral(d, n_heads, self.hd)
        if not factored:
            self.q = _DenseGeneral(d, n_heads, self.hd)
            self.k = _DenseGeneral(d, n_heads, self.hd)
        self.proj = _Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        b, t, d = x.shape
        rel = self._rel.get(x.device)
        if rel is None:
            rel = self._rel[x.device] = torch.as_tensor(
                _relpos_index(self.grid), device=x.device)
        bias = self.relpos_bias[:, rel]                    # [H, T, T]
        v = self.v(x)                                      # [B, T, H, hd]
        if self.factored:
            attn = torch.softmax(bias, dim=-1)
            out = torch.einsum("hij,bjhd->bihd", attn, v)
        else:
            q, k = self.q(x), self.k(x)
            logits = torch.einsum("bihd,bjhd->bhij", q, k).to(torch.float32)
            logits = logits / float(np.sqrt(self.hd)) + bias[None]
            attn = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhij,bjhd->bihd", attn, v)
        return self.proj(out.reshape(b, t, d))


class _Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, grid: Tuple[int, ...], d: int, n_heads: int,
                 mlp_ratio: int, factored: bool):
        super().__init__()
        self.ln1 = _LayerNorm(d)
        self.attn = _Attention(grid, d, n_heads, factored)
        self.ln2 = _LayerNorm(d)
        self.mlp1 = _Dense(d, mlp_ratio * d)
        self.mlp2 = _Dense(mlp_ratio * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
        return x + self.mlp2(h)


class LogPsiViT(nn.Module):
    """Translation-invariant ViT wavefunction; the fields of the JAX
    ``LogPsiViT`` (``compute_dtype='bfloat16'`` raises)."""

    def __init__(self, lattice_shape: Tuple[int, ...],
                 channels: Sequence[int] = (32, 32), patch: int = 2,
                 n_heads: int = 4, mlp_ratio: int = 2, factored: bool = True,
                 complex_params: bool = False, param_scale: float = 0.05,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"the ViT trunk in compute_dtype={compute_dtype!r} is not "
                "ported yet (ROADMAP.md); use float32")
        shape = tuple(lattice_shape)
        for length in shape:
            if length % patch:
                raise ValueError(f"patch {patch} does not divide lattice "
                                 f"shape {shape}")
        if len(set(channels)) != 1:
            raise ValueError("vit is constant-width: all channels entries "
                             f"must be equal (got {tuple(channels)})")
        self.lattice_shape = shape
        self.patch = patch
        self.n_blocks = len(channels)
        self.complex_params = complex_params
        d = channels[0]
        grid = tuple(length // patch for length in shape)
        self.embed = _Dense(patch ** len(shape), d)
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", _Block(grid, d, n_heads, mlp_ratio,
                                                factored))
        self.ln_f = _LayerNorm(d)
        head_std = param_scale / float(np.sqrt(d))
        self.head_re = _Dense(d, d, std=head_std)
        if complex_params:
            self.head_im = _Dense(d, d, std=head_std)

    def forward(self, s: torch.Tensor) -> C:
        shape, p = self.lattice_shape, self.patch
        batch = s.shape[0]
        grid = s.reshape(batch, *shape).to(torch.float32)
        # the residual sub-patch translations, projected out explicitly
        dims = tuple(range(1, 1 + len(shape)))
        shifts = list(itertools.product(*[range(p)] * len(shape)))
        x = torch.stack([torch.roll(grid, sh, dims=dims) for sh in shifts])
        a = len(shifts)
        x = x.reshape(a * batch, *shape)
        with true_f32():
            h = self.embed(_patchify(x, shape, p))
            for i in range(self.n_blocks):
                h = getattr(self, f"block{i}")(h)
            h = self.ln_f(h)
            zre = self.head_re(h)
            if self.complex_params:
                z = cplx.lncosh(C(zre, self.head_im(h)))
                logs = C(z.re.reshape(a * batch, -1).sum(-1),
                         z.im.reshape(a * batch, -1).sum(-1))
            else:
                out = cplx.lncosh_real(zre).reshape(a * batch, -1).sum(-1)
                logs = C(out, torch.zeros_like(out))
        return cplx.logmeanexp(logs.reshape(a, batch), dim=0)

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh flat Flax-keyed parameters with Flax's initializers
        (lecun truncated normal kernels, zero biases, unit layer-norm
        scales, normal(0.5) position biases, the head at
        normal(param_scale / sqrt(d))); torch draws, not the JAX init's."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for mod_name, mod in self.named_modules():
            for name, (kind, arg) in getattr(mod, "inits", {}).items():
                shape = getattr(mod, name).shape
                if kind == "zeros":
                    t = torch.zeros(shape)
                elif kind == "ones":
                    t = torch.ones(shape)
                elif kind == "normal":
                    t = torch.randn(shape, generator=gen) * arg
                else:  # lecun: truncated normal, variance 1 / fan_in
                    t = torch.nn.init.trunc_normal_(
                        torch.empty(shape), std=1.0, a=-2.0, b=2.0,
                        generator=gen) * (float(np.sqrt(1.0 / arg))
                                          / _TRUNC_STD)
                key = "/".join(["params", *mod_name.split("."), name])
                out[key] = t.to(device)
        return dict(sorted(out.items()))
