"""Restricted Boltzmann Machine ansatz (port of
``qmcnn_tpu/models/rbm.py``):

    log psi(s) = sum_i a_i s_i + sum_j lncosh((W s)_j + b_j),

one [B, N] x [N, H] product with H = alpha N hidden units. Complex
parameters are (re, im) leaf pairs with the pair lncosh. With
``tie_translations`` the weight matrix is ``alpha`` filters convolved
circularly over the lattice (the circulant expansion of a full-lattice
kernel, ``circulant_weight``) and the visible bias, which is not
translation invariant, is dropped.

Parameters keep the Flax keys: ``params/kernel_re`` ``[N, H]``,
``hidden_bias_re`` ``[H]`` and ``visible_bias_re`` ``[N]`` (and ``_im``),
or ``filter_re`` ``[*shape, 1, alpha]`` and ``hidden_bias_re`` ``[alpha]``
when tied.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from qmcnn_tpu_torch.models.cnn import Params, _tap_offsets, true_f32
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


@functools.lru_cache(maxsize=None)
def _tap_onehot(lattice_shape: Tuple[int, ...], kernel: Tuple[int, ...]
                ) -> np.ndarray:
    """[N, T, N] one-hot: output site p through tap t reads input site q."""
    n = int(np.prod(lattice_shape))
    coords = np.stack(np.unravel_index(np.arange(n), lattice_shape), -1)
    offs = _tap_offsets(kernel)
    onehot = np.zeros((n, len(offs), n), np.float32)
    for t, off in enumerate(offs):
        src = (coords + np.asarray(off)) % np.asarray(lattice_shape)
        onehot[np.arange(n), t, np.ravel_multi_index(src.T, lattice_shape)] \
            = 1.0
    return onehot


def circulant_weight(w: torch.Tensor, lattice_shape: Tuple[int, ...]
                     ) -> torch.Tensor:
    """A circular conv kernel [*k, Cin, Cout] as its [N*Cin, N*Cout]
    matrix (input site-major, then channel)."""
    kernel = tuple(w.shape[:-2])
    cin, cout = w.shape[-2], w.shape[-1]
    n = int(np.prod(lattice_shape))
    onehot = torch.as_tensor(_tap_onehot(tuple(lattice_shape), kernel),
                             device=w.device)
    wc = torch.einsum("ptq,tio->qipo", onehot, w.reshape(-1, cin, cout))
    return wc.reshape(n * cin, n * cout)


class LogPsiRBM(nn.Module):
    """RBM log-amplitude; the fields of the JAX ``LogPsiRBM``."""

    def __init__(self, lattice_shape: Tuple[int, ...], alpha: int = 2,
                 complex_params: bool = False, tie_translations: bool = False,
                 param_scale: float = 0.05):
        super().__init__()
        self.lattice_shape = tuple(lattice_shape)
        self.alpha = alpha
        self.complex_params = complex_params
        self.tie_translations = tie_translations
        self.param_scale = param_scale
        n = int(np.prod(self.lattice_shape))
        parts = ("re", "im") if complex_params else ("re",)
        if tie_translations:
            shapes = {"filter": (*self.lattice_shape, 1, alpha),
                      "hidden_bias": (alpha,)}
        else:
            shapes = {"kernel": (n, alpha * n),
                      "hidden_bias": (alpha * n,), "visible_bias": (n,)}
        for name, shape in shapes.items():
            for part in parts:
                self.register_parameter(f"{name}_{part}",
                                        nn.Parameter(torch.zeros(shape)))

    def _weights(self, part: str):
        """(W [N, H], b [H], a [N] or None) of one part."""
        if self.tie_translations:
            n = int(np.prod(self.lattice_shape))
            return (circulant_weight(getattr(self, f"filter_{part}"),
                                     self.lattice_shape),
                    getattr(self, f"hidden_bias_{part}").repeat(n), None)
        return (getattr(self, f"kernel_{part}"),
                getattr(self, f"hidden_bias_{part}"),
                getattr(self, f"visible_bias_{part}"))

    def forward(self, s: torch.Tensor) -> C:
        with true_f32():
            w_re, b_re, a_re = self._weights("re")
            pre_re = s @ w_re + b_re
            if self.complex_params:
                w_im, b_im, a_im = self._weights("im")
                out = cplx.lncosh(C(pre_re, s @ w_im + b_im))
                re, im = out.re.sum(-1), out.im.sum(-1)
                if a_re is not None:
                    re = re + s @ a_re
                    im = im + s @ a_im
                return C(re, im)
            out = cplx.lncosh_real(pre_re).sum(-1)
            if a_re is not None:
                out = out + s @ a_re
        return C(out, torch.zeros_like(out))

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh flat Flax-keyed parameters, every leaf normal(param_scale)
        (torch draws, not the JAX init's)."""
        gen = torch.Generator().manual_seed(int(seed))
        return {f"params/{name}": (torch.randn(p.shape, generator=gen)
                                   * self.param_scale).to(device)
                for name, p in sorted(self.named_parameters())}
