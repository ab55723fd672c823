"""Complex arithmetic over explicit (re, im) float32 pairs.

The port of ``qmcnn_tpu/ops/cplx.py``. Log-amplitudes and local energies are
pairs of real tensors, exactly as in the JAX package, so every parameter is
a real float32 leaf and the gradient / SR conventions are the simple
real-parameter ones (no Wirtinger conjugation). This slice carries the
pieces on the real-CNN training path: ``C``, ``cexp``, ``clog``,
``lncosh_real``, ``selu_real`` and ``logmeanexp``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

LOG2 = 0.6931471805599453


class C(NamedTuple):
    """A complex value/tensor as a (re, im) pair of real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    def __sub__(self, o: "C") -> "C":
        return C(self.re - o.re, self.im - o.im)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def reshape(self, *shape) -> "C":
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def __getitem__(self, idx) -> "C":
        return C(self.re[idx], self.im[idx])

    def mean(self, dim=None) -> "C":
        if dim is None:
            return C(self.re.mean(), self.im.mean())
        return C(self.re.mean(dim), self.im.mean(dim))


def cexp(z: C) -> C:
    """exp(re + i im) = e^re (cos im, sin im)."""
    m = torch.exp(z.re)
    return C(m * torch.cos(z.im), m * torch.sin(z.im))


def clog(z: C) -> C:
    """Principal log: (0.5 log|z|^2, atan2(im, re))."""
    return C(0.5 * torch.log(z.abs2()), torch.atan2(z.im, z.re))


def lncosh_real(x: torch.Tensor) -> torch.Tensor:
    """Stable log(cosh(x)) = |x| - log 2 + log1p(e^{-2|x|})."""
    t = torch.abs(x)
    return t - LOG2 + torch.log1p(torch.exp(-2.0 * t))


def selu_real(x: torch.Tensor) -> torch.Tensor:
    return F.selu(x)


#: real activations by config name (the complex ones come with slice 2)
ACTIVATIONS = {
    "lncosh": lncosh_real,
    "selu": selu_real,
}


def logmeanexp(z: C, dim: int = 0) -> C:
    """log(mean(exp(z))) along dim, stabilized by max Re."""
    m = torch.amax(z.re, dim=dim, keepdim=True).detach()
    w = cexp(C(z.re - m, z.im))
    lg = clog(w.mean(dim))
    return C(lg.re + m.squeeze(dim), lg.im)
