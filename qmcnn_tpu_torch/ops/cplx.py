"""Complex arithmetic over explicit (re, im) float32 pairs.

The port of ``qmcnn_tpu/ops/cplx.py``. Log-amplitudes, local energies and
complex network weights are pairs of real tensors, exactly as in the JAX
package, so every parameter is a real float32 leaf and the gradient / SR
conventions are the simple real-parameter ones (no Wirtinger conjugation).
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

    def __add__(self, o) -> "C":
        o = as_c(o)
        return C(self.re + o.re, self.im + o.im)

    def __radd__(self, o) -> "C":
        return as_c(o) + self

    def __sub__(self, o) -> "C":
        o = as_c(o)
        return C(self.re - o.re, self.im - o.im)

    def __mul__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)  # real scalar/tensor

    def __rmul__(self, o) -> "C":
        return self * o

    def __truediv__(self, o) -> "C":
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def __neg__(self) -> "C":
        return C(-self.re, -self.im)

    def conj(self) -> "C":
        return C(self.re, -self.im)

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


def as_c(x) -> C:
    """Promote a real tensor/scalar (or pass through a C) to a C pair."""
    if isinstance(x, C):
        return x
    x = torch.as_tensor(x)
    return C(x, torch.zeros_like(x))


def cexp(z: C) -> C:
    """exp(re + i im) = e^re (cos im, sin im)."""
    m = torch.exp(z.re)
    return C(m * torch.cos(z.im), m * torch.sin(z.im))


def clog(z: C) -> C:
    """Principal log: (0.5 log|z|^2, atan2(im, re))."""
    return C(0.5 * torch.log(z.abs2()), torch.atan2(z.im, z.re))


def lncosh(z: C, log2: float = LOG2) -> C:
    """Stable log(cosh(z)) for a complex pair: with t = z sign(Re z),
    log cosh z = t - log 2 + log(1 + e^{-2t}) and |e^{-2t}| <= 1."""
    s = torch.where(z.re >= 0, 1.0, -1.0).to(z.re.dtype)
    tr, ti = z.re * s, z.im * s
    w = cexp(C(-2.0 * tr, -2.0 * ti))
    lg = clog(C(1.0 + w.re, w.im))
    return C(tr - log2 + lg.re, ti + lg.im)


def lncosh_real(x: torch.Tensor, log2: float = LOG2) -> torch.Tensor:
    """Stable log(cosh(x)) = |x| - log 2 + log1p(e^{-2|x|})."""
    t = torch.abs(x)
    return t - log2 + torch.log1p(torch.exp(-2.0 * t))


def selu_reim(z: C) -> C:
    """SELU on re and im separately (keeps the GCNN's equivariance: the
    map is elementwise)."""
    return C(F.selu(z.re), F.selu(z.im))


def selu_real(x: torch.Tensor) -> torch.Tensor:
    return F.selu(x)


#: activations by config name: (complex fn C -> C, real fn)
ACTIVATIONS = {
    "lncosh": (lncosh, lncosh_real),
    "selu": (selu_reim, selu_real),
}


def logmeanexp(z: C, dim: int = 0) -> C:
    """log(mean(exp(z))) along dim, stabilized by max Re."""
    m = torch.amax(z.re, dim=dim, keepdim=True).detach()
    w = cexp(C(z.re - m, z.im))
    lg = clog(w.mean(dim))
    return C(lg.re + m.squeeze(dim), lg.im)
