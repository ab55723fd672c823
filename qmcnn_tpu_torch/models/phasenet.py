"""Dedicated deep phase network: the split amplitude/phase ansatz (port of
``qmcnn_tpu/models/phasenet.py``; Szabo & Castelnovo, PRB 102:214304).

    log psi(s) = inner(s) + i * gate * phi(s),

with phi a real deep CNN over the (cell grid, basis channel) spin encoding
and ``gate`` a scalar that starts at zero, so a wrapped model starts equal
to the bare one. |psi| is untouched. The trunk is the port's real
``LogPsiCNN`` in the deep-stack recipe (selu, fan_in init, residual skips
when deeper than two layers); only its real part is used.
"""
from __future__ import annotations

import torch
from torch import nn

from qmcnn_tpu_torch.models.cnn import LogPsiCNN, Params, nest_params
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


class PhaseNet(nn.Module):
    """log psi(s) = inner(s) + i * gate * trunk(s).re; parameters nest
    under ``inner/`` and ``trunk/``, beside the scalar ``gate``."""

    def __init__(self, inner: nn.Module, trunk: nn.Module):
        super().__init__()
        self.inner = inner
        self.trunk = trunk
        self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, s: torch.Tensor) -> C:
        out = cplx.as_c(self.inner(s))
        phi = cplx.as_c(self.trunk(s)).re
        return C(out.re, out.im + self.gate * phi)

    def init(self, seed: int, device="cpu") -> Params:
        out = nest_params("inner", self.inner.init(seed, device=device))
        out.update(nest_params("trunk",
                               self.trunk.init(seed + 1, device=device)))
        out["params/gate"] = torch.zeros((), device=device)
        return out


def wrap_phase_net(inner: nn.Module, lattice, channels,
                   kernel_size: int = 3) -> PhaseNet:
    """``inner`` wrapped with a deep real-CNN phase trunk over ``lattice``
    (config: model.phase_net_channels / model.phase_net_kernel)."""
    trunk = LogPsiCNN(
        lattice_shape=tuple(lattice.shape),
        channels=tuple(channels),
        kernel_size=kernel_size,
        complex_params=False,
        param_scale=1.0,
        pbc=lattice.pbc,
        init_mode="fan_in",
        activation="selu",
        residual=len(tuple(channels)) > 2,
        basis=lattice.basis,
    )
    return PhaseNet(inner, trunk)
