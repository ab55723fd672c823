"""Fixed phase priors on the log-amplitude (port of
``qmcnn_tpu/models/phase.py``).

For a diagonal spin rotation U = prod_i exp(i theta_i S^z_i) the rotated
state is psi'(s) = exp(i sum_i theta_i s_i / 2) psi(s), a pure phase. The
prior adds that phase to the ansatz,

    log psi(s) = log chi(s) + i * sum_i (theta_i / 2) * s_i,

so the network only learns the residual part. Three kinds:
``sublattice_120`` (theta_i = 2 pi c_i / 3 with c_i the NN 3-coloring, the
120-degree order of the triangular and kagome antiferromagnets),
``sublattice_sqrt3`` (the kagome sqrt(3) x sqrt(3) pattern) and
``marshall`` (theta_i = pi on sublattice A of a bipartite lattice).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.models.cnn import Params, nest_params, true_f32
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

KINDS = ("sublattice_120", "sublattice_sqrt3", "marshall")


def phase_half_angles(kind: str, lattice: Lattice) -> Tuple[float, ...]:
    """Per-site theta_i / 2 of a named phase prior (host constants)."""
    if kind == "sublattice_120":
        theta = (2.0 * np.pi / 3.0) * lattice.three_coloring
    elif kind == "sublattice_sqrt3":
        theta = (2.0 * np.pi / 3.0) * lattice.three_coloring_sqrt3
    elif kind == "marshall":
        if not lattice.is_bipartite_compatible:
            raise ValueError(
                "phase_bias='marshall' needs a bipartite NN graph — for "
                "frustrated lattices use 'sublattice_120'")
        theta = np.pi * (np.asarray(lattice.sublattice_mask) == 0)
    else:
        raise ValueError(f"unknown phase_bias {kind!r}; pick one of {KINDS}")
    return tuple((theta / 2.0).astype(np.float64).tolist())


class PhaseBias(nn.Module):
    """log psi(s) = inner(s) + i * sum_i half_angles[i] * s_i: |psi| and the
    sampler's distribution are untouched. No parameters of its own; the
    inner model's nest under ``inner/``."""

    def __init__(self, inner: nn.Module, half_angles: Tuple[float, ...]):
        super().__init__()
        self.inner = inner
        self.coeff = torch.tensor(np.asarray(half_angles, np.float32))

    def forward(self, s: torch.Tensor) -> C:
        out = cplx.as_c(self.inner(s))
        with true_f32():
            phi = s.reshape(s.shape[0], -1).to(torch.float32) \
                @ self.coeff.to(s.device)
        return C(out.re, out.im + phi)

    def init(self, seed: int, device="cpu") -> Params:
        return nest_params("inner", self.inner.init(seed, device=device))
