"""Kagome space-group equivariant GCNN through the depleted-triangular
embedding (port of ``qmcnn_tpu/models/kgcnn.py``).

The kagome lattice is a triangular lattice with one of four sublattices
removed. In fine coordinates (primitive vectors a1/2, a2/2) the sites of an
Lx x Ly cell torus sit on the fine 2Lx x 2Ly triangular torus at

    A(cx, cy) -> (2cx, 2cy)   B -> (2cx+1, 2cy)   C -> (2cx, 2cy+1)

and the (odd, odd) fine sublattice, the hexagon centres, is empty. The
spins are embedded there (zeros at the hexagon centres) and the
p6m-equivariant ``LogPsiTriGCNN`` runs on the fine torus; the kagome space
group is a subgroup of the fine torus's p6m, so psi is exactly invariant
under every kagome isometry. Parameters nest under ``LogPsiTriGCNN_0/``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from qmcnn_tpu_torch.models.cnn import Params, nest_params
from qmcnn_tpu_torch.models.tgcnn import LogPsiTriGCNN
from qmcnn_tpu_torch.ops.cplx import C


def fine_embedding(cell_shape: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(site -> fine flat index, fine flat occupancy mask). The fine torus
    is [2Lx, 2Ly] row-major; kagome sites are cells row-major with the
    basis fastest (the lattice's site order)."""
    lx, ly = cell_shape
    fu, fv = 2 * lx, 2 * ly
    idx = np.zeros((lx * ly * 3,), np.int64)
    mask = np.zeros((fu * fv,), bool)
    for cx in range(lx):
        for cy in range(ly):
            for b, (du, dv) in enumerate(((0, 0), (1, 0), (0, 1))):
                u, v = 2 * cx + du, 2 * cy + dv
                site = (cx * ly + cy) * 3 + b
                fine = u * fv + v
                idx[site] = fine
                mask[fine] = True
    return idx, mask


class LogPsiKagomeGCNN(nn.Module):
    """log psi(s) on the kagome torus with exact space-group symmetry:
    ``LogPsiTriGCNN`` on the 2Lx x 2Ly fine torus. Square cell tori only.
    Same fields as the JAX model."""

    def __init__(self, cell_shape: Tuple[int, int],
                 channels: Sequence[int] = (8, 8), radius: int = 1,
                 complex_params: bool = False, param_scale: float = 0.05,
                 character: str = "A1", init_mode: str = "fixed",
                 activation: str = "lncosh", residual: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        lx, ly = cell_shape
        if lx != ly:
            raise ValueError("the kagome GCNN needs a square cell torus "
                             f"(the D6 rotation mixes axes), got {lx}x{ly}")
        idx, _ = fine_embedding((lx, ly))
        # fine point f takes site src[f]; the hexagon centres take the
        # appended zero column (a gather, so it batches under vmap)
        src = np.full(4 * lx * ly, 3 * lx * ly, np.int64)
        src[idx] = np.arange(3 * lx * ly)
        self.src = torch.as_tensor(src)
        self.add_module("LogPsiTriGCNN_0", LogPsiTriGCNN(
            lattice_shape=(2 * lx, 2 * ly), channels=tuple(channels),
            radius=radius, complex_params=complex_params,
            param_scale=param_scale, character=character,
            init_mode=init_mode, activation=activation, residual=residual,
            compute_dtype=compute_dtype))

    def forward(self, s: torch.Tensor) -> C:
        s = s.reshape(s.shape[0], -1)
        fine = torch.cat([s, s.new_zeros(s.shape[0], 1)], dim=1)[
            :, self.src.to(s.device)]
        return getattr(self, "LogPsiTriGCNN_0")(fine)

    def init(self, seed: int, device="cpu") -> Params:
        return nest_params("LogPsiTriGCNN_0", getattr(
            self, "LogPsiTriGCNN_0").init(seed, device=device))
