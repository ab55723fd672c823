"""Learnable two-body Jastrow factor on the log-amplitude (port of
``qmcnn_tpu/models/jastrow.py``).

    log psi(s) = inner(s) + (1/2) sum_{i != j} (v + i u)_{c(i,j)} s_i s_j

with the couplings tied over the minimal-image distance shells c(i, j) of
the periodic lattice, so the factor is invariant under every lattice
isometry and under s -> -s. ``v`` (``amplitude``) is a real pair amplitude,
``u`` (``phase``) a pair phase that leaves |psi| untouched; both start at
zero, so a wrapped model starts equal to the bare one. The coupling matrix
is one gather of the parameter vector (the diagonal's sentinel class has
coupling 0), and the batch pays one [B, N] x [N, N] float32 product.
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


def distance_classes(lattice: Lattice) -> Tuple[np.ndarray, int]:
    """``(class_matrix, n_shells)``: the [N, N] int32 shell index of every
    site pair's minimal-image distance (shells sorted by distance, so shell
    0 is the NN shell), with the diagonal set to the sentinel ``n_shells``.

    Under periodic boundaries the minimal image is taken over the torus
    translations p * L1 + q * L2, p, q in {-1, 0, 1} (three in 1D), with
    L1/L2 the lattice's Cartesian ``primitive_spans``."""
    pos = lattice.site_positions
    diff = pos[:, None, :] - pos[None, :, :]  # [N, N, ndim]
    if lattice.pbc:
        spans = lattice.primitive_spans
        images = [p * spans[0] + (q * spans[1] if len(spans) > 1 else 0.0)
                  for p in (-1, 0, 1)
                  for q in ((-1, 0, 1) if len(spans) > 1 else (0,))]
        d = np.min(np.stack(
            [np.linalg.norm(diff + im, axis=-1) for im in images]), axis=0)
    else:
        d = np.linalg.norm(diff, axis=-1)
    keys = np.round(d, 6)
    shells = np.unique(keys[~np.eye(lattice.n_sites, dtype=bool)])
    cm = np.searchsorted(shells, keys).astype(np.int32)
    np.fill_diagonal(cm, len(shells))
    return cm, int(len(shells))


class Jastrow(nn.Module):
    """log psi(s) = inner(s) + (1/2) (v + i u)[class(i, j)] s_i s_j sums.
    Parameters ``v`` and ``u`` ([n_shells], zeros at init); the inner
    model's nest under ``inner/``."""

    def __init__(self, inner: nn.Module, class_matrix: np.ndarray,
                 n_shells: int, amplitude: bool = True, phase: bool = False):
        super().__init__()
        self.inner = inner
        self.class_matrix = torch.as_tensor(
            np.asarray(class_matrix, np.int64))
        self.n_shells = n_shells
        self.amplitude = amplitude
        self.phase = phase
        if amplitude:
            self.v = nn.Parameter(torch.zeros(n_shells))
        if phase:
            self.u = nn.Parameter(torch.zeros(n_shells))

    def _quad(self, coups: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
        w = torch.cat([coups, coups.new_zeros(1)])[
            self.class_matrix.to(coups.device)]
        with true_f32():
            return 0.5 * ((sf @ w) * sf).sum(-1)

    def forward(self, s: torch.Tensor) -> C:
        out = cplx.as_c(self.inner(s))
        sf = s.reshape(s.shape[0], -1).to(torch.float32)
        re, im = out.re, out.im
        if self.amplitude:
            re = re + self._quad(self.v, sf)
        if self.phase:
            im = im + self._quad(self.u, sf)
        return C(re, im)

    def init(self, seed: int, device="cpu") -> Params:
        out = nest_params("inner", self.inner.init(seed, device=device))
        for name in ("u", "v"):
            if hasattr(self, name):
                out[f"params/{name}"] = torch.zeros(self.n_shells,
                                                    device=device)
        return out


def wrap_jastrow(inner: nn.Module, lattice: Lattice, amplitude: bool = True,
                 phase: bool = False) -> Jastrow:
    cm, n_shells = distance_classes(lattice)
    return Jastrow(inner, cm, n_shells, amplitude=amplitude, phase=phase)
