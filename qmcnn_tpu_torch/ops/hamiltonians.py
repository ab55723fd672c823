"""Spin Hamiltonians: diagonal terms + connected-configuration enumeration
(port of ``qmcnn_tpu/ops/hamiltonians.py``: TFIM, Heisenberg, J1-J2).

``connected_batch(s)`` returns a *static-K* batch ``(s_prime [M, K, N],
mel [M, K], mask [M, K])`` with inactive entries masked, K = N (TFIM: one
flip per site) or n_bonds (exchange models: one swap per bond).

Convention: ``mel_k = <s|H|s'_k>`` so that
``E_loc(s) = diag(s) + sum_k mask_k * mel_k * psi(s'_k)/psi(s)``.
With ``marshall=True`` the Marshall rotation flips the sign of
off-diagonal elements that connect different sublattices.

The bond tables are host numpy; each call moves the ones it needs to the
device of ``s``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from qmcnn_tpu_torch.lattice import Lattice

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _dev(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


class Hamiltonian:
    """Base interface: ``n_conn``, ``diag_batch`` and ``connected_batch``."""

    lattice: Lattice

    @property
    def n_conn(self) -> int:
        raise NotImplementedError

    def diag_batch(self, s: torch.Tensor) -> torch.Tensor:
        """Diagonal energies <s|H|s>. s: [M, N] float32 in {-1,+1}."""
        raise NotImplementedError

    def connected_batch(self, s: torch.Tensor) -> Triple:
        """(s' [M,K,N], mel [M,K], mask [M,K])."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class TFIM(Hamiltonian):
    """H = -J sum_<ij> sz_i sz_j - h sum_i sx_i - hz sum_i sz_i (sigma
    convention). Connected states: every single-spin flip, mel = -h."""

    lattice: Lattice
    j: float = 1.0
    h: float = 1.0
    hz: float = 0.0

    @property
    def n_conn(self) -> int:
        return self.lattice.n_sites

    @cached_property
    def _bonds(self) -> np.ndarray:
        return self.lattice.nn_bonds.astype(np.int64)

    @cached_property
    def _flips(self) -> np.ndarray:
        # [N, N]: row k multiplies site k by -1
        n = self.lattice.n_sites
        return 1.0 - 2.0 * np.eye(n, dtype=np.float32)

    def diag_batch(self, s: torch.Tensor) -> torch.Tensor:
        b = _dev(self._bonds, s)
        out = -self.j * torch.sum(s[:, b[:, 0]] * s[:, b[:, 1]], dim=-1)
        if self.hz:
            out = out - self.hz * torch.sum(s, dim=-1)
        return out

    def connected_batch(self, s: torch.Tensor) -> Triple:
        m, n = s.shape
        s_prime = s[:, None, :] * _dev(self._flips, s)
        mel = torch.full((m, n), -self.h, dtype=s.dtype, device=s.device)
        mask = torch.ones((m, n), dtype=torch.bool, device=s.device)
        return s_prime, mel, mask


@dataclasses.dataclass(frozen=True, eq=False)
class Heisenberg(Hamiltonian):
    """Antiferromagnetic Heisenberg / J1-J2 model, spin-1/2 (S = sigma/2):
    H = sum_bonds [ (delta J_b/4) sz_i sz_j + (J_b/2) exchange(anti-aligned) ].

    ``delta`` is the XXZ anisotropy (scales only the diagonal). With
    ``marshall=True`` NN elements across sublattices become -J/2; J2
    (same-sublattice) elements keep +J2/2. One connected state per bond,
    active iff the bond is anti-aligned; masked rows equal ``s``.
    """

    lattice: Lattice
    j: float = 1.0
    j2: float = 0.0
    marshall: bool = True
    delta: float = 1.0

    def __post_init__(self):
        if self.marshall and not self.lattice.is_bipartite_compatible:
            raise ValueError(
                "marshall=True needs a bipartite NN graph (even-dim "
                "hypercubic under PBC); this lattice is not two-colorable "
                f"(geometry={self.lattice.geometry!r}, "
                f"shape={self.lattice.shape}) — set marshall: false")

    @cached_property
    def _all_bonds(self) -> np.ndarray:
        bonds = [self.lattice.nn_bonds]
        if self.j2 != 0.0:
            bonds.append(self.lattice.nnn_bonds)
        return np.concatenate(bonds, axis=0).astype(np.int64)

    @cached_property
    def _couplings(self) -> np.ndarray:
        c = [np.full(len(self.lattice.nn_bonds), self.j, dtype=np.float32)]
        if self.j2 != 0.0:
            c.append(np.full(len(self.lattice.nnn_bonds), self.j2,
                             dtype=np.float32))
        return np.concatenate(c)

    @property
    def n_conn(self) -> int:
        return len(self._all_bonds)

    @cached_property
    def _flip_matrix(self) -> np.ndarray:
        # [K, N]: row b multiplies both sites of bond b by -1
        k, n = len(self._all_bonds), self.lattice.n_sites
        f = np.ones((k, n), dtype=np.float32)
        rows = np.arange(k)
        f[rows, self._all_bonds[:, 0]] = -1.0
        f[rows, self._all_bonds[:, 1]] = -1.0
        return f

    @cached_property
    def _offdiag_mel(self) -> np.ndarray:
        """[K] off-diagonal matrix element per bond (sign incl. Marshall)."""
        sub = self.lattice.sublattice_mask
        i, jj = self._all_bonds[:, 0], self._all_bonds[:, 1]
        if self.marshall:
            sign = np.where(sub[i] != sub[jj], -1.0, 1.0).astype(np.float32)
        else:
            sign = np.ones(len(i), dtype=np.float32)
        return sign * self._couplings / 2.0

    @cached_property
    def _diag_coupling(self) -> np.ndarray:
        return (self.delta * self._couplings / 4.0).astype(np.float32)

    def diag_batch(self, s: torch.Tensor) -> torch.Tensor:
        b = _dev(self._all_bonds, s)
        zz = s[:, b[:, 0]] * s[:, b[:, 1]]
        return torch.sum(_dev(self._diag_coupling, s) * zz, dim=-1)

    def connected_batch(self, s: torch.Tensor) -> Triple:
        m = s.shape[0]
        b = _dev(self._all_bonds, s)
        mask = s[:, b[:, 0]] * s[:, b[:, 1]] < 0  # anti-aligned bonds only
        s_prime = s[:, None, :] * _dev(self._flip_matrix, s)
        # keep masked rows equal to s so their (ignored) forward is tame
        s_prime = torch.where(mask[:, :, None], s_prime, s[:, None, :])
        mel = _dev(self._offdiag_mel, s).to(s.dtype).expand(m, -1)
        return s_prime, mel, mask


def j1j2(lattice: Lattice, j1: float = 1.0, j2: float = 0.5,
         marshall: bool = True) -> Heisenberg:
    """2D J1-J2 frustrated Heisenberg model."""
    return Heisenberg(lattice, j=j1, j2=j2, marshall=marshall)
