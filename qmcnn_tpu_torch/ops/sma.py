"""Single-mode-approximation (Feynman) magnon dispersion (the port's own
copy of ``qmcnn_tpu/ops/sma.py``; numpy only).

For the lowest excitation created by S^z_q = sum_j e^{-i q.r_j} S^z_j, the
first moment over the zeroth bounds the magnon dispersion from above at
every momentum:

    omega_min(q) <= omega_SMA(q) = f(q) / S(q),
    f(q) = (1/2N) <[[S^z_q, H], S^z_{-q}]>,   S(q) = (1/N) <S^z_{-q} S^z_q>.

For exchange (Heisenberg, XXZ, J1-J2) Hamiltonians the S^z S^z parts of H
commute with S^z_q, and the double commutator is a sum over the
transverse bond correlators:

    f(q) = - sum_shells J_s sum_{delta in s} (1 - cos(q.delta)) C_t(delta),
    C_t(delta) = (1/N) sum_i <S^x_i S^x_{i+delta} + S^y_i S^y_{i+delta}>,

one amplitude-ratio pass per displacement
(``observables.spin_spin_connected``), with S(q) the FFT of the S^z S^z
correlation the measurement already records. This module is host-side
post-processing of those few scalars and the [N] correlation. q lives on
the reciprocal index grid q_d = 2 pi k_d / L_d of the 1-site-basis
coordinate grid, as ``observables.structure_factor``'s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from qmcnn_tpu_torch.lattice import Lattice

__all__ = ["exchange_shells", "sma_dispersion"]


def exchange_shells(ham, lattice: Lattice) -> List[Tuple[float, int]]:
    """The distinct (transverse coupling J, displacement site index) shells
    of an exchange Hamiltonian's bonds. Each displacement stands for all
    n_sites ordered pairs (i, i + delta): delta and -delta name one shell,
    and the bond count is checked, so f(q) may replace the bond sum by
    n_sites C_t(delta) per entry. Raises ``ValueError`` for a Hamiltonian
    with a transverse field (its double-commutator terms are not in the
    closed form), a multi-site basis (displacements index the site grid)
    and open boundaries (the correlators are translation averages)."""
    from qmcnn_tpu_torch.ops.hamiltonians import Heisenberg

    if not isinstance(ham, Heisenberg):
        raise ValueError(
            "SMA dispersion needs an exchange (Heisenberg-class) "
            f"Hamiltonian; got {type(ham).__name__} (a transverse field "
            "contributes uncomputed double-commutator terms)")
    if lattice.basis > 1:
        raise ValueError("SMA dispersion indexes displacements on the "
                         "site grid; multi-site-basis lattices are not "
                         "supported")
    if not lattice.pbc:
        raise ValueError("SMA dispersion assumes periodic boundaries "
                         "(translation-averaged correlators)")
    n = lattice.n_sites
    shape = tuple(int(x) for x in lattice.shape)
    coords = np.asarray(lattice.coords)
    bonds = np.asarray(ham._all_bonds)
    coup = np.asarray(ham._couplings, dtype=np.float64)

    def disp_index(delta: np.ndarray) -> int:
        return int(np.ravel_multi_index(tuple(delta % np.asarray(shape)),
                                        shape))

    counts: Dict[Tuple[float, int], int] = {}
    for k, (i, j) in enumerate(bonds):
        delta = coords[j] - coords[i]
        # delta and -delta name the same unordered shell: (1 - cos) and
        # C_t are both even
        key = (float(coup[k]), min(disp_index(delta), disp_index(-delta)))
        counts[key] = counts.get(key, 0) + 1
    shells = []
    for (j_s, didx), cnt in sorted(counts.items()):
        if didx == 0:
            raise ValueError("bond with zero displacement")
        if cnt != n and cnt != n // 2:
            # n unordered bonds per displacement on a torus; n // 2 where
            # delta = -delta mod L (an L = 2 axis) halves the orbit
            raise ValueError(
                f"displacement {didx} covers {cnt} bonds, expected "
                f"{n} (or {n//2} for a self-inverse displacement) — "
                "non-translation-invariant bond list?")
        shells.append((j_s * (cnt / n), didx))
    return shells


def sma_dispersion(shells: List[Tuple[float, int]], ct: Dict[int, float],
                   corr, lattice: Lattice):
    """(f, S, omega) on grids of ``lattice.shape``, from
    :func:`exchange_shells`' shells, the measured C_t(delta) per shell
    displacement in ``ct`` and the [n_sites] S^z S^z correlation ``corr``.
    omega = f / S is NaN where S(q) is numerically zero (q = 0 in an
    S^z-conserving sector)."""
    shape = tuple(int(x) for x in lattice.shape)
    sq = np.fft.fftn(np.asarray(corr, dtype=np.float64).reshape(shape)).real
    # grids[d][k] = 2 pi k_d, the integer frequency times 2 pi
    grids = np.meshgrid(
        *[2.0 * np.pi * np.fft.fftfreq(L) * L for L in shape],
        indexing="ij")
    f = np.zeros(shape)
    for j_s, didx in shells:
        delta = np.asarray(lattice.coords[didx], dtype=np.float64)
        phase = sum(g * (d / L) for g, d, L in zip(grids, delta, shape))
        f += -j_s * (1.0 - np.cos(phase)) * float(ct[didx])
    with np.errstate(divide="ignore", invalid="ignore"):
        omega = np.where(np.abs(sq) > 1e-12, f / sq, np.nan)
    return f, sq, omega
