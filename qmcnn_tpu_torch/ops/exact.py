"""Exact diagonalization oracle (SURVEY.md R11 / N9).

Independent, bit-twiddling construction of the Hamiltonians on the full
2^N-dimensional Hilbert space, used as ground truth for every other layer:
matrix elements (tests of ``connected()``), sampling distributions, local
energies, and final variational energies (the BASELINE gate: rel. error vs
exact on 1D TFIM N=16 / Heisenberg).

Pure numpy/scipy, host-side. Practical up to N ~ 20 (sparse Lanczos).

Conventions: basis state = integer b in [0, 2^N); bit i of b set means spin
up, sigma^z_i = +1. Spin-1/2 operators S = sigma/2. Site order matches the
flat row-major indexing in :mod:`qmcnn_tpu_torch.lattice`.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _spins(n: int) -> np.ndarray:
    """[2^n, n] array of sigma^z values (+-1) for every basis state."""
    states = np.arange(1 << n, dtype=np.int64)
    bits = (states[:, None] >> np.arange(n)) & 1
    return (2 * bits - 1).astype(np.int8)


def sparse_tfim(n: int, bonds: np.ndarray, j: float = 1.0, h: float = 1.0,
                hz: float = 0.0) -> sp.csr_matrix:
    """H = -J sum_bonds sz_i sz_j - h sum_i sx_i - hz sum_i sz_i
    (sigma convention)."""
    dim = 1 << n
    s = _spins(n)
    states = np.arange(dim, dtype=np.int64)
    diag = -j * (s[:, bonds[:, 0]] * s[:, bonds[:, 1]]).sum(axis=1).astype(np.float64)
    if hz:
        diag = diag - hz * s.sum(axis=1).astype(np.float64)
    rows = [states]
    cols = [states]
    vals = [diag]
    for i in range(n):
        rows.append(states)
        cols.append(states ^ (1 << i))
        vals.append(np.full(dim, -h, dtype=np.float64))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(dim, dim),
    )


def sparse_heisenberg(
    n: int,
    bonds: np.ndarray,
    j: float = 1.0,
    nnn_bonds: np.ndarray | None = None,
    j2: float = 0.0,
    delta: float = 1.0,
) -> sp.csr_matrix:
    """H = J sum_<ij> S_i . S_j (+ J2 over nnn bonds), spin-1/2 (S = sigma/2).

    Per bond: (delta J/4) sz_i sz_j diagonal + (J/2) exchange of
    anti-aligned pairs; ``delta`` is the XXZ anisotropy (1 = isotropic).
    """
    dim = 1 << n
    s = _spins(n).astype(np.float64)
    states = np.arange(dim, dtype=np.int64)

    def add_bonds(bond_list, coupling, rows, cols, vals, diag):
        for (a, b) in np.asarray(bond_list, dtype=np.int64):
            zz = s[:, a] * s[:, b]
            diag += (delta * coupling / 4.0) * zz
            anti = zz < 0
            flip = (1 << int(a)) | (1 << int(b))
            rows.append(states[anti])
            cols.append(states[anti] ^ flip)
            vals.append(np.full(int(anti.sum()), coupling / 2.0, dtype=np.float64))

    rows, cols, vals = [], [], []
    diag = np.zeros(dim, dtype=np.float64)
    add_bonds(bonds, j, rows, cols, vals, diag)
    if nnn_bonds is not None and j2 != 0.0:
        add_bonds(nnn_bonds, j2, rows, cols, vals, diag)
    rows.append(states)
    cols.append(states)
    vals.append(diag)
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(dim, dim),
    )


def sparse_xyz(n: int, bonds: np.ndarray, jx: float = 1.0, jy: float = 1.0,
               jz: float = 1.0, hx: float = 0.0, hz: float = 0.0
               ) -> sp.csr_matrix:
    """H = sum_bonds [Jx SxSx + Jy SySy + Jz SzSz] - hx sum Sx - hz sum Sz,
    spin-1/2 (S = sigma/2; the field convention is S too, unlike
    :func:`sparse_tfim`'s sigma fields).

    Bit-level construction: SxSx flips a pair with element 1/4; SySy flips
    a pair with element -(1/4) s_a s_b (each sigma^y contributes i on an
    up->down flip and -i on down->up, so the pair picks up +1 anti-aligned
    and -1 aligned); SzSz and Sz are diagonal. Cross-checked against a
    literal Kronecker-product build in tests/test_xyz.py.
    """
    dim = 1 << n
    s = _spins(n).astype(np.float64)
    states = np.arange(dim, dtype=np.int64)
    diag = np.zeros(dim, dtype=np.float64)
    rows, cols, vals = [states], [states], [diag]
    for (a, b) in np.asarray(bonds, dtype=np.int64):
        zz = s[:, a] * s[:, b]
        diag += (jz / 4.0) * zz
        rows.append(states)
        cols.append(states ^ ((1 << int(a)) | (1 << int(b))))
        vals.append((jx - jy * zz) / 4.0)
    if hz:
        diag -= (hz / 2.0) * s.sum(axis=1)
    if hx:
        for i in range(n):
            rows.append(states)
            cols.append(states ^ (1 << i))
            vals.append(np.full(dim, -hx / 2.0))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(dim, dim),
    )


def ground_energy(ham: sp.spmatrix) -> float:
    """Lowest eigenvalue via Lanczos (dense fallback for tiny systems)."""
    dim = ham.shape[0]
    if dim <= 256:
        return float(np.linalg.eigvalsh(ham.toarray())[0])
    return float(spla.eigsh(ham, k=1, which="SA", return_eigenvectors=False)[0])


def ground_state(ham: sp.spmatrix) -> tuple[float, np.ndarray]:
    """(E0, normalized ground-state vector)."""
    dim = ham.shape[0]
    if dim <= 256:
        w, v = np.linalg.eigh(ham.toarray())
        return float(w[0]), v[:, 0]
    w, v = spla.eigsh(ham, k=1, which="SA")
    return float(w[0]), v[:, 0]


def marshall_signs(n: int, sublattice_mask: np.ndarray) -> np.ndarray:
    """Diagonal of the Marshall basis rotation D for every basis state.

    D = diag((-1)^{# up spins on sublattice A}); the rotated Hamiltonian is
    D H D (D is its own inverse). Matches the sign convention applied to
    matrix elements in :mod:`qmcnn_tpu_torch.ops.hamiltonians` (SURVEY.md R4a).
    """
    s = _spins(n)
    n_up_a = ((s > 0) & (np.asarray(sublattice_mask)[None, :] == 0)).sum(axis=1)
    return np.where(n_up_a % 2 == 0, 1.0, -1.0)


def all_configs(n: int) -> np.ndarray:
    """[2^n, n] float32 array of all spin configurations, basis order."""
    return _spins(n).astype(np.float32)


def dense_from_hamiltonian(ham, dtype=np.complex128) -> np.ndarray:
    """Build the dense matrix implied by a Hamiltonian's connected()/diag().

    Test utility: enumerates all 2^N configurations and scatters the
    (s, s', mel) triples into a dense matrix. Cross-checked in tests against
    the independent bit-level builders above.
    """
    import torch

    n = ham.lattice.n_sites
    if n > 14:
        raise ValueError("dense_from_hamiltonian is a test utility for small N")
    configs = all_configs(n)
    dim = configs.shape[0]
    mat = np.zeros((dim, dim), dtype=dtype)
    s = torch.from_numpy(configs)
    diag = ham.diag_batch(s).numpy()
    mat[np.arange(dim), np.arange(dim)] = diag
    sp_, mel, mask = (x.numpy() for x in ham.connected_batch(s))  # [dim, K, n]
    # config -> basis index: bit i set iff s_i == +1
    weights = (1 << np.arange(n)).astype(np.int64)
    col_idx = (((sp_ > 0).astype(np.int64)) * weights).sum(axis=-1)  # [dim, K]
    # Convention: connected(s) yields (s', mel=<s|H|s'>) so that
    # E_loc(s) = diag(s) + sum_k mel_k * psi(s'_k)/psi(s). Row = s, col = s'.
    row_idx = np.broadcast_to(np.arange(dim)[:, None], col_idx.shape)
    np.add.at(mat, (row_idx[mask], col_idx[mask]), mel[mask])
    return mat
