"""Bethe-ansatz ground energy of the finite periodic spin-1/2 XXX chain (the
port's own copy of ``qmcnn_tpu/ops/bethe.py``; numpy only).

BASELINE config 2 (Heisenberg chain N=40) sits beyond exact diagonalization;
its exact finite-size ground energy is available from the Bethe ansatz. For
the ground state (S^z = 0, real roots), the Bethe equations in logarithmic
form are

    N * theta_1(x_j) = 2 pi I_j + sum_k theta_2(x_j - x_k),
    theta_n(x) = 2 atan(2 x / n),

with half-odd quantum numbers I_j = j - (M+1)/2 + 1/2 ... i.e. the M = N/2
consecutive values centered on zero. The energy of H = J sum S_i . S_j is

    E = J N / 4 - J sum_j 2 / (4 x_j^2 + 1).

Solved by damped fixed-point iteration; validated against exact
diagonalization for small N in the tests (which pins every convention),
then trusted at N = 40, beyond exact diagonalization
(E/N -> 1/4 - ln 2 = -0.4431471... as N -> inf).
"""
from __future__ import annotations

import numpy as np


def bethe_roots(n: int, tol: float = 1e-13, max_iter: int = 20000,
                damping: float = 0.5) -> np.ndarray:
    """Real Bethe roots of the N-site ground state (N even)."""
    if n % 2:
        raise ValueError("N must be even")
    m = n // 2
    # quantum numbers: M consecutive (half-)integers centered on 0
    i_j = np.arange(m) - (m - 1) / 2.0
    x = np.tan(np.pi * i_j / n)  # free-fermion-ish initial guess

    for _ in range(max_iter):
        # x_j = (1/2) tan( (2 pi I_j + sum_k theta_2(x_j - x_k)) / (2 N) )
        diff = x[:, None] - x[None, :]
        theta2 = 2.0 * np.arctan(diff)
        np.fill_diagonal(theta2, 0.0)
        rhs = (2.0 * np.pi * i_j + theta2.sum(axis=1)) / (2.0 * n)
        x_new = 0.5 * np.tan(rhs)
        step = x_new - x
        x = x + damping * step
        if np.max(np.abs(step)) < tol:
            break
    else:
        raise RuntimeError(f"Bethe iteration did not converge for N={n}")
    return x


def ground_energy(n: int, j: float = 1.0) -> float:
    """Exact ground energy of H = J sum_<i,i+1> S_i . S_j, PBC, N even."""
    x = bethe_roots(n)
    return float(j * (n / 4.0 - np.sum(2.0 / (4.0 * x * x + 1.0))))


def energy_per_site_infinite(j: float = 1.0) -> float:
    """Thermodynamic limit: e = J (1/4 - ln 2)."""
    return float(j * (0.25 - np.log(2.0)))
