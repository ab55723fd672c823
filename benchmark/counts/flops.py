"""The work of a step, counted from the configuration's shapes and from the
inputs, never from what the program launched: the same work reads the same
count whatever computes it. 2 FLOPs per multiply-add.

  * An evaluation forward of one configuration (:func:`forward_flop`): the
    least work of the model's forward, counted by its kind's file
    (``reference/kinds/<kind>.py``, or ``<kind>_<geometry>.py`` off the
    hypercubic lattice): the convolutions of the real CNN; for the GCNN
    its group sums, times 2 under the spin-flip projection.
  * A sweep proposal that changes the walker is one forward; an exchange
    proposal on an aligned bond is the identity and needs none.
  * An E_loc row is one anti-aligned bond of a walker: a bond whose spins
    agree has no element and needs no forward (the diagonal is counted
    as nothing).
  * The surrogate gradient: a forward and a backward (2 forwards) per
    walker; the score Jacobian: a forward and a backward per part.
  * SR: ``pcg`` takes 2 [M, P] products per part per iteration (4 M P
    parts); ``minsr`` the Gram of the R = parts M score rows (2 R^2 P), its
    solve (R^3 / 3) and the update (2 R P).

An algorithm that needs less work than this for the same result (K1 updating
only the receptive field of the swapped spins, say) needs a recount here.
"""
from __future__ import annotations

import math

from benchmark.reference import hamiltonian, models


def n_sites(cfg: dict) -> int:
    return int(hamiltonian.lattice(cfg).n_sites(cfg))


def parts(cfg: dict) -> int:
    """1 for a real log psi, 2 for a complex one."""
    return 2 if cfg["model"]["complex_params"] else 1


def n_params(cfg: dict) -> int:
    """The entries of the kind's parameter layout."""
    return sum(math.prod(shape)
               for shape, _ in models.param_layout(cfg).values())


def forward_flop(cfg: dict) -> float:
    """FLOPs of one evaluation forward of one configuration."""
    return float(models.kind_of(cfg).forward_flop(cfg))


def forward_bytes(cfg: dict) -> float:
    """Bytes an evaluation forward must move per configuration: its spins
    in (float32) and its log psi out (re, im)."""
    return 4.0 * n_sites(cfg) + 8.0


def eval_rows(m: int, sweep_rows: float, e_loc_rows: float) -> float:
    """Evaluation forwards of a step: the refresh of the m walkers, the
    sweep's changing proposals and the E_loc rows."""
    return m + sweep_rows + e_loc_rows


def step_flop(cfg: dict, m: int, sweep_rows: float, e_loc_rows: float,
              sr_iters: float) -> float:
    """FLOPs of one training step over m walkers."""
    fwd, p, n_par = forward_flop(cfg), parts(cfg), n_params(cfg)
    flop = eval_rows(m, sweep_rows, e_loc_rows) * fwd
    flop += 3.0 * m * fwd                     # surrogate gradient
    flop += (1.0 + 2.0 * p) * m * fwd         # score Jacobian
    solver = cfg["sr"]["solver"] if cfg["sr"]["enabled"] else None
    if solver == "pcg":
        flop += sr_iters * 4.0 * p * m * n_par
    elif solver == "minsr":
        r = p * m
        flop += 2.0 * r * r * n_par + r ** 3 / 3.0 + 2.0 * r * n_par
    return flop
