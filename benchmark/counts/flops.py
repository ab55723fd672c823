"""The work of a step, counted from the configuration's shapes and from the
inputs, never from what the program launched: the same work reads the same
count whatever computes it. 2 FLOPs per multiply-add.

  * An evaluation forward of one configuration (:func:`forward_flop`): the
    convolutions of the real CNN; for the GCNN the least work of its group
    sums (the lift, 1 real product per part for the real input, and the
    group layers, 3 real products per complex multiply-add as Karatsuba
    takes them, plus 4 HW W additions), times 2 under the spin-flip
    projection, which evaluates s and -s.
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

#: order of C4v
G = 8


def _kernel(cfg: dict) -> int:
    k = min(int(cfg["model"]["kernel_size"]), *cfg["lattice"]["shape"])
    if cfg["model"]["kind"] == "gcnn" and k % 2 == 0:
        k -= 1
    return k


def n_sites(cfg: dict) -> int:
    return math.prod(int(v) for v in cfg["lattice"]["shape"])


def parts(cfg: dict) -> int:
    """1 for a real log psi, 2 for a complex one."""
    return 2 if cfg["model"]["complex_params"] else 1


def n_params(cfg: dict) -> int:
    m, k = cfg["model"], _kernel(cfg)
    chans = [int(c) for c in m["channels"]]
    p = 2 if m["complex_params"] else 1
    total, cin = 0, 1
    for i, c in enumerate(chans):
        if m["kind"] == "gcnn":
            total += p * ((k * k * cin * c if i == 0 else G * k * k * cin * c)
                          + c)
        else:
            total += p * (k * k * cin * c + c)
        cin = c
    return total


def gcnn_flop(hw: int, width: int, n_layers: int, cplx: bool, taps: int = 9
              ) -> float:
    """The least FLOPs of one configuration's group sums at ``width`` = G C
    expanded channels (the program's hand model, frozen here)."""
    lift = taps * hw * width * 2 * (2 if cplx else 1)
    group = taps * hw * width * width * 2 * (3 if cplx else 1)
    if cplx:
        group += 4 * hw * width
    return float(lift + (n_layers - 1) * group)


def forward_flop(cfg: dict) -> float:
    """FLOPs of one evaluation forward of one configuration."""
    m, k, n = cfg["model"], _kernel(cfg), n_sites(cfg)
    chans = [int(c) for c in m["channels"]]
    if m["kind"] == "cnn":
        cin, flop = 1, 0.0
        for c in chans:
            flop += 2.0 * n * k * k * cin * c * (2 if m["complex_params"]
                                                 else 1)
            cin = c
        return flop
    if m["kind"] == "gcnn":
        flop = gcnn_flop(n, G * chans[0], len(chans),
                         bool(m["complex_params"]), k * k)
        return flop * (2 if m["spin_flip_sector"] else 1)
    raise NotImplementedError(f"no count for model {m['kind']!r}")


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
