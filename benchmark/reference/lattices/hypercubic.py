"""The periodic square lattice (``lattice.geometry: hypercubic``, shape
[Lx, Ly]): site (x, y) is x * Ly + y; the nearest neighbours are the +x and
+y bonds of every site, the next-nearest the diagonals (1, +1) and (1, -1);
the two sublattices are (x + y) mod 2.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _sides(cfg: dict) -> Tuple[int, int]:
    lat = cfg["lattice"]
    if not lat["pbc"]:
        raise NotImplementedError("the reference lattice is the periodic "
                                  "square one")
    lx, ly = (int(v) for v in lat["shape"])
    return lx, ly


def _bonds(cfg: dict, offsets) -> np.ndarray:
    """[B, 2] int64: every site's bond along each offset, site by site."""
    lx, ly = _sides(cfg)

    def site(x, y):
        return (x % lx) * ly + (y % ly)

    return np.array([(site(x, y), site(x + dx, y + dy)) for x in range(lx)
                     for y in range(ly) for dx, dy in offsets],
                    dtype=np.int64).reshape(-1, 2)


def n_sites(cfg: dict) -> int:
    return math.prod(int(v) for v in cfg["lattice"]["shape"])


def nn(cfg: dict) -> np.ndarray:
    return _bonds(cfg, ((1, 0), (0, 1)))


def nnn(cfg: dict) -> np.ndarray:
    return _bonds(cfg, ((1, 1), (1, -1)))


def sublattice(cfg: dict) -> np.ndarray:
    lx, ly = _sides(cfg)
    return np.array([(p // ly + p % ly) % 2 for p in range(lx * ly)])
