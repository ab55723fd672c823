"""The periodic triangular lattice (``lattice.geometry: triangular``, shape
[L1, L2]), from its definition: the primitive vectors a1 = (1, 0) and
a2 = (1/2, sqrt(3)/2); the site at grid coordinates (m, n), at m a1 + n a2,
is m * L2 + n.

  * nearest neighbours (distance 1): a1, a2 and a1 - a2 from every site,
    six a site;
  * the sqrt(3) shell: a1 + a2, 2 a1 - a2 and a1 - 2 a2, six a site.

Bonds are listed site by site, each site's in the order of its shell's
vectors. On a small torus two vectors of a shell can join the same pair (on
a side of 3, a1 + a2 and a1 - 2 a2 reach the same site): a shell joins each
pair once, and no site to itself. Three sites around every triangle leave
no two sublattices, so there is no Marshall sign.
"""
from __future__ import annotations

import math

import numpy as np

NN = ((1, 0), (0, 1), (1, -1))
NNN = ((1, 1), (2, -1), (1, -2))


def _bonds(cfg: dict, offsets) -> np.ndarray:
    """[B, 2] int64: the shell of ``offsets``, each unordered pair once."""
    lat = cfg["lattice"]
    if not lat["pbc"]:
        raise NotImplementedError("the reference triangular lattice is the "
                                  "periodic one")
    l1, l2 = (int(v) for v in lat["shape"])
    out, seen = [], set()
    for m in range(l1):
        for n in range(l2):
            i = m * l2 + n
            for dm, dn in offsets:
                j = ((m + dm) % l1) * l2 + (n + dn) % l2
                pair = (min(i, j), max(i, j))
                if i == j or pair in seen:
                    continue
                seen.add(pair)
                out.append((i, j))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def n_sites(cfg: dict) -> int:
    return math.prod(int(v) for v in cfg["lattice"]["shape"])


def nn(cfg: dict) -> np.ndarray:
    return _bonds(cfg, NN)


def nnn(cfg: dict) -> np.ndarray:
    return _bonds(cfg, NNN)


def sublattice(cfg: dict) -> None:
    return None
