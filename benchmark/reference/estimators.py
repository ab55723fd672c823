"""The estimators of one measured sample, written from their definitions,
on the walkers s [M, N] of a periodic square lattice (spin 1/2,
S^z = s / 2, sites x * Ly + y, sublattice (x + y) mod 2):

  * energy: the mean real E_loc;
  * magnetization: mean over walkers of (1/N) sum_i S^z_i;
  * mst2, mst4: the second and fourth moments of the staggered
    magnetization (1/N) sum_i (-1)^(x+y) S^z_i;
  * corr[r]: mean over walkers and sites of S^z_i S^z_(i+r), r indexing the
    displacements like the sites;
  * ss_nn: (1/N) sum_i <S_i . S_(i + x)>: the S^z S^z part from the
    walkers, the transverse part (1/2 the amplitude ratio of the swapped
    pair, anti-aligned pairs only, with the Marshall sign -1 across the
    sublattices) from the forward.

These are the square lattice's by definition: :func:`sample` refuses
another ``lattice.geometry``.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import files, hamiltonian, models


def square_only(cfg: dict) -> None:
    """Raise for a lattice other than the square one: the staggering and the
    +x neighbour are the square lattice's by definition."""
    geometry = files.geometry(cfg)
    if geometry != "hypercubic":
        raise NotImplementedError(
            f"the measured estimators (the (x + y) staggering, S.S to the +x "
            f"neighbour) are the square lattice's; lattice.geometry is "
            f"{geometry!r}")


def sample(cfg: dict, params, s: torch.Tensor, prec: str = "f32",
           block: int = 65536) -> Dict[str, torch.Tensor]:
    square_only(cfg)
    lx, ly = (int(v) for v in cfg["lattice"]["shape"])
    n = lx * ly
    sz = s / 2.0
    dev = s.device
    x = torch.arange(n, device=dev) // ly
    y = torch.arange(n, device=dev) % ly
    stag = (1.0 - 2.0 * ((x + y) % 2)).to(torch.float32)

    def fwd(t):
        return models.log_psi(cfg, params, t, prec)

    with torch.no_grad():
        lp = models.log_psi_blocks(cfg, params, s, prec, block)
        e_re, _ = hamiltonian.local_energy(cfg, fwd, s, lp, block)
        m_st = (sz * stag).mean(-1)
        grid = sz.reshape(-1, lx, ly)
        corr = torch.stack([
            (grid * torch.roll(grid, (int(r // ly), int(r % ly)),
                               dims=(1, 2))).mean()
            for r in range(n)])
        right = (((x + 1) % lx) * ly + y)
        zz = (sz * sz[:, right]).mean()
        walker, site = torch.nonzero(s * s[:, right] < 0, as_tuple=True)
        sign = -1.0 if cfg["hamiltonian"]["marshall"] else 1.0
        off = torch.zeros((), device=dev)
        for i in range(0, walker.numel(), block):
            w, a = walker[i:i + block], site[i:i + block]
            sp = s[w].clone()
            rows = torch.arange(w.numel(), device=dev)
            sp[rows, a] *= -1.0
            sp[rows, right[a]] *= -1.0
            re, im = fwd(sp)
            ratio = torch.exp(re - lp[0][w]) * torch.cos(im - lp[1][w])
            off = off + (sign * 0.5 * ratio).sum()
        ss_nn = zz + off / (n * s.shape[0])
    return {"energy": e_re.mean(), "magnetization": sz.mean(),
            "mst2": (m_st ** 2).mean(), "mst4": (m_st ** 4).mean(),
            "corr": corr, "ss_nn": ss_nn}
