"""The Heisenberg and J1-J2 Hamiltonians on a periodic lattice, and the
local energy, written from their definitions (spin 1/2, S = sigma / 2):

  H = sum_<ij> J [S_i . S_j] + sum_<<ij>> J2 [S_i . S_j],

so each bond adds (J_b / 4) s_i s_j on the diagonal and, where its spins
are anti-aligned, J_b / 2 times the amplitude of the configuration with
the two spins swapped. The Marshall rotation turns the sign of every
element across the two sublattices (the nearest-neighbour ones).

E_loc(s) = diag(s) + sum_b mel_b psi(s^b) / psi(s), summed over the
anti-aligned bonds only: a bond whose spins agree has no element.

The lattice is a file of its own, ``lattices/<lattice.geometry>.py`` beside
this one (``files.py``), loaded by :func:`lattice`; it imports nothing of
the program and defines, from the configuration's ``lattice`` section,

  * ``n_sites(cfg) -> int``;
  * ``nn(cfg)``, ``nnn(cfg)``: the nearest and next-nearest bonds, [B, 2]
    int64 site pairs in the program's site order;
  * ``sublattice(cfg)``: [N] 0/1 of a bipartite lattice, or None.

A new geometry is a new file there; nothing here changes.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

from benchmark.reference import files

#: the geometry files
LATTICES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lattices")


@functools.cache
def _lattice_file(name: str):
    return files.load(os.path.join(LATTICES, f"{name}.py"),
                      f"benchmark_lattice_{name}")


def lattice(cfg: dict):
    """The module of the configuration's geometry file, loaded by path once
    a process; a geometry with no file raises, naming it."""
    name = files.geometry(cfg)
    if not os.path.exists(os.path.join(LATTICES, f"{name}.py")):
        raise FileNotFoundError(
            f"no reference lattice for geometry {name!r}: "
            f"{files.lattice_path(cfg)} (its sites, bonds and sublattices) "
            f"is missing")
    return _lattice_file(name)


def bonds(cfg: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pairs [B, 2], diagonal coupling [B], off-diagonal element [B]) of
    the configured Hamiltonian: the geometry's nearest-neighbour bonds,
    then (with J2) its next-nearest ones."""
    h = cfg["hamiltonian"]
    geo = lattice(cfg)
    if h["kind"] not in ("heisenberg", "j1j2"):
        raise NotImplementedError(f"no reference for {h['kind']!r}")
    nn = geo.nn(cfg)
    j2 = float(h["j2"]) if h["kind"] == "j1j2" else 0.0
    pairs = np.concatenate([nn, geo.nnn(cfg)] if j2 else [nn])
    coupling = np.array([h["j"]] * len(nn) + [j2] * (len(pairs) - len(nn)),
                        np.float64)
    sign = np.ones(len(pairs))
    if h["marshall"]:
        sub = geo.sublattice(cfg)
        if sub is None:
            raise ValueError(
                f"marshall: true needs two sublattices; the "
                f"{files.geometry(cfg)!r} lattice has none")
        sign = np.where(sub[pairs[:, 0]] != sub[pairs[:, 1]], -1.0, 1.0)
    diag = float(h["delta"]) * coupling / 4.0
    return pairs, diag.astype(np.float32), (sign * coupling / 2.0).astype(
        np.float32)


def anti_aligned(s: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """[M, B] bool: the bond's spins disagree."""
    return s[:, pairs[:, 0]] * s[:, pairs[:, 1]] < 0


def local_energy(cfg: dict, log_psi_fn, s: torch.Tensor,
                 lp: Tuple[torch.Tensor, torch.Tensor],
                 block: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) E_loc [M] of walkers s [M, N] whose log psi is ``lp``;
    ``log_psi_fn(s') -> (re, im)`` evaluates the swapped configurations,
    which are formed for the anti-aligned bonds only, in blocks of
    ``block`` rows."""
    pairs_np, diag_np, mel_np = bonds(cfg)
    dev = s.device
    pairs = torch.as_tensor(pairs_np, device=dev)
    diag_c = torch.as_tensor(diag_np, device=dev)
    mel = torch.as_tensor(mel_np, device=dev)
    zz = s[:, pairs[:, 0]] * s[:, pairs[:, 1]]
    diag = (zz * diag_c).sum(-1)
    walker, bond = torch.nonzero(zz < 0, as_tuple=True)
    off_re = torch.zeros(s.shape[0], device=dev)
    off_im = torch.zeros(s.shape[0], device=dev)
    for i in range(0, walker.numel(), block):
        w, b = walker[i:i + block], bond[i:i + block]
        sp = s[w].clone()
        rows = torch.arange(w.numel(), device=dev)
        sp[rows, pairs[b, 0]] *= -1.0
        sp[rows, pairs[b, 1]] *= -1.0
        re, im = log_psi_fn(sp)
        amp = torch.exp(re - lp[0][w])
        phase = im - lp[1][w]
        off_re.index_add_(0, w, mel[b] * amp * torch.cos(phase))
        off_im.index_add_(0, w, mel[b] * amp * torch.sin(phase))
    return diag + off_re, off_im


def nonzero_rows(cfg: dict, s: torch.Tensor) -> torch.Tensor:
    """0-d int64 tensor: the E_loc rows that carry an element in walkers
    s [M, N] (one per anti-aligned bond)."""
    pairs = torch.as_tensor(bonds(cfg)[0], device=s.device)
    return anti_aligned(s, pairs).sum()
