"""D6-equivariant GCNN for the triangular lattice, space group p6m (port of
``qmcnn_tpu/models/tgcnn.py``).

The triangular lattice is embedded in the L x L index grid: grid coords
(m, n) are the displacement m*a1 + n*a2 (a1, a2 at 60 degrees). The
60-degree rotation maps (m, n) -> (-n, m + n) and the mirror that swaps
the primitive vectors maps (m, n) -> (n, m); both are integer unimodular
maps, so they act on a square torus and a conv with (g.w)[o] = w[g^-1 o]
is equivariant. Features carry the regular representation of D6 (12
elements), and a character-projected readout makes log psi symmetric under
all of p6m in one forward.

Kernels live on hexagonal stars (unions of D6 orbits of offsets): radius 1
is 7 taps in a 3x3 grid, radius 2 is 19 taps in a 5x5 grid. Parameters are
star-tap indexed (``kernel_re`` is ``[T, Cin, C]`` for the lift layer and
``[G, T, Cin, C]`` after it, the Flax layouts); the expanded kernel is the
square GCNN's gather (``models/gcnn.py``: ``_lift_kernel``,
``_group_kernel``) over a grid kernel with zeros off the star, and each
layer one dense circular convolution (``conv_expanded``). Stack and
readout are the square GCNN's (``LogPsiGCNN``), with G = 12; in bf16 the
activations round as the JAX triangular model's do
(:func:`activations_in_dtype`).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from qmcnn_tpu_torch.models.gcnn import (GroupConv, LogPsiGCNN, _group_kernel,
                                         _lift_kernel)
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

#: D6 one-dimensional irrep characters on the generators (R = 60 degree
#: rotation, M = a1 <-> a2 mirror)
_CHARACTERS = {
    "A1": (1, 1),
    "A2": (1, -1),
    "B1": (-1, 1),
    "B2": (-1, -1),
}

#: star shells by radius: one D6 orbit seed each
_SHELL_SEEDS = {
    1: [(0, 0), (1, 0)],
    2: [(0, 0), (1, 0), (1, 1), (2, 0)],
}


@functools.lru_cache(maxsize=None)
def d6_tables(radius: int) -> tuple:
    """Group tables for D6 acting on the hexagonal star of ``radius``, the
    same arrays as the JAX function: (G, offsets [T, 2], inv [G],
    elem_idx [G, G] (index of g^-1 h), tap_perm [G, T] ((g.w)[t] =
    w[tap_perm[g, t]]), chars {irrep: [G]}, mats [G, 2, 2]); element
    g = R^r M^m with r in 0..5 fastest."""
    if radius not in _SHELL_SEEDS:
        raise ValueError(f"tgcnn radius must be one of "
                         f"{sorted(_SHELL_SEEDS)}, got {radius}")
    R = np.array([[0, -1], [1, 1]])   # (m, n) -> (-n, m + n)
    M = np.array([[0, 1], [1, 0]])    # (m, n) -> (n, m)
    mats, words = [], []
    for m in range(2):
        for r in range(6):
            mats.append(np.linalg.matrix_power(R, r)
                        @ np.linalg.matrix_power(M, m))
            words.append((r, m))
    G = len(mats)

    def find(mat) -> int:
        for i, m_ in enumerate(mats):
            if np.array_equal(m_, mat):
                return i
        raise AssertionError("D6 not closed under composition")

    inv = np.array([find(np.round(np.linalg.inv(m)).astype(int))
                    for m in mats])
    elem_idx = np.array([[find(mats[inv[g]] @ mats[h]) for h in range(G)]
                         for g in range(G)])
    offs: list = []
    seen = set()
    for seed in _SHELL_SEEDS[radius]:
        for g in mats:
            o = tuple(g @ np.asarray(seed))
            if o not in seen:
                seen.add(o)
                offs.append(o)
    off_index = {o: t for t, o in enumerate(offs)}
    tap_perm = np.zeros((G, len(offs)), np.int32)
    for g in range(G):
        gi = mats[inv[g]]
        for t, o in enumerate(offs):
            tap_perm[g, t] = off_index[tuple(gi @ np.asarray(o))]
    chars = {
        name: np.array([cr ** r * cm ** m for (r, m) in words], np.float32)
        for name, (cr, cm) in _CHARACTERS.items()
    }
    return (G, np.asarray(offs, np.int32), inv, elem_idx, tap_perm, chars,
            np.asarray(mats, np.int32))


def d6_site_perms(lattice_shape: Tuple[int, int]) -> np.ndarray:
    """[G, N] site permutations on the torus: (g.s)[p] = s[perm[g, p]]
    (perm[g, p] = flat index of g^-1 p mod L). A test helper."""
    lx, ly = lattice_shape
    if lx != ly:
        raise ValueError("D6 point-group action needs a square torus "
                         f"(got {lattice_shape})")
    G, _, inv, _, _, _, mats = d6_tables(1)
    coords = np.stack(np.meshgrid(np.arange(lx), np.arange(ly),
                                  indexing="ij"), -1).reshape(-1, 2)
    perms = np.zeros((G, lx * ly), np.int64)
    for g in range(G):
        src = (coords @ mats[inv[g]].T) % np.array([lx, ly])
        perms[g] = src[:, 0] * ly + src[:, 1]
    return perms


@functools.lru_cache(maxsize=None)
def star_grid_tables(radius: int) -> tuple:
    """The star on its enclosing k x k grid (k = 2 radius + 1, row-major
    taps at offset (i - radius, j - radius)): (k, star_of [k*k], the star
    tap at each grid tap or T off the star; grid_perm [G, k*k], the D6 tap
    permutation over grid taps, off-star taps sent to a fixed off-star
    tap, where a grid kernel is zero)."""
    _, offsets, _, _, tap_perm, _, _ = d6_tables(radius)
    T = len(offsets)
    k = 2 * radius + 1
    pos = (offsets[:, 0] + radius) * k + (offsets[:, 1] + radius)
    star_of = np.full(k * k, T, np.int64)
    star_of[pos] = np.arange(T)
    zero = int(np.flatnonzero(star_of == T)[0])
    grid_perm = np.full((tap_perm.shape[0], k * k), zero, np.int32)
    grid_perm[:, pos] = pos[tap_perm]
    return k, star_of, grid_perm


def star_to_grid(w: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Star-tap axis ``axis`` of ``w`` -> (k, k) grid axes, zeros off the
    star."""
    k, star_of, _ = star_grid_tables(radius)
    pad = torch.zeros_like(w.narrow(axis, 0, 1))
    idx = torch.as_tensor(star_of, device=w.device)
    grid = torch.cat([w, pad], dim=axis).index_select(axis, idx)
    return grid.reshape(*w.shape[:axis], k, k, *w.shape[axis + 1:])


class TriGroupConv(GroupConv):
    """One D6-equivariant layer: lifting (lift=True) or group conv, over a
    hexagonal star kernel of radius (kernel_size - 1) / 2."""

    G = 12

    @property
    def radius(self) -> int:
        return (self.k - 1) // 2

    def base_shape(self, cin: int, cout: int) -> Tuple[int, ...]:
        T = len(d6_tables(self.radius)[1])
        return (T, cin, cout) if self.lift else (self.G, T, cin, cout)

    def expand(self, w: torch.Tensor) -> torch.Tensor:
        _, _, _, elem_idx, _, _, _ = d6_tables(self.radius)
        _, _, grid_perm = star_grid_tables(self.radius)
        if self.lift:
            return _lift_kernel(star_to_grid(w, self.radius, 0), grid_perm,
                                self.k)
        return _group_kernel(star_to_grid(w, self.radius, 1), elem_idx,
                             grid_perm, self.k)


class LogPsiTriGCNN(LogPsiGCNN):
    """log psi(s) with exact p6m symmetry (translations x D6) on the
    triangular torus; square shapes only. Same fields as the JAX model.

    For the sign characters (A2/B1/B2) a shallow stack gives a near-null
    state (the character sum cancels to f32 rounding residue, as in the
    JAX model): use 3 layers or more there."""

    G = 12
    layer = "TriGroupConv"

    def __init__(self, lattice_shape: Tuple[int, ...],
                 channels: Sequence[int] = (8, 8), radius: int = 1,
                 complex_params: bool = False, param_scale: float = 0.05,
                 character: str = "A1", init_mode: str = "fixed",
                 activation: str = "lncosh", residual: bool = False,
                 compute_dtype: str = "float32"):
        if len(lattice_shape) != 2 or lattice_shape[0] != lattice_shape[1]:
            raise ValueError("LogPsiTriGCNN needs a square 2D torus, got "
                             f"{tuple(lattice_shape)}")
        if character not in _CHARACTERS:
            raise ValueError(f"unknown D6 character {character!r}; pick "
                             f"one of {sorted(_CHARACTERS)}")
        d6_tables(radius)  # a known radius
        if 2 * radius + 1 > min(lattice_shape):
            raise ValueError(f"radius {radius} star exceeds the lattice "
                             f"{tuple(lattice_shape)}")
        super().__init__(lattice_shape, channels, 2 * radius + 1,
                         complex_params=complex_params,
                         param_scale=param_scale, character=character,
                         init_mode=init_mode, activation=activation,
                         residual=residual, compute_dtype=compute_dtype)

    def _kernel(self, kernel_size: int) -> int:
        return kernel_size

    def _taps(self) -> int:
        return len(d6_tables((self.k - 1) // 2)[1])

    def _new_layer(self, cin: int, c: int, **kw) -> nn.Module:
        return TriGroupConv(cin, c, self.k, **kw)

    def _characters(self) -> dict:
        return d6_tables((self.k - 1) // 2)[5]

    def _activations(self):
        return activations_in_dtype(self.activation, self.dtype)


#: SELU's constants (jax.nn.selu, torch.nn.functional.selu)
_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def activations_in_dtype(name: str, dtype: torch.dtype):
    """(complex, real) activation of ``name`` computed in ``dtype`` as the
    JAX triangular GCNN applies it to a bf16 stack: op by op, each result
    rounded to ``dtype``, with its float constants rounded to ``dtype``
    first (XLA's weak-typed Python floats). The square GCNN computes its
    activations in f32 and rounds once (``models.cnn.activations``)."""
    if dtype == torch.float32:
        return cplx.ACTIVATIONS[name]

    def const(v: float) -> float:
        return float(torch.tensor(v, dtype=dtype))

    if name == "selu":
        scale, alpha = const(_SELU_SCALE), const(_SELU_ALPHA)

        def real(x):
            return scale * torch.where(x > 0, x, alpha * torch.expm1(x))

        return (lambda z: C(real(z.re), real(z.im))), real
    if name == "lncosh":
        log2 = const(cplx.LOG2)
        return (functools.partial(cplx.lncosh, log2=log2),
                functools.partial(cplx.lncosh_real, log2=log2))
    raise KeyError(name)
