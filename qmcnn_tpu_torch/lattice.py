"""Lattice geometry: site indexing, bond lists, sublattice masks.

Covers the geometry the reference supports (SURVEY.md R1): periodic chains
(N=16, N=40) and periodic square lattices (8x8, 10x10), with nearest-neighbor
(NN) and next-nearest-neighbor (NNN, diagonal) bonds for the J1-J2 model.
Beyond reference parity, ``geometry='triangular'`` embeds the triangular
lattice in the same LxL index grid (primitive vectors a1=(1,0),
a2=(1/2, sqrt(3)/2); grid offset (dx, dy) = dx*a1 + dy*a2), giving the
geometrically frustrated Heisenberg antiferromagnet without J2.

Everything here is static host-side numpy; consumers move the tables to
their device once. A copy of ``qmcnn_tpu/lattice.py`` (the port imports
nothing of the JAX package, whose ``__init__`` pulls in jax).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A hypercubic lattice with periodic boundary conditions.

    Sites are indexed row-major over ``shape``. Spin configurations are stored
    flat as ``s in {-1,+1}^n_sites``; models reshape to ``shape`` for convs.

    Args:
      shape: ``(N,)`` for a chain or ``(Lx, Ly)`` for a square lattice.
      pbc: periodic boundary conditions (the reference uses PBC everywhere).
    """

    shape: Tuple[int, ...]
    pbc: bool = True
    #: 'hypercubic' (chain / square; reference geometry), 'triangular'
    #: (2D only; 6 NN per site via the (1,0),(0,1),(1,-1) grid offsets),
    #: 'honeycomb' (2D; ``shape`` is the CELL grid of the 2-site-basis
    #: Bravais lattice, so n_sites = 2 * Lx * Ly; 3 NN per site, bipartite
    #: by basis index for ANY cell-grid size — the Marshall rule applies),
    #: or 'kagome' (2D; 3-site basis on the triangular Bravais lattice —
    #: basis A at 0, B at a1/2, C at a2/2; corner-sharing triangles, 4 NN
    #: per site, NEVER bipartite: the maximally frustrated 2D geometry)
    geometry: str = "hypercubic"

    def __post_init__(self):
        if len(self.shape) not in (1, 2):
            raise ValueError(f"only 1D/2D lattices supported, got {self.shape}")
        if any(L < 2 for L in self.shape):
            raise ValueError(f"each dimension must be >= 2, got {self.shape}")
        if self.geometry not in ("hypercubic", "triangular", "honeycomb",
                                 "kagome"):
            raise ValueError(f"unknown geometry {self.geometry!r}")
        if self.geometry in ("triangular", "honeycomb", "kagome") \
                and len(self.shape) != 2:
            raise ValueError(f"{self.geometry} geometry needs a 2D shape")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def basis(self) -> int:
        """Sites per unit cell (2 honeycomb, 3 kagome, 1 otherwise). Models
        consume ``shape`` as the conv grid and ``basis`` as input channels,
        so weight tying follows the true (cell) translation group."""
        return {"honeycomb": 2, "kagome": 3}.get(self.geometry, 1)

    @property
    def n_sites(self) -> int:
        return int(np.prod(self.shape)) * self.basis

    def site_index(self, coords) -> int:
        """Row-major flat index of a site given its lattice coordinates.

        Honeycomb: ``coords`` is (x, y, b) with b the basis index; flat
        index = (x * Ly + y) * 2 + b (cells row-major, basis fastest — the
        order models reshape to [B, Lx, Ly, basis])."""
        if self.basis > 1:
            *cell, b = coords
            cell_idx = int(np.ravel_multi_index(
                [c % L for c, L in zip(cell, self.shape)], self.shape))
            return cell_idx * self.basis + int(b) % self.basis
        return int(np.ravel_multi_index([c % L for c, L in zip(coords, self.shape)],
                                        self.shape))

    @cached_property
    def coords(self) -> np.ndarray:
        """[n_sites, ndim] integer coordinates of every site (honeycomb:
        [n_sites, ndim+1] with the basis index appended)."""
        if self.basis > 1:
            cells = np.stack(np.unravel_index(
                np.arange(int(np.prod(self.shape))), self.shape), axis=-1)
            cells = np.repeat(cells, self.basis, axis=0)
            b = np.tile(np.arange(self.basis), int(np.prod(self.shape)))
            return np.concatenate([cells, b[:, None]], axis=1)
        return np.stack(np.unravel_index(np.arange(self.n_sites), self.shape), axis=-1)

    @cached_property
    def site_positions(self) -> np.ndarray:
        """[n_sites, ndim] Cartesian positions of every site — the single
        owner of the geometric embedding the bond lists and triangles()
        orientations are written against.

        Chain/square use unit axis vectors. The triangular-Bravais
        geometries use a1 = (1, 0), a2 = (1/2, sqrt(3)/2) (this module's
        docstring convention) with the standard basis offsets: honeycomb B
        at (a1 + a2)/3, kagome B/C at a1/2, a2/2 — consistent with
        nn_bonds (every honeycomb NN bond length 1/sqrt(3), every kagome
        NN bond 1/2; pinned by tests/test_jastrow.py's shell oracles).
        """
        coords = self.coords.astype(np.float64)
        if self.geometry == "hypercubic":
            return coords
        a1 = np.array([1.0, 0.0])
        a2 = np.array([0.5, np.sqrt(3.0) / 2.0])
        cells = coords[:, 0:1] * a1 + coords[:, 1:2] * a2
        if self.geometry == "triangular":
            return cells
        if self.geometry == "honeycomb":
            offsets = np.stack([np.zeros(2), (a1 + a2) / 3.0])
        elif self.geometry == "kagome":
            offsets = np.stack([np.zeros(2), a1 / 2.0, a2 / 2.0])
        else:  # pragma: no cover - guarded by __post_init__
            raise ValueError(f"unknown geometry {self.geometry!r}")
        return cells + offsets[coords[:, -1].astype(int)]

    @cached_property
    def primitive_spans(self) -> list:
        """Cartesian torus translation vectors (one per periodic axis) —
        the minimal-image search vectors for Cartesian distances."""
        if self.ndim == 1:
            return [np.array([float(self.shape[0])])]
        if self.geometry == "hypercubic":
            return [self.shape[0] * np.array([1.0, 0.0]),
                    self.shape[1] * np.array([0.0, 1.0])]
        a1 = np.array([1.0, 0.0])
        a2 = np.array([0.5, np.sqrt(3.0) / 2.0])
        return [self.shape[0] * a1, self.shape[1] * a2]

    @cached_property
    def nn_bonds(self) -> np.ndarray:
        """Nearest-neighbor bonds as an [n_bonds, 2] int32 array of site pairs.

        Chain: (i, i+1) for all i (wrapping if pbc) -> N bonds (N-1 if open).
        Square: +x and +y neighbors -> 2*N bonds under PBC. Honeycomb:
        A(x,y) bonds to B at cells (x,y), (x-1,y), (x,y-1) -> 3 per cell
        (degree 3, always A-B). Each bond appears exactly once.
        """
        if self.geometry == "honeycomb":
            return self._basis_bonds(
                [(0, 1, (0, 0)), (0, 1, (-1, 0)), (0, 1, (0, -1))])
        if self.geometry == "kagome":
            # up-triangle (in-cell) + down-triangle (cross-cell) edges;
            # every site has degree 4 and every edge length a/2
            return self._basis_bonds(
                [(0, 1, (0, 0)), (0, 2, (0, 0)), (1, 2, (0, 0)),
                 (1, 0, (1, 0)), (2, 0, (0, 1)), (1, 2, (1, -1))])
        return self._bonds_for_offsets(self._nn_offsets())

    @cached_property
    def nnn_bonds(self) -> np.ndarray:
        """Next-nearest-neighbor bonds ([n, 2] int32).

        Chain: (i, i+2). Square: both diagonals (+x+y) and (+x-y) -> 2*N bonds
        under PBC. Honeycomb: the 6 same-sublattice neighbors per site (the
        underlying triangular cell lattice's NN shell). Used by the J1-J2
        model's J2 couplings.
        """
        if self.geometry == "honeycomb":
            return self._basis_bonds(
                [(b, b, off) for b in range(2)
                 for off in ((1, 0), (0, 1), (1, -1))])
        if self.geometry == "kagome":
            # the sqrt(3)/2 shell: 4 second neighbors per site, 6 per cell
            return self._basis_bonds(
                [(0, 1, (0, -1)), (0, 1, (-1, 1)),
                 (0, 2, (-1, 0)), (0, 2, (1, -1)),
                 (1, 2, (1, 0)), (1, 2, (0, -1))])
        return self._bonds_for_offsets(self._nnn_offsets())

    def _nn_offsets(self):
        if self.ndim == 1:
            return [(1,)]
        if self.geometry == "triangular":
            # a1, a2, a1 - a2: the three positive-direction unit bonds of
            # the triangular lattice in grid coordinates (6 NN per site)
            return [(1, 0), (0, 1), (1, -1)]
        return [(1, 0), (0, 1)]

    def _nnn_offsets(self):
        if self.ndim == 1:
            return [(2,)]
        if self.geometry == "triangular":
            # the sqrt(3)-shell: a1+a2, 2a1-a2, a1-2a2
            return [(1, 1), (2, -1), (1, -2)]
        return [(1, 1), (1, -1)]

    def _bonds_for_offsets(self, offsets) -> np.ndarray:
        bonds = []
        seen = set()
        for i in range(self.n_sites):
            ci = self.coords[i]
            for off in offsets:
                cj = ci + np.asarray(off)
                if not self.pbc and any(
                    c < 0 or c >= L for c, L in zip(cj, self.shape)
                ):
                    continue
                j = self.site_index(cj)
                if i == j:
                    continue  # wrap-around self-bond on tiny lattices
                key = (min(i, j), max(i, j), off)
                # With PBC on L=2 the +1 and -1 neighbors coincide; keep one
                # bond per (pair, offset) so couplings are not double counted
                # beyond what the physical lattice dictates.
                pair = (min(i, j), max(i, j))
                if pair in seen:
                    continue
                seen.add(pair)
                bonds.append((i, j))
        return np.asarray(bonds, dtype=np.int32).reshape(-1, 2)

    def _basis_bonds(self, triples) -> np.ndarray:
        """Bond list for a multi-site-basis lattice.

        ``triples`` is a list of (basis_a, basis_b, cell_offset): site
        (x, y, basis_a) bonds to ((x, y) + cell_offset, basis_b) in every
        cell. Same one-bond-per-pair dedup semantics as
        _bonds_for_offsets (L=2 wrap images collapse to one bond).
        """
        bonds = []
        seen = set()
        lx, ly = self.shape
        for x in range(lx):
            for y in range(ly):
                for ba, bb, off in triples:
                    cx, cy = x + off[0], y + off[1]
                    if not self.pbc and not (0 <= cx < lx and 0 <= cy < ly):
                        continue
                    i = self.site_index((x, y, ba))
                    j = self.site_index((cx, cy, bb))
                    if i == j:
                        continue  # wrap self-bond on L=2 intra shells
                    pair = (min(i, j), max(i, j))
                    if pair in seen:
                        continue
                    seen.add(pair)
                    bonds.append(pair)
        return np.asarray(bonds, dtype=np.int32).reshape(-1, 2)

    @cached_property
    def triangles(self) -> np.ndarray:
        """[n_triangles, 3] site triples of all elementary NN triangles,
        each ordered COUNTERCLOCKWISE in Cartesian coordinates (a1=(1,0),
        a2=(1/2, sqrt(3)/2)) — the orientation convention the scalar spin
        chirality <S_i . (S_j x S_k)> needs to be summed consistently.

        Triangular: 2 per cell — up (v, v+a1, v+a2) and down
        (v+a1, v+a1+a2, v+a2). Kagome: 2 per cell — up (A, B, C) in-cell
        and down (B(x,y), C(x+1,y-1), A(x+1,y)). Other geometries have no
        elementary triangles (bipartite NN graphs) and raise.
        """
        if self.geometry == "triangular":
            tris = []
            for x in range(self.shape[0]):
                for y in range(self.shape[1]):
                    tris.append((self.site_index((x, y)),
                                 self.site_index((x + 1, y)),
                                 self.site_index((x, y + 1))))
                    tris.append((self.site_index((x + 1, y)),
                                 self.site_index((x + 1, y + 1)),
                                 self.site_index((x, y + 1))))
            return np.asarray(tris, np.int32)
        if self.geometry == "kagome":
            tris = []
            for x in range(self.shape[0]):
                for y in range(self.shape[1]):
                    tris.append((self.site_index((x, y, 0)),
                                 self.site_index((x, y, 1)),
                                 self.site_index((x, y, 2))))
                    tris.append((self.site_index((x, y, 1)),
                                 self.site_index((x + 1, y - 1, 2)),
                                 self.site_index((x + 1, y, 0))))
            return np.asarray(tris, np.int32)
        raise ValueError(f"geometry {self.geometry!r} has no elementary "
                         "NN triangles (bipartite NN graph)")

    @cached_property
    def sublattice_mask(self) -> np.ndarray:
        """[n_sites] int32 in {0,1}: bipartite A/B mask.

        Hypercubic: checkerboard (coordinate-sum parity); meaningful when
        all dims are even (true for all reference configs: 16, 40, 8x8,
        10x10). Multi-site basis: the basis index — a valid 2-coloring
        only when the lattice is bipartite BY basis (honeycomb; kagome's
        triangles admit no 2-coloring and is_bipartite_compatible guards
        every use). Used by the Marshall sign rule (SURVEY.md R4a).
        """
        if self.basis > 1:
            return (self.coords[:, -1] % 2).astype(np.int32)
        return (self.coords.sum(axis=1) % 2).astype(np.int32)

    @cached_property
    def three_coloring(self) -> np.ndarray:
        """[n_sites] int32 in {0,1,2}: proper 3-coloring of the NN graph.

        The sublattice structure of the classical 120-degree Neel order on
        geometrically frustrated lattices — the 3-sublattice analogue of
        :attr:`sublattice_mask` (Marshall). Used by the ``sublattice_120``
        phase bias (Huse-Elser; see models/phase.py).

        Triangular: color = (x - y) mod 3 — every NN offset (1,0), (0,1),
        (1,-1) changes it by a nonzero amount mod 3; under PBC both
        dimensions must be divisible by 3 for the coloring to close around
        the torus. Kagome: the basis index (the q=0 ordering pattern —
        every corner-sharing triangle carries all three colors). Bipartite
        geometries have no frustrated 3-sublattice order; use
        :attr:`sublattice_mask` / the Marshall rule there instead.
        """
        if self.geometry == "triangular":
            if self.pbc and any(L % 3 for L in self.shape):
                raise ValueError(
                    "a periodic triangular lattice is 3-colorable only "
                    "when both dimensions are divisible by 3 (the (x-y) "
                    f"mod 3 coloring must close around the torus); got "
                    f"shape={self.shape}")
            c = (self.coords[:, 0] - self.coords[:, 1]) % 3
        elif self.geometry == "kagome":
            c = self.coords[:, -1] % 3
        else:
            raise ValueError(
                f"geometry {self.geometry!r} has no frustrated 3-sublattice "
                "structure — for bipartite lattices use sublattice_mask "
                "(Marshall) instead")
        c = c.astype(np.int32)
        i, j = self.nn_bonds[:, 0], self.nn_bonds[:, 1]
        if not np.all(c[i] != c[j]):  # pragma: no cover - construction guard
            raise AssertionError("internal error: 3-coloring is not proper "
                                 "on the NN graph")
        return c

    @cached_property
    def three_coloring_sqrt3(self) -> np.ndarray:
        """[n_sites] int32 in {0,1,2}: the sqrt(3) x sqrt(3) 3-coloring of
        the kagome NN graph.

        The kagome AF has TWO competing classical 120-degree patterns:
        q=0 (color = basis index; :attr:`three_coloring`) and the
        sqrt(3) x sqrt(3) order whose magnetic cell is three crystal
        cells: c = (basis + y - x) mod 3. Every NN bond changes c
        (intra-cell bonds differ by basis; the inter-cell bonds
        (1,0,(1,0)), (2,0,(0,1)), (1,2,(1,-1)) shift by the cell offset),
        and the pattern closes on the torus only when BOTH cell dims are
        divisible by 3 — which is exactly why the 18-site 2x3-cell gate
        could never host it (BASELINE.md r2 kagome rows).

        On the triangular lattice the (x-y) mod 3 coloring already IS the
        sqrt(3) x sqrt(3) pattern (one crystal site per cell), so this
        property is kagome-only.
        """
        if self.geometry != "kagome":
            raise ValueError(
                "sqrt3 coloring is kagome-only (on triangular, "
                "three_coloring already is the sqrt(3) pattern); got "
                f"geometry={self.geometry!r}")
        if self.pbc and any(L % 3 for L in self.shape):
            raise ValueError(
                "the sqrt(3) x sqrt(3) kagome pattern closes around the "
                "torus only when both cell dimensions are divisible by 3; "
                f"got shape={self.shape}")
        x, y, b = (self.coords[:, 0], self.coords[:, 1],
                   self.coords[:, 2])
        c = ((b + y - x) % 3).astype(np.int32)
        i, j = self.nn_bonds[:, 0], self.nn_bonds[:, 1]
        if not np.all(c[i] != c[j]):  # pragma: no cover - construction guard
            raise AssertionError("internal error: sqrt3 coloring is not "
                                 "proper on the NN graph")
        return c

    @cached_property
    def is_bipartite_compatible(self) -> bool:
        """True if the NN graph is two-colorable by sublattice_mask.

        Triangular and kagome lattices contain odd cycles (triangles) and
        are never bipartite; honeycomb is bipartite by basis for any size;
        hypercubic lattices additionally need even dims under PBC so the
        wrap preserves the coloring.
        """
        if self.geometry in ("triangular", "kagome"):
            return False
        if self.geometry == "honeycomb":
            return True
        return all(L % 2 == 0 for L in self.shape) or not self.pbc


def chain(n: int, pbc: bool = True) -> Lattice:
    return Lattice((n,), pbc=pbc)


def square(lx: int, ly: int | None = None, pbc: bool = True) -> Lattice:
    return Lattice((lx, ly if ly is not None else lx), pbc=pbc)


def triangular(lx: int, ly: int | None = None, pbc: bool = True) -> Lattice:
    return Lattice((lx, ly if ly is not None else lx), pbc=pbc,
                   geometry="triangular")


def honeycomb(lx: int, ly: int | None = None, pbc: bool = True) -> Lattice:
    """Honeycomb with an (lx, ly) CELL grid: n_sites = 2 * lx * ly."""
    return Lattice((lx, ly if ly is not None else lx), pbc=pbc,
                   geometry="honeycomb")


def kagome(lx: int, ly: int | None = None, pbc: bool = True) -> Lattice:
    """Kagome with an (lx, ly) CELL grid: n_sites = 3 * lx * ly."""
    return Lattice((lx, ly if ly is not None else lx), pbc=pbc,
                   geometry="kagome")
