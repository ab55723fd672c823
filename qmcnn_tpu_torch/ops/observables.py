"""Measurement estimators beyond the energy (port of
``qmcnn_tpu/ops/observables.py``).

Diagonal observables (magnetizations, S^z correlations, dimer fields)
come from the walker configurations alone; off-diagonal ones (the
transverse spin-spin correlation, the scalar chirality, the total spin,
the Renyi-2 swap and the momentum-sector ratio) from amplitude ratios.
All but the Renyi-2 swap are connected sums, taken by the local energy's
``ops/local_energy.connected_sum`` over its ``over_walker_chunks``, so
they forward only the connected rows that carry an element. Their
forwards run through whatever ``log_psi_fn`` the caller passes
(``measure.py`` passes ``VMC.eval_log_psi_fn``, so the fused kernels serve
them on CUDA). Every device mean goes through
``vmc.pmean(x, group)`` (JAX: ``pmean(x, axis_name)``), so the estimators
reduce over a walker group as the energy does. The host-side functions
(structure factors, the correlation length, the Binder cumulant, the
sector jackknife) take and return numpy, as in JAX.

The off-diagonal estimators take no gradient: they run under
``torch.no_grad()``. A ``connected_fn`` is batched here,
``s [M, N] -> (s' [M, K, N], coeff [K] or [M, K], mask [M, K])``, where
JAX's maps one configuration and is vmapped.

Conventions: spin-1/2, S^z_i = s_i / 2 with s in {-1, +1}.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import connected_sum, over_walker_chunks
from qmcnn_tpu_torch.vmc import pmean


def magnetization(s: torch.Tensor, group=None) -> torch.Tensor:
    """<M_z> = <sum_i S^z_i> / N per site, averaged over walkers."""
    m = (s / 2.0).mean(dim=-1)
    return pmean(m.mean(), group)


def magnetization_sq(s: torch.Tensor, group=None) -> torch.Tensor:
    """<M_z^2> per site^2."""
    m = (s / 2.0).mean(dim=-1)
    return pmean((m * m).mean(), group)


def _require_site_grid(lattice: Lattice, what: str) -> None:
    """Displacement-indexed estimators reshape flat sites to the grid:
    only valid for 1-site-basis lattices (prod(shape) == n_sites)."""
    if lattice.basis > 1:
        raise ValueError(
            f"{what} indexes displacements on the site grid; "
            f"geometry={lattice.geometry!r} has a {lattice.basis}-site "
            f"basis — use per-sublattice estimators instead")


def _dims(lattice: Lattice) -> tuple:
    return tuple(range(1, 1 + lattice.ndim))


def szsz_correlation(s: torch.Tensor, lattice: Lattice,
                     group=None) -> torch.Tensor:
    """C(r) = <S^z_0 S^z_r> averaged over translations, [n_sites] indexed
    like the sites: C(r) = mean_i <S^z_i S^z_{i+r}>, one rolled product
    per displacement."""
    _require_site_grid(lattice, "szsz_correlation")
    m, n = s.shape
    sz = s.reshape(m, *lattice.shape) / 2.0
    dims = _dims(lattice)
    c = torch.stack([
        (sz * torch.roll(sz, tuple(int(x) for x in lattice.coords[r]),
                         dims=dims)).reshape(m, -1).mean()
        for r in range(n)])
    return pmean(c, group)


def structure_factor(corr, lattice: Lattice) -> np.ndarray:
    """S(q) = |sum_r e^{iq.r} C(r)| on the reciprocal lattice (host-side);
    the antiferromagnet peaks at q = (pi, pi) (or pi in 1D)."""
    c = np.asarray(corr).reshape(lattice.shape)
    return np.abs(np.fft.fftn(c))


def szsz_correlation_basis(s: torch.Tensor, lattice: Lattice,
                           group=None) -> torch.Tensor:
    """Sublattice-resolved C_ab(r) = mean_c <S^z_{(c,a)} S^z_{(c+r,b)}>,
    [basis, basis, n_cells], r over cell translations (the symmetry group
    of a Bravais lattice with a basis); C_00 is szsz_correlation on a
    1-site basis."""
    m = s.shape[0]
    sz = s.reshape(m, *lattice.shape, lattice.basis) / 2.0
    dims = _dims(lattice)
    n_cells = int(np.prod(lattice.shape))
    cell_coords = np.stack(
        np.unravel_index(np.arange(n_cells), lattice.shape), axis=-1)
    flat = sz.reshape(m, n_cells, lattice.basis)
    cs = []
    for r in range(n_cells):
        # roll by -r so rolled[c] = sz[c + r]: C_ab is not symmetric in
        # (a, b) at fixed r, only under (a, b, r) -> (b, a, -r)
        rolled = torch.roll(sz, tuple(-int(x) for x in cell_coords[r]),
                            dims=dims).reshape(m, n_cells, lattice.basis)
        cs.append(torch.einsum("mca,mcb->ab", flat, rolled) / (m * n_cells))
    return pmean(torch.stack(cs, dim=-1), group)


def structure_factor_basis(corr, lattice: Lattice, phases=None) -> np.ndarray:
    """S_w(q) = |sum_ab w_a* w_b FFT_r[C_ab](q)| on the cell reciprocal
    grid (host-side), from szsz_correlation_basis; ``phases`` w defaults
    to all ones (uniform order); the honeycomb Neel order is w = (1, -1),
    peaking at q = 0."""
    b = lattice.basis
    c = np.asarray(corr).reshape(b, b, *lattice.shape)
    w = np.ones(b) if phases is None else np.asarray(phases)
    f = np.fft.fftn(c, axes=tuple(range(2, 2 + lattice.ndim)))
    return np.abs(np.einsum("a,b,ab...->...", np.conj(w), w, f))


def _staggered(s: torch.Tensor, lattice: Lattice) -> torch.Tensor:
    """Per-walker M_st = (1/N) sum_i (-1)^i S^z_i."""
    signs = torch.as_tensor(
        1.0 - 2.0 * lattice.sublattice_mask.astype(np.float32),
        device=s.device)
    return (s * signs[None, :] / 2.0).mean(dim=-1)


def staggered_magnetization_sq(s: torch.Tensor, lattice: Lattice,
                               group=None) -> torch.Tensor:
    """<M_st^2> with M_st = (1/N) sum_i (-1)^i S^z_i (AFM order)."""
    m_st = _staggered(s, lattice)
    return pmean((m_st * m_st).mean(), group)


def staggered_moments(s: torch.Tensor, lattice: Lattice, group=None):
    """(<M_st^2>, <M_st^4>), the moments of the Binder cumulant; average
    each across samples before forming the ratio
    (:func:`binder_cumulant`)."""
    m_st = _staggered(s, lattice)
    m2 = m_st * m_st
    return pmean(m2.mean(), group), pmean((m2 * m2).mean(), group)


def binder_cumulant(m2_mean: float, m4_mean: float) -> float:
    """U_4 = 1 - <M^4> / (3 <M^2>^2) from sample-averaged moments."""
    if m2_mean <= 0:
        return float("nan")
    return float(1.0 - m4_mean / (3.0 * m2_mean * m2_mean))


def correlation_length(corr, lattice: Lattice, q_peak=None) -> float:
    """Second-moment correlation length (host-side):
    xi = sqrt(S(Q) / S(Q + dq) - 1) / (2 sin(pi / L)), Q the S(q) peak
    (or ``q_peak``), dq = 2 pi / L along the first axis; +inf for
    saturated order, 0 without peak structure."""
    _require_site_grid(lattice, "correlation_length")
    sq = structure_factor(corr, lattice)
    if q_peak is None:
        q_peak = np.unravel_index(int(np.argmax(sq)), sq.shape)
    q_peak = tuple(int(q) % n for q, n in zip(q_peak, lattice.shape))
    neighbor = ((q_peak[0] + 1) % lattice.shape[0],) + q_peak[1:]
    s_peak = float(sq[q_peak])
    s_next = float(sq[neighbor])
    length = lattice.shape[0]
    if s_next <= 0 or s_peak <= s_next:
        return float("inf") if s_next < s_peak else 0.0
    return float(np.sqrt(s_peak / s_next - 1.0)
                 / (2.0 * np.sin(np.pi / length)))


def offdiag_observable(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                       connected_fn, group=None,
                       chunk_size: Optional[int] = None) -> C:
    """<O> for an off-diagonal operator from its connected decomposition
    ``connected_fn(s [M, N]) -> (s' [M, K, N], coeff, mask [M, K])``:
    O_loc(s) = sum_k mask coeff psi(s'_k)/psi(s), as the local energy.
    ``chunk_size`` bounds the [chunk * K, N] forward (it must divide M),
    one forward per walker chunk."""
    with torch.no_grad():
        o_loc = over_walker_chunks(
            lambda s_c, lp_c: connected_sum(log_psi_fn, params, s_c, lp_c,
                                            connected_fn),
            chunk_size, s, log_psi)
        return C(pmean(o_loc.re.mean(), group), pmean(o_loc.im.mean(), group))


def spin_spin_connected(lattice: Lattice, displacement: int,
                        marshall: bool = False):
    """connected_fn of the off-diagonal part of (1/N) sum_i S_i . S_{i+r}:
    (S^+_i S^-_j + S^-_i S^+_j)/2 flips an anti-aligned pair with
    coefficient 1/2 (aligned pairs masked). ``displacement`` indexes the
    lattice like a site (1-site basis) and must be nonzero. ``marshall``:
    the state lives in the Marshall-rotated basis, where
    opposite-sublattice pairs pick up a -1."""
    _require_site_grid(lattice, "spin_spin_connected")
    n = lattice.n_sites
    coords = np.asarray(lattice.coords)
    shape = np.asarray(lattice.shape)
    perm = np.ravel_multi_index(
        ((coords + coords[displacement]) % shape).T, tuple(lattice.shape))
    if int(displacement) == 0:
        raise ValueError("displacement 0 is purely diagonal (S_i.S_i = 3/4)")
    eye = np.eye(n, dtype=np.float32)
    # flip_sign[k] = -1 on sites k and perm[k], +1 elsewhere
    flip_sign = 1.0 - 2.0 * np.clip(eye + eye[perm], 0, 1)
    sign = np.full(n, 0.5 / n, np.float32)
    if marshall:
        sub = np.asarray(lattice.sublattice_mask)
        sign = np.where(sub != sub[perm], -sign, sign).astype(np.float32)

    def connected(s: torch.Tensor):
        dev = s.device
        anti = (s * s[:, torch.as_tensor(perm, device=dev)]) < 0.0
        sp = s[:, None, :] * torch.as_tensor(flip_sign, device=dev)[None]
        return sp, torch.as_tensor(sign, device=dev), anti

    return connected


def spin_spin_correlation(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                          lattice: Lattice, displacement: int,
                          marshall: bool = False, group=None,
                          chunk_size: Optional[int] = None) -> C:
    """C(r) = (1/N) sum_i <S_i . S_{i+r}> for one displacement: the S^z S^z
    part from the configurations, the transverse part by amplitude ratios
    (N forwards per walker); ``marshall`` as in spin_spin_connected."""
    m = s.shape[0]
    if int(displacement) == 0:
        c = torch.tensor(0.75, device=s.device)
        return C(pmean(c, group), torch.zeros((), device=s.device))
    sz = s.reshape(m, *lattice.shape) / 2.0
    shift = tuple(int(x) for x in lattice.coords[displacement])
    diag = (sz * torch.roll(sz, shift, dims=_dims(lattice))).reshape(
        m, -1).mean()
    off = offdiag_observable(
        log_psi_fn, params, s, log_psi,
        spin_spin_connected(lattice, displacement, marshall=marshall),
        group=group, chunk_size=chunk_size)
    return C(pmean(diag, group) + off.re, off.im)


def chirality_connected(lattice: Lattice):
    """connected_fn of the scalar chirality
    chi = (1/n_tri) sum_triangles S_i . (S_j x S_k) over the CCW triangles
    of ``lattice.triangles``: each cyclic pair (b, c) of a triangle is a
    pair flip with the purely imaginary element i (-s_a s_b / 4) when
    anti-aligned. The weights returned are the real parts c_k, so
    chi = i z with z = offdiag_observable(...) (:func:`scalar_chirality`).
    No Marshall variant: triangles exist only off the bipartite lattices."""
    tris = np.asarray(lattice.triangles)
    t = len(tris)
    cyc = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    a_idx, b_idx, c_idx = (np.concatenate([tris[:, p[j]] for p in cyc])
                           for j in range(3))
    n = lattice.n_sites
    k = len(a_idx)
    flips = np.ones((k, n), np.float32)
    flips[np.arange(k), b_idx] = -1.0
    flips[np.arange(k), c_idx] = -1.0

    def connected(s: torch.Tensor):
        dev = s.device
        s_a, s_b, s_c = (s[:, torch.as_tensor(i, device=dev)]
                         for i in (a_idx, b_idx, c_idx))
        anti = (s_b * s_c) < 0.0
        coeff = -(s_a * s_b) / (4.0 * t)
        sp = s[:, None, :] * torch.as_tensor(flips, device=dev)[None]
        return sp, coeff, anti

    return connected


def scalar_chirality(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                     lattice: Lattice, group=None,
                     chunk_size: Optional[int] = None) -> C:
    """<chi> = (1/n_tri) sum_t <S_i . (S_j x S_k)> over CCW triangles (3T
    forwards per walker); 0 for any time-reversal-invariant state."""
    z = offdiag_observable(log_psi_fn, params, s, log_psi,
                           chirality_connected(lattice), group=group,
                           chunk_size=chunk_size)
    return C(-z.im, z.re)  # chi = i * z


def renyi2_swap(log_psi_fn, params, s1: torch.Tensor, s2: torch.Tensor,
                log_psi1: C, log_psi2: C, region, sector_mask: bool = False,
                group=None) -> C:
    """<SWAP_A> = Tr(rho_A^2), the replica swap estimator (Hastings et al.,
    PRL 104:157201 (2010)) over two independent batches s1, s2 ~ |psi|^2:

      swap_loc(s, s') = psi(t) psi(t') / (psi(s) psi(s')),
      t = s with region A's spins from s', t' = s' with A's from s.

    A diagonal rotation of product form (the Marshall sign) cancels from
    the ratio: each site keeps its pair of replica values. ``sector_mask``
    zeroes the pairs whose region-A magnetizations differ: an exact S^z
    eigenstate gives them 0 (rho_A is block-diagonal in m_A), while an
    ansatz trained only inside the sector returns unphysical amplitudes
    for the out-of-sector swapped configurations. Returns the complex
    mean, reduced over ``group`` (take S_2 = -ln Re on the host)."""
    ratio = renyi2_swap_local(log_psi_fn, params, s1, s2, log_psi1,
                              log_psi2, region, sector_mask=sector_mask)
    return C(pmean(ratio.re.mean(), group), pmean(ratio.im.mean(), group))


def renyi2_swap_local(log_psi_fn, params, s1: torch.Tensor, s2: torch.Tensor,
                      log_psi1: C, log_psi2: C, region,
                      sector_mask: bool = False) -> C:
    """The per-pair swap_loc values [M] of :func:`renyi2_swap`, unreduced
    (exact-enumeration tests weight them by |psi|^2). ``region`` is an [N]
    0/1 mask of A."""
    with torch.no_grad():
        region = torch.as_tensor(region, dtype=torch.float32,
                                 device=s1.device)
        t1 = s1 * (1.0 - region) + s2 * region
        t2 = s2 * (1.0 - region) + s1 * region
        lp_t1 = log_psi_fn(params, t1)
        lp_t2 = log_psi_fn(params, t2)
        ratio = cplx.cexp(C(
            lp_t1.re + lp_t2.re - log_psi1.re - log_psi2.re,
            lp_t1.im + lp_t2.im - log_psi1.im - log_psi2.im))
        if sector_mask:
            keep = ((s1 * region).sum(-1) == (s2 * region).sum(-1))
            w = keep.to(torch.float32)
            ratio = C(ratio.re * w, ratio.im * w)
        return ratio


def renyi2_entropy(swap_mean: float) -> float:
    """S_2 = -ln Re<SWAP_A> (host side); NaN where the estimate is <= 0,
    which signals too few samples for an exponentially small overlap."""
    v = float(np.real(swap_mean))
    return float(-np.log(v)) if v > 0 else float("nan")


def dimer_correlation(s: torch.Tensor, lattice: Lattice, direction: int = 0,
                      group=None):
    """z-dimer correlations, the diagonal probe of valence-bond-solid
    order: with d_i = S^z_i S^z_{i+e_a} (a = ``direction``), returns
    (C_D [n_sites], <d>) with C_D(r) = mean_i <d_i d_{i+r}>; the connected
    correlator is formed downstream through <d>. 2D hypercubic only."""
    _require_site_grid(lattice, "dimer_correlation")
    if lattice.ndim != 2:
        raise ValueError("dimer_correlation is for 2D lattices")
    m, n = s.shape
    sz = s.reshape(m, *lattice.shape) / 2.0
    shift = [0, 0]
    shift[direction] = -1  # neighbor at +e_a
    d = sz * torch.roll(sz, tuple(shift), dims=(1, 2))
    c = torch.stack([
        (d * torch.roll(d, tuple(int(x) for x in lattice.coords[r]),
                        dims=(1, 2))).reshape(m, -1).mean()
        for r in range(n)])
    return pmean(c, group), pmean(d.reshape(m, -1).mean(), group)


def dimer_structure_factor(corr, d_mean: float, lattice: Lattice
                           ) -> np.ndarray:
    """S_D(q) = |FFT[C_D(r) - <d>^2]| (host-side); columnar VBS order of
    x-bonds peaks at q = (pi, 0)."""
    c = np.asarray(corr).reshape(lattice.shape) - float(d_mean) ** 2
    return np.abs(np.fft.fftn(c))


def total_spin_sq(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                  lattice: Lattice, marshall: bool = False, group=None,
                  pair_chunk: int = 1024) -> C:
    """<S^2> of the total spin (0 for a singlet, 2 for a triplet):
    S^2_loc(s) = M_z^2 + N/2 + sum_{i<j, anti} sign_ij psi(s^{ij})/psi(s),
    M_z = sum_i s_i / 2, s^{ij} the pair swapped, sign_ij = -1 for
    opposite-sublattice pairs in the Marshall-rotated basis. The sum runs
    over all N(N-1)/2 pairs, ``pair_chunk`` pairs per forward of M x
    pair_chunk configurations."""
    m, n = s.shape
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     np.int64)
    if marshall:
        sub = np.asarray(lattice.sublattice_mask)
        signs = np.where(sub[pairs[:, 0]] != sub[pairs[:, 1]],
                         -1.0, 1.0).astype(np.float32)
    else:
        signs = np.ones(len(pairs), np.float32)
    dev = s.device
    with torch.no_grad():
        mz = s.sum(-1) / 2.0
        o = C(mz * mz + n / 2.0, torch.zeros_like(mz))
        for lo in range(0, len(pairs), pair_chunk):
            pk = pairs[lo:lo + pair_chunk]
            kk = len(pk)
            flips = np.ones((kk, n), np.float32)
            flips[np.arange(kk), pk[:, 0]] = -1.0
            flips[np.arange(kk), pk[:, 1]] = -1.0
            flips = torch.as_tensor(flips, device=dev)
            i0 = torch.as_tensor(pk[:, 0], device=dev)
            i1 = torch.as_tensor(pk[:, 1], device=dev)
            sign = torch.as_tensor(signs[lo:lo + pair_chunk], device=dev)
            o = o + connected_sum(log_psi_fn, params, s, log_psi, lambda x: (
                x[:, None, :] * flips[None], sign,
                (x[:, i0] * x[:, i1]) < 0.0))
        return C(pmean(o.re.mean(), group), pmean(o.im.mean(), group))


def translation_projected_log_psi(log_psi_fn, lattice_shape, momentum,
                                  shift_stride: int = 1):
    """(params, s) -> log (P_q psi)(s): the momentum-q translation
    projection evaluated as a function of the unprojected model (a
    logmeanexp over the rolled configurations with e^{i k.a} characters).
    Costs T = prod(L_d / stride) forwards per amplitude."""
    shifts = list(itertools.product(
        *[range(0, n, shift_stride) for n in lattice_shape]))
    k = [2.0 * np.pi * m / n for m, n in zip(momentum, lattice_shape)]
    phases = np.asarray([sum(kd * ad for kd, ad in zip(k, shift))
                         for shift in shifts], dtype=np.float32)
    dims = tuple(range(1, 1 + len(lattice_shape)))

    def plog(params, s):
        batch = s.shape[0]
        grid = s.reshape(batch, *lattice_shape)
        rolled = torch.stack([torch.roll(grid, sh, dims=dims).reshape(
            batch, -1) for sh in shifts])                    # [T, B, N]
        t = rolled.shape[0]
        logs = log_psi_fn(params, rolled.reshape(t * batch, -1))
        ph = torch.as_tensor(phases, device=s.device)[:, None]
        logs = C(logs.re.reshape(t, batch), logs.im.reshape(t, batch) + ph)
        return cplx.logmeanexp(logs, dim=0)

    return plog


def sector_energy_ratio(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                        ham, lattice_shape, momentum,
                        shift_stride: int = 1,
                        chunk_size: Optional[int] = None):
    """Momentum-sector energy E_q by ratio estimators under |psi|^2.

    With [P_q, H] = 0 and P_q^2 = P_q:
      E_q = E_{|psi|^2}[num(s)] / E_{|psi|^2}[den(s)],
      den(s) = (P_q psi)(s) / psi(s)           (T amplitude ratios)
      num(s) = diag(s) den(s) + sum_k mel_k (P_q psi)(s'_k) / psi(s)
    Every integrand is a bounded sum of amplitude ratios: no sampling of
    |P psi|^2. Cost (K+1) x T forwards per walker; ``chunk_size`` bounds
    the working set as in local_energy.

    Returns (num C[M], den C[M])."""
    plog = translation_projected_log_psi(log_psi_fn, lattice_shape,
                                         momentum, shift_stride)

    def compute(s_c, lp_c: C):
        offdiag = connected_sum(plog, params, s_c, lp_c, ham.connected_batch)
        pl_c = plog(params, s_c)
        den = cplx.cexp(C(pl_c.re - lp_c.re, pl_c.im - lp_c.im))
        diag = ham.diag_batch(s_c)
        num = C(diag * den.re + offdiag.re, diag * den.im + offdiag.im)
        return num, den

    with torch.no_grad():
        return over_walker_chunks(compute, chunk_size, s, log_psi)


def sector_energy_from_samples(num: C, den: C):
    """(E_q, E_q_err, sector_weight) from per-walker num and den (host
    arrays, or tensors): the complex-ratio mean with a leave-one-out
    jackknife error on Re E_q, in float64."""
    nr = (np.asarray(num.re, np.float64)
          + 1j * np.asarray(num.im, np.float64))
    dr = (np.asarray(den.re, np.float64)
          + 1j * np.asarray(den.im, np.float64))
    m = nr.size
    e_full = (nr.sum() / dr.sum()).real
    if m < 4:
        return float(e_full), float("nan"), float(np.abs(dr.mean()))
    loo = ((nr.sum() - nr) / (dr.sum() - dr)).real
    err = np.sqrt((m - 1) / m * ((loo - loo.mean()) ** 2).sum())
    return float(e_full), float(err), float(np.abs(dr.mean()))
