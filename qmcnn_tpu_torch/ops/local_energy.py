"""Local energy E_loc(s) = <s|H|psi>/<s|psi> (port of
``qmcnn_tpu/ops/local_energy.py``).

E_loc(s) = diag(s) + sum_k mask_k * mel_k * psi(s'_k)/psi(s), with the
amplitude ratios in log space. The [M, K] connected-state forward is the
largest batched forward of a training step, optionally over walker chunks
to bound device memory. Only the rows that carry a matrix element
(``mask``) are forwarded: a masked row (an aligned bond of an exchange
Hamiltonian, a copy of s) takes its walker's log psi, so its ratio is
exactly 1 and its weight 0, and the [m, K] sum keeps its shape and order.
The off-diagonal observables (``ops/observables``) take the same
:func:`connected_sum` over the same :func:`over_walker_chunks`.
"""
from __future__ import annotations

from typing import Optional

import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.utils.profiling import count


def _batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is batched by a ``torch.func.vmap`` at any level of the
    transforms that wrap it (a batched mask cannot be read on the host)."""
    functorch = torch._C._functorch
    while functorch.is_functorch_wrapped_tensor(t):
        if functorch.is_batchedtensor(t):
            return True
        t = functorch.get_unwrapped(t)
    return False


def connected_log_psi(log_psi_fn, params, s_prime: torch.Tensor,
                      mask: torch.Tensor, lp_c: C) -> C:
    """log psi [m, K] of the connected rows ``s_prime`` [m, K, N], forwarded
    only where ``mask`` [m, K] is set, in one batch of those rows (one host
    read of the mask); elsewhere each walker's ``lp_c`` [m]. Where no row
    carries an element no forward runs. Under a ``torch.func.vmap`` that
    batches the mask (a per-walker Jacobian of the (1 + alpha H) ansatz)
    the mask cannot be read and every row is forwarded; under ``grad``,
    ``jacrev`` or ``jvp`` alone the rows are compacted. Counters:
    ``e_loc.rows`` (rows forwarded) and ``e_loc.rows_connected`` (m K)."""
    m, k, n = s_prime.shape
    flat = s_prime.reshape(m * k, n)
    count("e_loc.rows_connected", m * k)
    if _batched(mask):
        count("e_loc.rows", m * k)
        return log_psi_fn(params, flat).reshape(m, k)
    idx = mask.reshape(-1).nonzero().squeeze(1)
    count("e_loc.rows", idx.numel())
    fill = C(lp_c.re[:, None].expand(m, k), lp_c.im[:, None].expand(m, k))
    if idx.numel() == 0:
        return fill
    out = log_psi_fn(params, flat.index_select(0, idx))
    return C(*(base.reshape(m * k).index_copy(0, idx, part).reshape(m, k)
               for base, part in zip(fill, out)))


def over_walker_chunks(fn, chunk_size: Optional[int], *batch):
    """``fn(*parts)`` over walker chunks of ``chunk_size`` rows of each of
    ``batch`` (tensors or ``C`` pairs, M rows each), its results (one ``C``
    or a tuple of them) concatenated; one call when ``chunk_size`` is None
    or at least M. The chunk must divide M."""
    m = batch[0].shape[0]
    if chunk_size is None or chunk_size >= m:
        return fn(*batch)
    if m % chunk_size:
        raise ValueError(f"chunk_size {chunk_size} must divide M={m}")
    parts = [fn(*(x[i:i + chunk_size] for x in batch))
             for i in range(0, m, chunk_size)]

    def cat(zs):
        return C(torch.cat([z.re for z in zs]), torch.cat([z.im for z in zs]))

    if isinstance(parts[0], C):
        return cat(parts)
    return tuple(cat(zs) for zs in zip(*parts))


def connected_sum(log_psi_fn, params, s: torch.Tensor, log_psi: C,
                  connected_fn) -> C:
    """O_loc(s) = sum_k mask_k coeff_k psi(s'_k)/psi(s) [M] from the
    connected decomposition ``connected_fn(s [M, N]) -> (s' [M, K, N],
    coeff [K] or [M, K], mask [M, K])``, the rows forwarded by
    :func:`connected_log_psi`."""
    s_prime, coeff, mask = connected_fn(s)
    lp_prime = connected_log_psi(log_psi_fn, params, s_prime, mask, log_psi)
    ratio = cplx.cexp(C(lp_prime.re - log_psi.re[:, None],
                        lp_prime.im - log_psi.im[:, None]))
    w = coeff * mask.to(coeff.dtype)                     # [M, K] real
    return C((w * ratio.re).sum(-1), (w * ratio.im).sum(-1))


def local_energy(
    log_psi_fn,
    params,
    ham,
    s: torch.Tensor,
    log_psi: C,
    chunk_size: Optional[int] = None,
) -> C:
    """Batched local energies.

    Args:
      log_psi_fn: (params, s [B, N]) -> C [B].
      ham: Hamiltonian with diag_batch / connected_batch / n_conn.
      s: [M, N] walker configurations.
      log_psi: C [M], log psi(s) for the *current* params.
      chunk_size: if set, process walkers in chunks of this size (must divide
        M) to bound the [chunk * K, N] forward's memory.

    Returns:
      C [M] local energies.
    """

    def compute(s_c, lp_c: C) -> C:
        offdiag = connected_sum(log_psi_fn, params, s_c, lp_c,
                                ham.connected_batch)
        return C(ham.diag_batch(s_c) + offdiag.re, offdiag.im)

    return over_walker_chunks(compute, chunk_size, s, log_psi)
