"""Local energy E_loc(s) = <s|H|psi>/<s|psi> (port of
``qmcnn_tpu/ops/local_energy.py``).

E_loc(s) = diag(s) + sum_k mask_k * mel_k * psi(s'_k)/psi(s), with the
amplitude ratios in log space. The [M, K] connected-state forward is the
largest batched forward of a training step; it runs as one [M*K, N] batch,
optionally over walker chunks to bound device memory.
"""
from __future__ import annotations

from typing import Optional

import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


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
        m = s_c.shape[0]
        k = ham.n_conn
        s_prime, mel, mask = ham.connected_batch(s_c)  # [m,K,N], [m,K] x2
        lp_prime = log_psi_fn(params, s_prime.reshape(m * k, -1)).reshape(m, k)
        ratio = cplx.cexp(C(lp_prime.re - lp_c.re[:, None],
                            lp_prime.im - lp_c.im[:, None]))
        w = mel * mask.to(mel.dtype)                     # [m, K] real
        offdiag = C((w * ratio.re).sum(-1), (w * ratio.im).sum(-1))
        diag = ham.diag_batch(s_c)
        return C(diag + offdiag.re, offdiag.im)

    m_total = s.shape[0]
    if chunk_size is None or chunk_size >= m_total:
        return compute(s, log_psi)
    if m_total % chunk_size:
        raise ValueError(f"chunk_size {chunk_size} must divide M={m_total}")
    parts = [compute(s[i:i + chunk_size], log_psi[i:i + chunk_size])
             for i in range(0, m_total, chunk_size)]
    return C(torch.cat([p.re for p in parts]), torch.cat([p.im for p in parts]))
