"""Momentum-sector estimators (port of the part of
``qmcnn_tpu/ops/observables.py`` that sector optimization needs:
``translation_projected_log_psi`` and ``sector_energy_ratio``).

The rest of the JAX module (magnetizations, correlations, structure
factors, total spin and the other measurement estimators) belongs to the
measurement slice and is not ported yet (ROADMAP.md, A17).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


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
        m = s_c.shape[0]
        kk = ham.n_conn
        s_prime, mel, mask = ham.connected_batch(s_c)
        pl_prime = plog(params, s_prime.reshape(m * kk, -1)).reshape(m, kk)
        ratio = cplx.cexp(C(pl_prime.re - lp_c.re[:, None],
                            pl_prime.im - lp_c.im[:, None]))
        w = mel * mask.to(mel.dtype)
        offdiag = C((w * ratio.re).sum(-1), (w * ratio.im).sum(-1))
        pl_c = plog(params, s_c)
        den = cplx.cexp(C(pl_c.re - lp_c.re, pl_c.im - lp_c.im))
        diag = ham.diag_batch(s_c)
        num = C(diag * den.re + offdiag.re, diag * den.im + offdiag.im)
        return num, den

    with torch.no_grad():
        m_total = s.shape[0]
        if chunk_size is None or chunk_size >= m_total:
            return compute(s, log_psi)
        if m_total % chunk_size:
            raise ValueError(
                f"chunk_size {chunk_size} must divide M={m_total}")
        parts = [compute(s[i:i + chunk_size], log_psi[i:i + chunk_size])
                 for i in range(0, m_total, chunk_size)]
    return tuple(C(torch.cat([p[j].re for p in parts]),
                   torch.cat([p[j].im for p in parts])) for j in (0, 1))
