"""The Lanczos-dressed ansatz phi = (1 + alpha H) psi_theta (port of
``lanczos_wrap`` and ``lanczos_init_alpha`` of ``qmcnn_tpu/ops/lanczos.py``).

  log phi(s) = log psi(s) + 1/2 log max(|1 + alpha E_loc(s)|^2, 1e-24)
               + i arg(1 + alpha E_loc(s)),
  E_loc(s) = (H psi_theta)(s) / psi_theta(s),

an exact identity. The result is another ``(params, s) -> C`` function, so
Metropolis on |phi|^2, the local energy of phi and the SR scores compose
unchanged; the training local energy of phi costs K^2 base forwards per
sample (K = ham.n_conn), which is why the builder divides the auto chunk by
K. alpha is complex and trainable, a [re, im] leaf at the flat key
``lanczos/alpha`` beside the base params, so warm starts from a plain
snapshot transfer every base leaf and keep alpha at its configured value.
No kernel computes phi: the fused forwards refuse a wrapped model.

The measurement-time Lanczos step: from MC estimates of the moments
h_k = <psi|H^k|psi> / <psi|psi> (k = 1, 2, 3) under |psi|^2,

  h1 = E[E_loc(s)],  h2 = E[|E_loc(s)|^2],  h3 = E[Re(E_loc(s)* G(s))],
  G(s) = (H^2 psi)_s / psi_s
       = diag(s) E_loc(s) + sum_k mask_k mel_k ratio_k(s) E_loc(s'_k),

the energy of phi(alpha) is a rational function of alpha with a closed-form
minimizer and E(alpha*) <= E(0): a variational improvement at frozen theta.
G needs the local energy of every connected state, K times an E_loc pass;
connected states stay with their walker, so under walker sharding the
per-walker (E_loc, G) need no communication. ``h_moment_samples`` computes
them through any ``log_psi_fn`` (the measurement's evaluation forward, so
K1 / K2 f32 serve them on CUDA); ``moments_from_samples`` and
``lanczos_step`` are host float64, since the third moment cancels
~|E|^3 down to O(var). With centered moments k2 = h2 - h1^2,
k3 = h3 - 3 h1 h2 + 2 h1^3 and phi(beta) = (1 + beta (H - h1)) psi (the
same family, beta = alpha / (1 + alpha h1)):

  E(beta) = h1 + (2 beta k2 + beta^2 k3) / (1 + beta^2 k2),
  dE/dbeta = 0  <=>  -k2^2 beta^2 + k3 beta + k2 = 0,

and the root of lower energy is taken; alpha = beta / (1 - beta h1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy, over_walker_chunks

#: the flat key of alpha (JAX: the ``{"lanczos": {"alpha": ...}}``
#: collection beside ``params``)
ALPHA_KEY = "lanczos/alpha"


def lanczos_wrap(base_log_psi_fn, ham, inner_chunk: Optional[int] = None):
    """log phi of ``phi = (1 + alpha H) psi``, a function of the base params
    and ``lanczos/alpha``. ``inner_chunk`` chunks the inner E_loc. phi
    vanishes where alpha E_loc = -1; |z|^2 is clamped at 1e-24 so the log
    stays finite, and the Metropolis walk avoids that nodal surface."""

    def wrapped(params, s):
        alpha = params[ALPHA_KEY]
        base = {k: v for k, v in params.items() if k != ALPHA_KEY}
        lp = base_log_psi_fn(base, s)
        e_loc = local_energy(base_log_psi_fn, base, ham, s, lp,
                             chunk_size=inner_chunk)
        z = C(1.0 + alpha[0] * e_loc.re - alpha[1] * e_loc.im,
              alpha[0] * e_loc.im + alpha[1] * e_loc.re)
        mag2 = torch.clamp(z.re * z.re + z.im * z.im, min=1e-24)
        return C(lp.re + 0.5 * torch.log(mag2),
                 lp.im + torch.atan2(z.im, z.re))

    return wrapped


def lanczos_init_alpha(alpha0: float, device="cpu") -> torch.Tensor:
    """A fresh alpha = [alpha0, 0] (e.g. the alpha* a measurement-time
    Lanczos step reported)."""
    return torch.tensor([float(alpha0), 0.0], dtype=torch.float32,
                        device=device)


def h_moment_samples(log_psi_fn, params, ham, s: torch.Tensor, log_psi: C,
                     chunk_size: Optional[int] = None) -> Tuple[C, C]:
    """Per-walker (E_loc(s), G(s)) with G = (H^2 psi)_s / psi_s.
    ``chunk_size`` chunks the walker axis (it must divide M); a chunk of m
    walkers runs the [m K, N] forward of its connected states, their
    E_loc in inner chunks of m (K forwards of [m K, N]) and its own E_loc,
    so the peak forward batch is [m K, N]. Every connected row is
    forwarded, not only those that carry an element: the second application
    of H reads each row's own log psi, and a masked row of a general
    Hamiltonian is not always s."""

    def compute(s_c, lp_c: C):
        m = s_c.shape[0]
        k = ham.n_conn
        s_prime, mel, mask = ham.connected_batch(s_c)   # [m,K,N],[m,K] x2
        sp_flat = s_prime.reshape(m * k, -1)
        lp_prime = log_psi_fn(params, sp_flat)          # C [m K]
        # E_loc of every connected state, the second application of H
        e_prime = local_energy(log_psi_fn, params, ham, sp_flat, lp_prime,
                               chunk_size=m).reshape(m, k)
        ratio = cplx.cexp(C(lp_prime.re.reshape(m, k) - lp_c.re[:, None],
                            lp_prime.im.reshape(m, k) - lp_c.im[:, None]))
        w = mel * mask.to(mel.dtype)                    # [m, K]
        re = (w * (ratio.re * e_prime.re - ratio.im * e_prime.im)).sum(-1)
        im = (w * (ratio.re * e_prime.im + ratio.im * e_prime.re)).sum(-1)
        diag = ham.diag_batch(s_c)
        e1_c = local_energy(log_psi_fn, params, ham, s_c, lp_c)
        return e1_c, C(diag * e1_c.re + re, diag * e1_c.im + im)

    with torch.no_grad():
        return over_walker_chunks(compute, chunk_size, s, log_psi)


def moments_from_samples(e1: C, g: C, weights=None
                         ) -> Tuple[float, float, float]:
    """(h1, h2, h3) from per-sample (E_loc, G), host float64. ``weights``:
    probability weights (exact-enumeration tests), else the uniform MC
    average."""
    e_re, e_im, g_re, g_im = (np.asarray(x, np.float64)
                              for x in (e1.re, e1.im, g.re, g.im))
    if weights is None:
        w = np.full(e_re.shape, 1.0 / e_re.size)
    else:
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
    h1 = float((w * e_re).sum())
    h2 = float((w * (e_re * e_re + e_im * e_im)).sum())
    h3 = float((w * (e_re * g_re + e_im * g_im)).sum())
    return h1, h2, h3


def lanczos_step(h1: float, h2: float, h3: float
                 ) -> Tuple[float, float, float]:
    """(alpha*, E(alpha*), E(0) = h1) minimizing the Lanczos-step energy,
    alpha* the coefficient of the raw H in (1 + alpha H). Where k2 <= 0
    (an eigenstate, or MC noise) alpha is 0 and nothing changes."""
    k2 = h2 - h1 * h1
    k3 = h3 - 3.0 * h1 * h2 + 2.0 * h1 ** 3
    if k2 <= 0.0:
        return 0.0, h1, h1

    def energy(beta: float) -> float:
        return h1 + ((2.0 * beta * k2 + beta * beta * k3)
                     / (1.0 + beta * beta * k2))

    disc = np.sqrt(k3 * k3 + 4.0 * k2 ** 3)
    roots = [(k3 + disc) / (2.0 * k2 * k2), (k3 - disc) / (2.0 * k2 * k2)]
    beta = min(roots, key=energy)
    alpha = beta / (1.0 - beta * h1)
    return float(alpha), float(energy(beta)), h1
