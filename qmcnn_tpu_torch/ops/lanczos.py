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

The measurement-time moment estimators (``h_moment_samples``,
``moments_from_samples``, ``lanczos_step``) belong to the measurement
slice (ROADMAP.md, A17).
"""
from __future__ import annotations

from typing import Optional

import torch

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy

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
