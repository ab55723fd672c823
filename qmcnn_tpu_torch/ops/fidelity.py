"""Monte-Carlo fidelity between two wavefunctions (port of
``qmcnn_tpu/ops/fidelity.py``):

  F = |<psi1|psi2>|^2 / (<psi1|psi1> <psi2|psi2>)
    = E_{s~|psi1|^2}[psi2/psi1(s)] * E_{s~|psi2|^2}[psi1/psi2(s)],

the two-chain overlap estimator. Both factors are ratios of amplitudes on
the other chain's samples, so everything stays in log space. Under a
walker group each rank holds its rows of both chains; the means reduce
through ``vmc.pmean`` and the stabilizing shift is the global maximum
(``WalkerGroup.agree``, JAX's ``pmax``).
"""
from __future__ import annotations

import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.vmc import pmean


def _mean_ratio(lp_num: C, lp_den: C, group=None):
    """(E[exp(lp_num - lp_den)], shift) with the max-Re shift taken out."""
    d = C(lp_num.re - lp_den.re, lp_num.im - lp_den.im)
    shift = d.re.max()
    if group is not None:
        # the true global max: a mean of per-rank maxima would agree
        # across ranks but guard overflow less well
        shift = group.agree(shift)
    w = cplx.cexp(C(d.re - shift, d.im))
    return C(pmean(w.re.mean(), group), pmean(w.im.mean(), group)), shift


def fidelity(log_psi1_fn, params1, log_psi2_fn, params2,
             s_from_1: torch.Tensor, s_from_2: torch.Tensor,
             group=None) -> torch.Tensor:
    """The MC fidelity estimate, in [0, 1] up to sampling noise (noise may
    push it slightly above 1), from [M, N] samples of |psi1|^2
    (``s_from_1``) and of |psi2|^2 (``s_from_2``); a 0-d tensor."""
    with torch.no_grad():
        lp1_on1 = log_psi1_fn(params1, s_from_1)
        lp2_on1 = log_psi2_fn(params2, s_from_1)
        lp1_on2 = log_psi1_fn(params1, s_from_2)
        lp2_on2 = log_psi2_fn(params2, s_from_2)
        r21, shift_a = _mean_ratio(lp2_on1, lp1_on1, group)
        r12, shift_b = _mean_ratio(lp1_on2, lp2_on2, group)
        prod = r21 * r12
        # the shifts are log-ratio extrema of opposite sign and cancel in
        # expectation: restore them in log space
        log_f = (torch.log(torch.clamp(torch.sqrt(prod.abs2()), min=1e-30))
                 + shift_a + shift_b)
        return torch.exp(log_f)
