"""The static-batch connected sum and local energy, the references for
``ops/local_energy``'s compaction (imports no JAX, so the card's tests use
them too): every one of the M K connected rows forwarded, the masked rows'
terms multiplied by a zero weight, in walker chunks of ``chunk_size``."""
import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


def static_connected_sum(fn, params, s, lp, connected_fn) -> C:
    """sum_k mask coeff psi(s'_k)/psi(s) [M] with every row forwarded, from
    ``connected_fn(s) -> (s' [M, K, N], coeff [K] or [M, K], mask)``."""
    sp, coeff, mask = connected_fn(s)
    m, k, n = sp.shape
    lpp = fn(params, sp.reshape(m * k, n))
    ratio = cplx.cexp(C(lpp.re.reshape(m, k) - lp.re[:, None],
                        lpp.im.reshape(m, k) - lp.im[:, None]))
    w = coeff * mask.to(coeff.dtype)
    return C((w * ratio.re).sum(-1), (w * ratio.im).sum(-1))


def static_local_energy(fn, params, ham, s, lp, chunk_size=None) -> C:
    def compute(s_c, lp_c):
        off = static_connected_sum(fn, params, s_c, lp_c,
                                   ham.connected_batch)
        return C(ham.diag_batch(s_c) + off.re, off.im)

    step = chunk_size or s.shape[0]
    parts = [compute(s[i:i + step], lp[i:i + step])
             for i in range(0, s.shape[0], step)]
    return C(torch.cat([p.re for p in parts]),
             torch.cat([p.im for p in parts]))
