"""The static-batch local energy, the reference for ``ops/local_energy``'s
compaction (imports no JAX, so the card's tests use it too): every one of
the M K connected rows forwarded, the masked rows' terms multiplied by a
zero weight, in walker chunks of ``chunk_size``."""
import torch

from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C


def static_local_energy(fn, params, ham, s, lp, chunk_size=None) -> C:
    def compute(s_c, lp_c):
        m, k = s_c.shape[0], ham.n_conn
        sp, mel, mask = ham.connected_batch(s_c)
        lpp = fn(params, sp.reshape(m * k, -1))
        ratio = cplx.cexp(C(lpp.re.reshape(m, k) - lp_c.re[:, None],
                            lpp.im.reshape(m, k) - lp_c.im[:, None]))
        w = mel * mask.to(mel.dtype)
        return C(ham.diag_batch(s_c) + (w * ratio.re).sum(-1),
                 (w * ratio.im).sum(-1))

    step = chunk_size or s.shape[0]
    parts = [compute(s[i:i + step], lp[i:i + step])
             for i in range(0, s.shape[0], step)]
    return C(torch.cat([p.re for p in parts]),
             torch.cat([p.im for p in parts]))
