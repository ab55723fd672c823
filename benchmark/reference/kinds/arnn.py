"""The autoregressive PixelCNN wavefunction (``model.kind: arnn`` with
``arnn_conv_kernel`` k > 0), written from its equations (Sharir, Levine,
Wies, Carleo, Shashua, "Deep autoregressive models for the efficient
variational simulation of many-body quantum systems", arXiv:1902.04057):

  * the sites in raster order i = r W + c on the H x W lattice, the spins
    s_i = +-1 as one input channel, zero outside the lattice;
  * a stack of k x k masked convolutions, each followed by its bias and
    SELU(x) = lambda (x if x > 0 else alpha (e^x - 1)); the first layer's
    taps (mask A) are the rows above the centre and the centre row left of
    it, every later layer's (mask B) add the centre, so the output at site
    i reads s_j for j < i only;
  * a 1 x 1 convolution to three heads per site: the logit a_i and the
    phases phi_i(+1), phi_i(-1);
  * log p(s_i = +1 | s_<i) = log sigmoid(a_i), log p(-1 | s_<i) =
    log sigmoid(-a_i), log sigmoid(x) = min(x, 0) - log(1 + e^-|x|);
  * log psi(s) = 1/2 sum_i log p(s_i | s_<i) + i sum_i phi_i(s_i).

Departures from the paper, each the repository's ARNN
(``configs/j1j2_4x4_arnn.yaml``):
  * the phase: per-site phase heads chosen by the realized spin, from the
    same head convolution as the logits (the paper's complex output is one
    amplitude and phase per conditional);
  * the S^z = 0 sector forced inside the conditionals (Hibat-Allah et
    al., arXiv:2002.02973): with u ups before site i, p(+1) is 1 where the
    N/2 - u ups still to place fill the N - i sites left, and 0 where none
    is left; a forbidden branch reads log p = -100, never -inf;
  * a plain stack: no residual connections and no gated activations
    between the masked layers.

Parameters (the program's flat keys): ``params/conv<l>`` [k, k, Cin, C]
and ``params/cb<l>`` [C] per layer, ``params/conv_out`` [1, 1, C, heads]
and ``params/cb_out`` [heads]; heads 3 for complex parameters, else 1
(the logit alone, and log psi is real).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.models import Params, fp8_round, precision

_SELU_ALPHA = 1.6732632423543772
_SELU_LAMBDA = 1.0507009873554805
#: log-probability of a branch the sector forbids
FORBIDDEN = -100.0


def _sizes(cfg: dict):
    m, lat = cfg["model"], cfg["lattice"]
    shape = [int(v) for v in lat["shape"]]
    k = int(m["arnn_conv_kernel"])
    if len(shape) != 2 or k < 3 or k % 2 == 0:
        raise NotImplementedError("the reference ARNN is the PixelCNN trunk: "
                                  "a 2D lattice and an odd kernel >= 3")
    if m["activation"] not in ("selu", "lncosh"):
        raise NotImplementedError("the reference ARNN's activation is SELU "
                                  "(the program's for 'lncosh' too)")
    if m["phase_bias"] or m["jastrow_phase"]:
        raise NotImplementedError("no phase prior or Jastrow phase in the "
                                  "reference ARNN")
    heads = 3 if m["complex_params"] else 1
    return shape, k, [int(c) for c in m["channels"]], heads


def sector(cfg: dict) -> bool:
    """Whether the conditionals keep S^z = 0 (``arnn_sector``: ``sz0``;
    ``auto`` for the Heisenberg and J1-J2 Hamiltonians)."""
    sec = cfg["model"]["arnn_sector"]
    if sec == "auto":
        return cfg["hamiltonian"]["kind"] in ("heisenberg", "j1j2")
    if sec not in ("sz0", "none"):
        raise ValueError(f"unknown arnn_sector {sec!r}")
    return sec == "sz0"


def tap_mask(k: int, centre: bool) -> torch.Tensor:
    """[k, k]: 1 on the rows above the centre and the centre row left of
    it; ``centre`` (mask B) adds the centre tap."""
    mask = torch.zeros(k, k)
    mask[: k // 2, :] = 1.0
    mask[k // 2, : k // 2] = 1.0
    if centre:
        mask[k // 2, k // 2] = 1.0
    return mask


def layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)}: a layer's kernel at param_scale / sqrt(its
    unmasked fan in, at least 2), the head at param_scale / sqrt(C), the
    biases 0."""
    _, k, chans, heads = _sizes(cfg)
    scale = float(cfg["model"]["param_scale"])
    out, cin = {}, 1
    for i, c in enumerate(chans):
        taps = float(tap_mask(k, i > 0).sum())
        out[f"params/conv{i}"] = ((k, k, cin, c),
                                  scale / math.sqrt(max(taps * cin, 2.0)))
        out[f"params/cb{i}"] = ((c,), 0.0)
        cin = c
    out["params/conv_out"] = ((1, 1, cin, heads),
                              scale / math.sqrt(max(cin, 2)))
    out["params/cb_out"] = ((heads,), 0.0)
    return dict(sorted(out.items()))


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A convolution's operand as ``prec`` rounds it (``fp8``, ``bf16``)."""
    if prec == "fp8":
        return fp8_round(x)
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _selu(x: torch.Tensor) -> torch.Tensor:
    return _SELU_LAMBDA * torch.where(x > 0, x,
                                      _SELU_ALPHA * torch.expm1(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def heads(cfg: dict, params: Params, s: torch.Tensor,
          prec: str = "f32") -> torch.Tensor:
    """[B, N, heads]: the head convolution's output at each site, in raster
    order."""
    (h, w), k, chans, n_heads = _sizes(cfg)
    batch = s.shape[0]
    x = s.reshape(batch, 1, h, w).to(torch.float32)
    with precision(prec):
        for i in range(len(chans)):
            mask = tap_mask(k, i > 0).to(s.device)
            kern = (params[f"params/conv{i}"] * mask[:, :, None, None]
                    ).permute(3, 2, 0, 1)
            x = F.conv2d(_round(x, prec), _round(kern, prec),
                         padding=k // 2)
            x = _selu(x + params[f"params/cb{i}"].reshape(1, -1, 1, 1))
        kern = params["params/conv_out"].permute(3, 2, 0, 1)
        out = F.conv2d(_round(x, prec), _round(kern, prec))
    out = out + params["params/cb_out"].reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1).reshape(batch, h * w, n_heads)


def conditionals(cfg: dict, params: Params, s: torch.Tensor,
                 prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(log p(+1 | s_<i), log p(-1 | s_<i)) [B, N], the sector forced."""
    logit = heads(cfg, params, s, prec)[..., 0]
    return _forced(cfg, s, _log_sigmoid(logit), _log_sigmoid(-logit))


def _forced(cfg: dict, s: torch.Tensor, up: torch.Tensor,
            dn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not sector(cfg):
        return up, dn
    n = s.shape[-1]
    is_up = (s > 0).to(torch.float32)
    before = torch.cumsum(is_up, -1) - is_up
    to_place = n / 2.0 - before
    left = n - torch.arange(n, dtype=torch.float32, device=s.device)
    must_up, must_dn = to_place >= left, to_place <= 0.0
    zero, bad = torch.zeros_like(up), torch.full_like(up, FORBIDDEN)
    return (torch.where(must_up, zero, torch.where(must_dn, bad, up)),
            torch.where(must_dn, zero, torch.where(must_up, bad, dn)))


def log_psi(cfg: dict, params: Params, s: torch.Tensor,
            prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) log psi of s [B, N]: half the summed log-probabilities of
    the realized spins, and the summed phases of their heads."""
    out = heads(cfg, params, s, prec)
    logit = out[..., 0]
    up, dn = _forced(cfg, s, _log_sigmoid(logit), _log_sigmoid(-logit))
    is_up = s > 0
    re = 0.5 * torch.where(is_up, up, dn).sum(-1)
    if out.shape[-1] == 1:
        return re, torch.zeros_like(re)
    return re, torch.where(is_up, out[..., 1], out[..., 2]).sum(-1)


def forward_flop(cfg: dict) -> float:
    """The least work of a forward: 2 (tap-sites) Cin C per layer, where a
    tap-site is an unmasked tap (k^2 // 2 for mask A, one more for mask B)
    at a site whose tap reads inside the lattice (a tap on the zero
    padding adds nothing), and 2 N C heads for the head. On 10 x 10 a
    3 x 3 mask-B layer has 442 of its 500 tap-sites, the mask-A layer 342
    of 400."""
    (h, w), k, chans, n_heads = _sizes(cfg)
    flop, cin = 0.0, 1
    for i, c in enumerate(chans):
        mask = tap_mask(k, i > 0)
        sites = sum(max(h - abs(r - k // 2), 0) * max(w - abs(q - k // 2), 0)
                    for r in range(k) for q in range(k) if mask[r, q] > 0)
        flop += 2.0 * sites * cin * c
        cin = c
    return flop + 2.0 * h * w * cin * n_heads
