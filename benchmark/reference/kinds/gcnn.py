"""The C4v group-convolutional network (``model.kind: gcnn``): a lift and
group convolutions over the 8 elements of C4v, complex weights as re/im
pairs, the readout averaged over the group with the irrep's character and,
when the config says so, projected onto a spin-flip sector.

Parameters: ``params/inner/GroupConv_i/kernel_re|kernel_im|bias_re|
bias_im`` (``params/GroupConv_i/...`` without the spin-flip projection;
no ``_im`` leaves for real weights), the lift kernel [k, k, 1, C], the
group kernels [8, k, k, C, C], the biases [C]; k = min(kernel_size, the
lattice's sides), made odd.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import (Params, _conv, _lncosh,
                                        _logmeanexp, _std, precision)

#: order of C4v
G = 8
_CHARS = {"A1": (1, 1), "A2": (1, -1), "B1": (-1, 1), "B2": (-1, -1)}


def _kernel(cfg: dict) -> int:
    k = min(int(cfg["model"]["kernel_size"]), *cfg["lattice"]["shape"])
    return k - 1 if k % 2 == 0 else k


def layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)}; std 0 for the biases (zero at init)."""
    m, lat = cfg["model"], cfg["lattice"]
    k = _kernel(cfg)
    scale, mode = float(m["param_scale"]), m["init_mode"]
    chans = [int(c) for c in m["channels"]]
    prefix = "params/inner/" if m["spin_flip_sector"] else "params/"
    parts = ("re", "im") if m["complex_params"] else ("re",)
    out = {}
    cin = 1
    for i, c in enumerate(chans):
        extra = 1.0
        if mode == "fan_in" and i == len(chans) - 1:
            extra = 0.1 / math.sqrt(math.prod(lat["shape"]) * G * c)
        fan_in = k * k * (cin if i == 0 else G * cin)
        std = extra * _std(mode, scale, fan_in, len(parts))
        shape = (k, k, cin, c) if i == 0 else (G, k, k, cin, c)
        for p in parts:
            out[f"{prefix}GroupConv_{i}/kernel_{p}"] = (shape, std)
            out[f"{prefix}GroupConv_{i}/bias_{p}"] = ((c,), 0.0)
        cin = c
    return dict(sorted(out.items()))


def c4v(k: int):
    """(elem_idx [G, G], tap_perm [G, k*k]) for C4v acting on
    a k x k kernel: element g = R^r M^m at index 4m + r, with R the
    rotation (i, j) -> (j, -i) and M the mirror (i, j) -> (i, -j);
    elem_idx[g, h] = index of g^-1 h; tap_perm[g, t] = the tap that
    g^-1 maps tap t to (taps row-major over offsets -(k-1)/2..)."""
    rot = np.array([[0, 1], [-1, 0]])
    mir = np.array([[1, 0], [0, -1]])
    mats = [np.linalg.matrix_power(rot, r) @ np.linalg.matrix_power(mir, m)
            for m in range(2) for r in range(4)]

    def index(mat):
        return next(i for i, x in enumerate(mats) if np.array_equal(x, mat))

    inv = [index(np.round(np.linalg.inv(x)).astype(int)) for x in mats]
    elem = np.array([[index(mats[inv[g]] @ mats[h]) for h in range(G)]
                     for g in range(G)])
    half = (k - 1) // 2
    offs = [(i, j) for i in range(-half, half + 1)
            for j in range(-half, half + 1)]
    pos = {o: t for t, o in enumerate(offs)}
    taps = np.array([[pos[tuple(mats[inv[g]] @ np.array(o))] for o in offs]
                     for g in range(G)])
    return elem, taps


def _expand_lift(w: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """[k, k, 1, C] -> [k, k, 1, G*C]: output block g is w at g^-1 taps."""
    k, _, cin, c = w.shape
    flat = w.reshape(k * k, cin, c)
    blocks = [flat[torch.as_tensor(taps[g], device=w.device)]
              for g in range(G)]                       # each [k*k, cin, c]
    return torch.stack(blocks, dim=2).reshape(k, k, cin, G * c)


def _expand_group(w: torch.Tensor, elem: np.ndarray,
                  taps: np.ndarray) -> torch.Tensor:
    """[G, k, k, C, C] -> [k, k, G*C, G*C]: block (input h, output g) is
    w[g^-1 h] at g^-1 taps."""
    _, k, _, cin, c = w.shape
    flat = w.reshape(G, k * k, cin, c)
    out = torch.empty(k * k, G, cin, G, c, dtype=w.dtype, device=w.device)
    for g in range(G):
        t = torch.as_tensor(taps[g], device=w.device)
        for h in range(G):
            out[:, h, :, g, :] = flat[int(elem[g, h])][t]
    return out.reshape(k, k, G * cin, G * c)


def gcnn_sums(cfg: dict, params: Params, s: torch.Tensor,
              prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) [B, G]: the per-element readout sums of the GCNN stack
    (complex weights as re/im pairs, SELU on re and im apart, the skip
    (z + z_in) / sqrt 2 between equal widths after the first layer and
    before the last)."""
    m, shape = cfg["model"], cfg["lattice"]["shape"]
    chans = [int(c) for c in m["channels"]]
    elem, taps = c4v(_kernel(cfg))
    prefix = "params/inner/" if m["spin_flip_sector"] else "params/"
    cplx = bool(m["complex_params"])
    act = {"selu": F.selu, "lncosh": _lncosh}[m["activation"]]
    if m["activation"] != "selu" and cplx:
        raise NotImplementedError("the reference GCNN's complex activation "
                                  "is SELU on re and im")
    batch = s.shape[0]
    x_re = s.reshape(batch, 1, *shape).to(torch.float32)
    x_im = None
    with precision(prec):
        for i, c in enumerate(chans):
            name = f"{prefix}GroupConv_{i}"
            if i == 0:
                a = _expand_lift(params[f"{name}/kernel_re"], taps)
                b = (_expand_lift(params[f"{name}/kernel_im"], taps)
                     if cplx else None)
            else:
                a = _expand_group(params[f"{name}/kernel_re"], elem, taps)
                b = (_expand_group(params[f"{name}/kernel_im"], elem, taps)
                     if cplx else None)
            bias_re = params[f"{name}/bias_re"].repeat(G).reshape(1, -1, 1, 1)
            if cplx:
                bias_im = params[f"{name}/bias_im"].repeat(G).reshape(
                    1, -1, 1, 1)
                if x_im is None:
                    y_re = _conv(x_re, a, prec)
                    y_im = _conv(x_re, b, prec)
                else:
                    y_re = _conv(x_re, a, prec) - _conv(x_im, b, prec)
                    y_im = _conv(x_re, b, prec) + _conv(x_im, a, prec)
                y_re, y_im = act(y_re + bias_re), act(y_im + bias_im)
            else:
                y_re, y_im = act(_conv(x_re, a, prec) + bias_re), None
            if (m["residual"] and 0 < i < len(chans) - 1
                    and c == chans[i - 1]):
                y_re = (y_re + x_re) / math.sqrt(2.0)
                if y_im is not None:
                    y_im = (y_im + x_im) / math.sqrt(2.0)
            x_re, x_im = y_re, y_im
    c_last = chans[-1]
    re = x_re.reshape(batch, G, c_last, -1).sum((2, 3))
    im = (x_im.reshape(batch, G, c_last, -1).sum((2, 3)) if x_im is not None
          else torch.zeros_like(re))
    return re, im


def log_psi(cfg: dict, params: Params, s: torch.Tensor,
            prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """log((1/G) sum_g chi(g) exp S_g), spin-flip projected when the config
    says so: log((psi(s) + sector psi(-s)) / 2)."""
    m = cfg["model"]
    cr, cm = _CHARS[m["gcnn_character"]]
    chi = [cr ** r * cm ** mm for mm in range(2) for r in range(4)]
    phase = torch.tensor([math.pi if x < 0 else 0.0 for x in chi],
                         device=s.device)
    sector = int(m["spin_flip_sector"])
    batch = s.shape[0]
    s_all = torch.cat([s, -s]) if sector else s
    sg_re, sg_im = gcnn_sums(cfg, params, s_all, prec)
    re, im = _logmeanexp(sg_re, sg_im + phase, 1)
    if not sector:
        return re, im
    re, im = re.reshape(2, batch), im.reshape(2, batch)
    if sector == -1:
        im = im + torch.tensor([[0.0], [math.pi]], device=s.device)
    return _logmeanexp(re, im, 0)


def gcnn_flop(hw: int, width: int, n_layers: int, cplx: bool, taps: int = 9
              ) -> float:
    """The least FLOPs of one configuration's group sums at ``width`` = G C
    expanded channels (the program's hand model, frozen here)."""
    lift = taps * hw * width * 2 * (2 if cplx else 1)
    group = taps * hw * width * width * 2 * (3 if cplx else 1)
    if cplx:
        group += 4 * hw * width
    return float(lift + (n_layers - 1) * group)


def forward_flop(cfg: dict) -> float:
    """The least work of the group sums (the lift, 1 real product per part
    for the real input; the group layers, 3 real products per complex
    multiply-add as Karatsuba takes them, plus 4 HW W additions), times 2
    under the spin-flip projection, which evaluates s and -s."""
    m, k = cfg["model"], _kernel(cfg)
    n = math.prod(int(v) for v in cfg["lattice"]["shape"])
    chans = [int(c) for c in m["channels"]]
    flop = gcnn_flop(n, G * chans[0], len(chans), bool(m["complex_params"]),
                     k * k)
    return flop * (2 if m["spin_flip_sector"] else 1)
