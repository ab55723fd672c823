"""The real lncosh CNN (``model.kind: cnn``): circular convolutions, each
followed by lncosh, then the sum over sites and channels.

Parameters: ``params/RealConv_i/kernel`` [k, k, Cin, Cout] and
``params/RealConv_i/bias`` [Cout], k = min(kernel_size, the lattice's
sides).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.models import (Params, _conv, _lncosh, _std,
                                        precision)


def _kernel(cfg: dict) -> int:
    return min(int(cfg["model"]["kernel_size"]), *cfg["lattice"]["shape"])


def layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)}; std 0 for the biases (zero at init)."""
    m, lat = cfg["model"], cfg["lattice"]
    if m["complex_params"]:
        raise NotImplementedError("the reference CNN is the real one")
    k = _kernel(cfg)
    scale, mode = float(m["param_scale"]), m["init_mode"]
    chans = [int(c) for c in m["channels"]]
    out = {}
    cin = 1
    for i, c in enumerate(chans):
        std = _std(mode, scale, k * k * cin, 1)
        if mode == "fan_in" and i == len(chans) - 1:
            std *= 0.1 / math.sqrt(math.prod(lat["shape"]) * c)
        out[f"params/RealConv_{i}/kernel"] = ((k, k, cin, c), std)
        out[f"params/RealConv_{i}/bias"] = ((c,), 0.0)
        cin = c
    return dict(sorted(out.items()))


def log_psi(cfg: dict, params: Params, s: torch.Tensor,
            prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) log psi of s [B, N]: lncosh(conv + b) per layer, then the
    sum over sites and channels."""
    shape = cfg["lattice"]["shape"]
    n_layers = len(cfg["model"]["channels"])
    x = s.reshape(s.shape[0], 1, *shape).to(torch.float32)
    with precision(prec):
        for i in range(n_layers):
            w = params[f"params/RealConv_{i}/kernel"]
            b = params[f"params/RealConv_{i}/bias"]
            x = _lncosh(_conv(x, w, prec) + b.reshape(1, -1, 1, 1))
    re = x.reshape(s.shape[0], -1).sum(-1)
    return re, torch.zeros_like(re)


def forward_flop(cfg: dict) -> float:
    """The convolutions: 2 N k^2 Cin Cout per layer."""
    m, k = cfg["model"], _kernel(cfg)
    n = math.prod(int(v) for v in cfg["lattice"]["shape"])
    cin, flop = 1, 0.0
    for c in (int(c) for c in m["channels"]):
        flop += 2.0 * n * k * k * cin * c * (2 if m["complex_params"] else 1)
        cin = c
    return flop
