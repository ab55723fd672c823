"""The Vision Transformer wavefunction (``model.kind: vit``) with factored
attention, written from its equations (Viteritti, Rende, Becca,
arXiv:2211.05504; the Deep ViT of Rende et al., arXiv:2310.05715):

  * patches: the L x L spins cut into p x p patches, T = (L / p)^2 tokens
    in row-major patch order, each the p^2 spins of its patch in row-major
    order; embedded by x W_e + b_e (width d);
  * each of the blocks, pre-LN:
      x <- x + (A  LN_1(x) W_v + b_v) W_o + b_o,
      x <- x + GELU(LN_2(x) W_1 + b_1) W_2 + b_2,
    LN(x) = (x - E[x]) / sqrt(var + 1e-6) * g + b with
    var = max(E[x^2] - E[x]^2, 0) over the features; the value of token j
    split into H heads of d / H features; head h's weights
    A_h[i, j] = softmax over j of r_h[(pos_i - pos_j) mod the patch
    torus], the same for every configuration (factored: no queries or
    keys); GELU the tanh form x (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3))) / 2;
  * LN_f, then z = h W_re + b_re + i (h W_im + b_im) per token and
    feature, and log psi = sum over tokens and features of log cosh z;
  * the p^2 sub-patch translations projected out: log psi(s) =
    log mean_t psi_t(T_t s) over the rolls of the lattice by (a, b),
    0 <= a, b < p;
  * under ``spin_flip_sector``: log((psi(s) + sector psi(-s)) / 2).

Departures from the papers' description, kept because they are the
repository's ViT: the position weights are softmax-normalised per head,
the output layer is a complex lncosh per token and feature (not one
amplitude per configuration), and the sub-patch translations are projected
exactly by the logmeanexp. The real head (``complex_params`` false) is
log psi = sum lncosh(h W_re + b_re).

Parameters (the program's Flax keys, ``params/inner/...`` under the
spin-flip projection): ``embed``, ``block<i>/ln1``, ``block<i>/attn/
relpos_bias`` [H, T], ``block<i>/attn/v`` (kernel [d, H, d / H], bias
[H, d / H]), ``block<i>/attn/proj``, ``block<i>/ln2``, ``block<i>/mlp1``,
``block<i>/mlp2``, ``ln_f``, ``head_re``, ``head_im``; layer norms hold
``scale`` and ``bias``, dense layers ``kernel`` [in, out] and ``bias``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.models import (Params, _logmeanexp, fp8_round,
                                        precision)

_EPS = 1e-6
_LOG2 = math.log(2.0)


def _sizes(cfg: dict):
    m, lat = cfg["model"], cfg["lattice"]
    shape = [int(v) for v in lat["shape"]]
    p = int(m["vit_patch"])
    d = int(m["channels"][0])
    heads = int(m["vit_heads"])
    if len(shape) != 2 or any(v % p for v in shape):
        raise NotImplementedError("the reference ViT patches a 2D lattice "
                                  "whose sides the patch divides")
    if not m["vit_factored"]:
        raise NotImplementedError("the reference ViT's attention is the "
                                  "factored one")
    if len(set(int(c) for c in m["channels"])) != 1 or d % heads:
        raise ValueError("a ViT has one width, divisible by the heads")
    grid = (shape[0] // p, shape[1] // p)
    return shape, p, d, heads, grid, int(m["vit_mlp_ratio"]) * d


def _prefix(cfg: dict) -> str:
    return "params/inner/" if cfg["model"]["spin_flip_sector"] else "params/"


def layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)}: kernels at 1 / sqrt(fan in), the position
    biases at 0.5, the head at param_scale / sqrt(d), biases 0, and the
    layer-norm scales (one at the init) drawn at std 1."""
    _, p, d, heads, grid, hidden = _sizes(cfg)
    m = cfg["model"]
    pre = _prefix(cfg)
    out = {}

    def dense(name, d_in, shape, std=None):
        out[f"{pre}{name}/kernel"] = (shape, std or 1.0 / math.sqrt(d_in))
        out[f"{pre}{name}/bias"] = (shape[1:], 0.0)

    def norm(name):
        out[f"{pre}{name}/scale"] = ((d,), 1.0)
        out[f"{pre}{name}/bias"] = ((d,), 0.0)

    dense("embed", p * p, (p * p, d))
    for i in range(len(m["channels"])):
        b = f"block{i}"
        norm(f"{b}/ln1")
        out[f"{pre}{b}/attn/relpos_bias"] = ((heads, grid[0] * grid[1]), 0.5)
        dense(f"{b}/attn/v", d, (d, heads, d // heads))
        dense(f"{b}/attn/proj", d, (d, d))
        norm(f"{b}/ln2")
        dense(f"{b}/mlp1", d, (d, hidden))
        dense(f"{b}/mlp2", hidden, (hidden, d))
    norm("ln_f")
    head = float(m["param_scale"]) / math.sqrt(d)
    dense("head_re", d, (d, d), head)
    if m["complex_params"]:
        dense("head_im", d, (d, d), head)
    return dict(sorted(out.items()))


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's operand as ``prec`` rounds it (``fp8``, ``bf16``)."""
    if prec == "fp8":
        return fp8_round(x)
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _matmul(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    return _round(x, prec) @ _round(w, prec)


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) / torch.sqrt(var + _EPS) * scale + bias


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _log_cosh(re: torch.Tensor, im: torch.Tensor):
    """(re, im) of log cosh(re + i im): with w = a + ib = +-(re + i im),
    a >= 0, log cosh w = w - log 2 + log(1 + e^{-2w})."""
    flip = re < 0
    a = torch.where(flip, -re, re)
    b = torch.where(flip, -im, im)
    q = torch.exp(-2.0 * a)
    x, y = 1.0 + q * torch.cos(2.0 * b), -q * torch.sin(2.0 * b)
    return (a - _LOG2 + 0.5 * torch.log(x * x + y * y),
            b + torch.atan2(y, x))


def _position_index(grid) -> np.ndarray:
    """[T, T]: the flat index of (pos_i - pos_j) mod the patch torus."""
    gx, gy = grid
    xs, ys = np.divmod(np.arange(gx * gy), gy)
    dx = (xs[:, None] - xs[None, :]) % gx
    dy = (ys[:, None] - ys[None, :]) % gy
    return dx * gy + dy


def _sums(cfg: dict, params: Params, s: torch.Tensor, prec: str):
    """(re, im) [B, p^2]: log psi of each sub-patch roll of s."""
    shape, p, d, heads, grid, _ = _sizes(cfg)
    pre = _prefix(cfg)
    m = cfg["model"]
    batch, t = s.shape[0], grid[0] * grid[1]
    lattice = s.reshape(batch, *shape).to(torch.float32)
    rolls = [torch.roll(lattice, (a, b), dims=(1, 2))
             for a in range(p) for b in range(p)]
    x = torch.stack(rolls, 1).reshape(batch * p * p, grid[0], p, grid[1], p)
    x = x.permute(0, 1, 3, 2, 4).reshape(-1, t, p * p)
    idx = torch.as_tensor(_position_index(grid), device=s.device)

    def w(name):
        return params[f"{pre}{name}"]

    def dense(name, h):
        return _matmul(h, w(f"{name}/kernel"), prec) + w(f"{name}/bias")

    with precision(prec):
        h = dense("embed", x)
        for i in range(len(m["channels"])):
            b = f"block{i}"
            y = _norm(h, w(f"{b}/ln1/scale"), w(f"{b}/ln1/bias"))
            v = _matmul(y, w(f"{b}/attn/v/kernel").reshape(d, d), prec)
            v = v + w(f"{b}/attn/v/bias").reshape(d)
            # head h mixes its d / H features of every token: [H, T, B hd]
            v = v.reshape(-1, t, heads, d // heads).permute(2, 1, 0, 3)
            att = torch.softmax(w(f"{b}/attn/relpos_bias")[:, idx], -1)
            mixed = _matmul(att, v.reshape(heads, t, -1), prec)
            mixed = mixed.reshape(heads, t, -1, d // heads).permute(
                2, 1, 0, 3).reshape(-1, t, d)
            h = h + dense(f"{b}/attn/proj", mixed)
            y = _norm(h, w(f"{b}/ln2/scale"), w(f"{b}/ln2/bias"))
            h = h + dense(f"{b}/mlp2", _gelu(dense(f"{b}/mlp1", y)))
        h = _norm(h, w("ln_f/scale"), w("ln_f/bias"))
        z_re = dense("head_re", h)
        z_im = (dense("head_im", h) if m["complex_params"]
                else torch.zeros_like(z_re))
    re, im = _log_cosh(z_re, z_im)
    return (re.reshape(batch, p * p, -1).sum(-1),
            im.reshape(batch, p * p, -1).sum(-1))


def log_psi(cfg: dict, params: Params, s: torch.Tensor,
            prec: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """log mean over the sub-patch rolls of psi, spin-flip projected when
    the config says so."""
    sector = int(cfg["model"]["spin_flip_sector"])
    batch = s.shape[0]
    s_all = torch.cat([s, -s]) if sector else s
    re, im = _logmeanexp(*_sums(cfg, params, s_all, prec), 1)
    if not sector:
        return re, im
    re, im = re.reshape(2, batch), im.reshape(2, batch)
    if sector == -1:
        im = im + torch.tensor([[0.0], [math.pi]], device=s.device)
    return _logmeanexp(re, im, 0)


def forward_flop(cfg: dict) -> float:
    """Per rolled copy: the embedding (2 T p^2 d), per block the value and
    output projections (2 T 2 d^2), the MLP (2 T 2 d r d) and the position
    mixing (2 T T d), and the head (2 T d^2 per part); times the p^2
    copies, and 2 under the spin-flip projection."""
    _, p, d, _, grid, hidden = _sizes(cfg)
    m = cfg["model"]
    t = grid[0] * grid[1]
    block = 2.0 * t * (2 * d * d + 2 * d * hidden + t * d)
    parts = 2 if m["complex_params"] else 1
    copy = (2.0 * t * p * p * d + len(m["channels"]) * block
            + parts * 2.0 * t * d * d)
    return copy * p * p * (2 if m["spin_flip_sector"] else 1)
