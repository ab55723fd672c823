"""Plain PyTorch forwards of the benchmark's wavefunctions, written from
their definitions, and the seeded weights that both the program and this
reference are handed.

Nothing here imports the program. A configuration is the benchmark's JSON
(``configs/<name>.json``, key ``config``): the sections of the YAML as run.

Precision (``prec``):
  * ``"f32"``: float32 with TF32 off for convolutions and matmuls (the
    reference);
  * ``"tf32"``: the same with TF32 on (the control of a float32 config);
  * ``"fp8"``: float32 with every convolution operand rounded to
    float8 e4m3 under a per-tensor scale (the control of a bf16 config);
  * ``"bf16"``: float32 with every convolution operand rounded to bfloat16
    (a bf16 config's own rounding, read as a witness, never as the
    reference).

Parameters are a flat dict keyed like the program's
(``params/RealConv_0/kernel`` [k, k, Cin, Cout], ``.../bias`` [Cout];
``params/inner/GroupConv_i/kernel_re|kernel_im|bias_re|bias_im`` with the
lift kernel [k, k, 1, C] and the group kernels [8, k, k, C, C]).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
#: order of C4v
G = 8
_LOG2 = math.log(2.0)
_FP8_MAX = 448.0


@contextlib.contextmanager
def precision(prec: str):
    """TF32 on (``tf32``) or off (``f32``, ``fp8``, ``bf16``) for the
    enclosed block; the previous flags come back on exit."""
    if prec not in ("f32", "tf32", "fp8", "bf16"):
        raise ValueError(f"unknown precision {prec!r}")
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = _FP8_MAX / amax
    q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32)
    return q / scale


def _conv(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """Circular cross-correlation of x [B, Cin, H, W] with w [k, k, Cin,
    Cout] (offsets -(k-1)//2 .. k-1-(k-1)//2 along each axis)."""
    k = w.shape[0]
    lo = (k - 1) // 2
    hi = k - 1 - lo
    xp = F.pad(x, (lo, hi, lo, hi), mode="circular")
    wt = w.permute(3, 2, 0, 1)
    if prec == "fp8":
        xp, wt = fp8_round(xp), fp8_round(wt)
    elif prec == "bf16":
        xp = xp.to(torch.bfloat16).to(torch.float32)
        wt = wt.to(torch.bfloat16).to(torch.float32)
    return F.conv2d(xp, wt)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def param_layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)} of the configured model, in sorted key order;
    std 0 for the biases (zero at init)."""
    m, lat = cfg["model"], cfg["lattice"]
    k = min(int(m["kernel_size"]), *lat["shape"])
    chans = [int(c) for c in m["channels"]]
    scale, mode = float(m["param_scale"]), m["init_mode"]
    out = {}
    if m["kind"] == "cnn":
        if m["complex_params"]:
            raise NotImplementedError("the reference CNN is the real one")
        cin = 1
        for i, c in enumerate(chans):
            std = _std(mode, scale, k * k * cin, 1)
            if mode == "fan_in" and i == len(chans) - 1:
                std *= 0.1 / math.sqrt(math.prod(lat["shape"]) * c)
            out[f"params/RealConv_{i}/kernel"] = ((k, k, cin, c), std)
            out[f"params/RealConv_{i}/bias"] = ((c,), 0.0)
            cin = c
    elif m["kind"] == "gcnn":
        if k % 2 == 0:
            k -= 1
        prefix = "params/inner/" if m["spin_flip_sector"] else "params/"
        parts = ("re", "im") if m["complex_params"] else ("re",)
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
    else:
        raise NotImplementedError(f"no reference for model {m['kind']!r}")
    return dict(sorted(out.items()))


def _std(mode: str, scale: float, fan_in: int, parts: int) -> float:
    if mode == "fixed":
        return scale
    if mode == "fan_in":
        return scale / math.sqrt(parts * fan_in)
    raise ValueError(f"unknown init_mode {mode!r}")


def make_params(cfg: dict, seed: int, device,
                std: Optional[Dict[str, float]] = None) -> Params:
    """The weights of ``seed``: one normal draw of every entry on
    ``device`` from a generator seeded there, scaled per leaf by ``std``
    (a table of every leaf's standard deviation) or, without one, by the
    config's init rule (biases zero as the init leaves them)."""
    layout = param_layout(cfg)
    if std is not None:
        if sorted(std) != sorted(layout):
            raise ValueError("the weight table does not name the model's "
                             f"leaves: {sorted(std)} != {sorted(layout)}")
        layout = {k: (shape, float(std[k])) for k, (shape, _) in
                  layout.items()}
    total = sum(math.prod(shape) for shape, _ in layout.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for key, (shape, std) in layout.items():
        n = math.prod(shape)
        out[key] = (flat[pos:pos + n] * std).reshape(shape).contiguous()
        pos += n
    return out


# ---------------------------------------------------------------------------
# the real CNN
# ---------------------------------------------------------------------------

def _lncosh(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return a - _LOG2 + torch.log1p(torch.exp(-2.0 * a))


def cnn_log_psi(cfg: dict, params: Params, s: torch.Tensor,
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


# ---------------------------------------------------------------------------
# the C4v group-convolutional network
# ---------------------------------------------------------------------------

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
    k = min(int(m["kernel_size"]), *shape)
    k = k - 1 if k % 2 == 0 else k
    elem, taps = c4v(k)
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


_CHARS = {"A1": (1, 1), "A2": (1, -1), "B1": (-1, 1), "B2": (-1, -1)}


def _logmeanexp(re: torch.Tensor, im: torch.Tensor, dim: int):
    """log mean exp of the complex values (re, im) along ``dim``."""
    top = re.amax(dim=dim, keepdim=True).detach()
    w = torch.exp(re - top)
    sr, si = (w * torch.cos(im)).mean(dim), (w * torch.sin(im)).mean(dim)
    return (0.5 * torch.log(sr * sr + si * si) + top.squeeze(dim),
            torch.atan2(si, sr))


def gcnn_log_psi(cfg: dict, params: Params, s: torch.Tensor,
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


def log_psi(cfg: dict, params: Params, s: torch.Tensor, prec: str = "f32"):
    """(re, im) log psi of the configured model on s [B, N]."""
    kind = cfg["model"]["kind"]
    if kind == "cnn":
        return cnn_log_psi(cfg, params, s, prec)
    if kind == "gcnn":
        return gcnn_log_psi(cfg, params, s, prec)
    raise NotImplementedError(f"no reference for model {kind!r}")


def log_psi_blocks(cfg: dict, params: Params, s: torch.Tensor,
                   prec: str = "f32", block: int = 65536):
    """:func:`log_psi` under ``no_grad`` in blocks of rows."""
    res, ims = [], []
    with torch.no_grad():
        for i in range(0, s.shape[0], block):
            re, im = log_psi(cfg, params, s[i:i + block], prec)
            res.append(re)
            ims.append(im)
    return torch.cat(res), torch.cat(ims)
