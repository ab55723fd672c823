"""Plain PyTorch forwards of the benchmark's wavefunctions, written from
their definitions, and the seeded weights that both the program and this
reference are handed.

Nothing here imports the program. A configuration is the benchmark's JSON
(``configs/<name>.json``, key ``config``): the sections of the YAML as run.

Each model kind is one file beside this one, loaded by :func:`kind_of`:
``kinds/<model.kind>.py`` on the hypercubic lattice and
``kinds/<model.kind>_<lattice.geometry>.py`` on any other (the rule of
``files.py``). It imports nothing of the program and defines

  * ``layout(cfg) -> {key: (shape, std)}``: the program's flat parameter
    keys in sorted order, each with its shape and the standard deviation
    of its init (0 for leaves that start at zero);
  * ``log_psi(cfg, params, s, prec) -> (re, im)``: log psi of s [B, N] in
    float32, honouring ``prec`` as below;
  * ``forward_flop(cfg) -> float``: the least FLOPs of one evaluation
    forward of one configuration, under the rules of ``counts/flops.py``.

A new kind, or a kind on a new lattice, is a new file there; nothing here
changes.

Precision (``prec``):
  * ``"f32"``: float32 with TF32 off for convolutions and matmuls (the
    reference);
  * ``"tf32"``: the same with TF32 on (the control of a float32 config);
  * ``"fp8"``: float32 with every convolution operand rounded to
    float8 e4m3 under a per-tensor scale (the control of a bf16 config);
  * ``"bf16"``: float32 with every convolution operand rounded to bfloat16
    (a bf16 config's own rounding, read as a witness, never as the
    reference).
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import files

Params = Dict[str, torch.Tensor]
_LOG2 = math.log(2.0)
_FP8_MAX = 448.0
#: the kind files
KINDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kinds")


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
# the kinds
# ---------------------------------------------------------------------------

@functools.cache
def kind(name: str):
    """The module of ``kinds/<name>.py``, loaded by path once a process
    (``spec.cell`` refuses a configuration whose kind has no file)."""
    return files.load(os.path.join(KINDS, f"{name}.py"),
                      f"benchmark_kind_{name}")


def kind_of(cfg: dict):
    """The module of the configuration's kind file (``files.kind_name``)."""
    return kind(files.kind_name(cfg))


def param_layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, std)} of the configured model, in sorted key order;
    std 0 for the leaves that start at zero."""
    return kind_of(cfg).layout(cfg)


def log_psi(cfg: dict, params: Params, s: torch.Tensor, prec: str = "f32"):
    """(re, im) log psi of the configured model on s [B, N]."""
    return kind_of(cfg).log_psi(cfg, params, s, prec)


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


# ---------------------------------------------------------------------------
# what the kinds share
# ---------------------------------------------------------------------------

def _lncosh(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return a - _LOG2 + torch.log1p(torch.exp(-2.0 * a))


def _logmeanexp(re: torch.Tensor, im: torch.Tensor, dim: int):
    """log mean exp of the complex values (re, im) along ``dim``."""
    top = re.amax(dim=dim, keepdim=True).detach()
    w = torch.exp(re - top)
    sr, si = (w * torch.cos(im)).mean(dim), (w * torch.sin(im)).mean(dim)
    return (0.5 * torch.log(sr * sr + si * si) + top.squeeze(dim),
            torch.atan2(si, sr))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

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

