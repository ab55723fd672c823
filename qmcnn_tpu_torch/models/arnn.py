"""Autoregressive log-amplitude ansatz (ARNN) with exact sampling (port of
``qmcnn_tpu/models/arnn.py``).

    psi(s) = prod_i sqrt(p(s_i | s_<i)) * exp(i phi(s)),

so |psi|^2 is exactly normalized and the direct sampler
(``sampler/direct.py``) draws it site by site: the PixelCNN trunk through
a ``SiteCache`` (each site computes only its own position at every layer),
the MADE trunk by one full forward per site.

Two trunks, both autoregressive in the raster site order:
  * MADE: masked dense layers over the flattened configuration; input site
    j has degree j + 1, hidden unit k degree (k mod (N - 1)) + 1, a weight
    is kept iff m_out >= m_in, and hidden unit m feeds output site i iff
    m <= i, so output i sees s_<i only;
  * PixelCNN (``conv_kernel > 0``, 2D lattices): raster-causal k x k
    convolutions (mask A, then mask B with the center tap), padded with
    zeros, since the causal order must not wrap around the torus.

The masks multiply the kernels at every call (the parameters keep the
unmasked Flax layouts: ``params/w0`` ``[N, H]``, ``params/conv0``
``[k, k, Cin, C]``). The S^z = 0 sector is baked into the conditionals:
with u ups placed before site i, p_up is forced to 1 when the remaining
ups fill every remaining site and to 0 when none are left; a forbidden
branch gets log-probability -100 (never -inf, so gradients stay finite).
Complex models read per-site phases, chosen by the realized spin, from the
same head forward as the logits. A fixed phase prior (``phase_half_angles``)
adds i sum_i theta_i s_i / 2 and leaves |psi| untouched.

Tracing (``utils/profiling``): the span ``arnn`` (with a CUDA event pair)
covers a log-psi forward from the trunk to the summed log-probabilities
and phases, ``arnn.cond`` (host times only) a conditional of the direct
sampler's, a full forward or one cached site; each is one flag test while
nothing records. The counter ``arnn.rows`` adds the configurations of
every full forward of either kind, ``torch.func.vmap``'s batch included
(always on); a cached site adds none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qmcnn_tpu_torch.models.cnn import Params, module_names, true_f32
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.utils.profiling import annotate, batch_rows, count

#: log-prob of a sector-forbidden branch: exp(-100) is 0 in any f32
#: amplitude ratio, and its gradient stays finite
_FORBIDDEN = -100.0


def made_degrees(n_sites: int, widths: Tuple[int, ...]):
    """[input degrees 1..N, hidden degrees cycling over 1..N-1, ...]."""
    degs = [np.arange(1, n_sites + 1)]
    for w in widths:
        degs.append(np.arange(w) % max(n_sites - 1, 1) + 1)
    return degs


def made_masks(n_sites: int, widths: Tuple[int, ...]):
    """Float32 masks input -> h1, h -> h, ..., last h -> output ([H, N],
    per site; callers tile it over the output heads)."""
    degs = made_degrees(n_sites, widths)
    masks = [(d_out[None, :] >= d_in[:, None]).astype(np.float32)
             for d_in, d_out in zip(degs[:-1], degs[1:])]
    out_deg = np.arange(1, n_sites + 1)
    masks.append((degs[-1][:, None] <= out_deg[None, :] - 1)
                 .astype(np.float32))
    return masks


def causal_conv_mask(k: int, include_center: bool) -> np.ndarray:
    """[k, k] raster-causal tap mask: rows above the center, and the
    center row left of it; ``include_center`` (mask B) adds the center."""
    c = k // 2
    m = np.zeros((k, k), np.float32)
    m[:c, :] = 1.0
    m[c, :c] = 1.0
    if include_center:
        m[c, c] = 1.0
    return m


class LogPsiARNN(nn.Module):
    """Masked autoregressive log-amplitude over flattened spin
    configurations; the fields of the JAX ``LogPsiARNN``.

    ``forward(s)`` is log psi; ``forward(s, conditionals=True)`` returns
    (log_p_up [B, N], log_p_dn [B, N]), column i given s_<i.
    """

    def __init__(self, n_sites: int, hidden: Tuple[int, ...] = (64, 64),
                 complex_params: bool = False, sz_zero: bool = False,
                 param_scale: float = 1.0, activation: str = "selu",
                 conv_kernel: int = 0,
                 lattice_shape: Optional[Tuple[int, ...]] = None,
                 phase_half_angles: Optional[Tuple[float, ...]] = None):
        super().__init__()
        if activation not in cplx.ACTIVATIONS:
            raise KeyError(activation)
        self.n_sites = n_sites
        self.hidden = tuple(hidden)
        self.complex_params = complex_params
        self.sz_zero = sz_zero
        self.activation = activation
        self.conv_kernel = conv_kernel
        self.lattice_shape = (None if lattice_shape is None
                              else tuple(lattice_shape))
        self.n_heads = 3 if complex_params else 1
        self._consts = {}
        self._half = (None if phase_half_angles is None
                      else np.asarray(phase_half_angles, np.float32))
        #: (name, shape, std) of every parameter; std None: zeros
        self.specs = []
        if conv_kernel:
            if self.lattice_shape is None or len(self.lattice_shape) != 2:
                raise ValueError("conv_kernel > 0 needs a 2D lattice_shape")
            k = conv_kernel
            if k % 2 == 0 or k < 3:
                raise ValueError(f"conv_kernel must be odd >= 3, got {k}")
            self.masks = [causal_conv_mask(k, include_center=li > 0)
                          for li in range(len(self.hidden))]
            c_in = 1
            for li, ch in enumerate(self.hidden):
                fan_in = max(float(self.masks[li].sum()) * c_in, 2.0)
                self.specs += [(f"conv{li}", (k, k, c_in, ch),
                                param_scale / np.sqrt(fan_in)),
                               (f"cb{li}", (ch,), None)]
                c_in = ch
            self.specs += [("conv_out", (1, 1, c_in, self.n_heads),
                            param_scale / np.sqrt(max(c_in, 2))),
                           ("cb_out", (self.n_heads,), None)]
        else:
            self.masks = made_masks(n_sites, self.hidden)
            f_in = n_sites
            for li, w in enumerate(self.hidden):
                # fan-in on the unmasked weight count per unit (~f_in / 2)
                std = param_scale / np.sqrt(max(f_in, 2) / 2.0)
                self.specs += [(f"w{li}", (f_in, w), std),
                               (f"b{li}", (w,), None)]
                f_in = w
            self.masks[-1] = np.tile(self.masks[-1], (1, self.n_heads))
            self.specs += [("w_out", (f_in, n_sites * self.n_heads),
                            param_scale / np.sqrt(max(f_in, 2) / 2.0)),
                           ("b_out", (n_sites * self.n_heads,), None)]
        for name, shape, _ in self.specs:
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def _const(self, name: str, value: np.ndarray, device) -> torch.Tensor:
        """A host constant on ``device``, copied there once."""
        key = (name, str(device))
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(value, device=device)
        return self._consts[key]

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return cplx.ACTIVATIONS[self.activation][1](x)

    def _heads(self, s: torch.Tensor):
        """(logit [B, N], phase_up, phase_dn); the phases are None for a
        real model."""
        with true_f32():
            if self.conv_kernel:
                out = self._heads_conv(s)
            else:
                out = self._heads_made(s)
        if self.complex_params:
            return out[..., 0], out[..., 1], out[..., 2]
        return out[..., 0], None, None

    def _heads_made(self, s: torch.Tensor) -> torch.Tensor:
        x = s
        for li in range(len(self.hidden)):
            mask = self._const(f"m{li}", self.masks[li], s.device)
            x = self._act(x @ (getattr(self, f"w{li}") * mask)
                          + getattr(self, f"b{li}"))
        mask = self._const("m_out", self.masks[-1], s.device)
        out = x @ (self.w_out * mask) + self.b_out       # [B, heads * N]
        return out.reshape(s.shape[0], self.n_heads, self.n_sites
                           ).transpose(1, 2)

    def _heads_conv(self, s: torch.Tensor) -> torch.Tensor:
        h, w = self.lattice_shape
        b = s.shape[0]
        x = s.reshape(b, 1, h, w)
        pad = self.conv_kernel // 2
        for li in range(len(self.hidden)):
            mask = self._const(f"m{li}", self.masks[li], s.device)
            kern = getattr(self, f"conv{li}") * mask[:, :, None, None]
            # zero padding: raster causality must not wrap around the torus
            x = F.conv2d(x, kern.permute(3, 2, 0, 1), padding=pad)
            x = self._act(x + getattr(self, f"cb{li}").reshape(-1, 1, 1))
        out = F.conv2d(x, self.conv_out.permute(3, 2, 0, 1))
        out = out + self.cb_out.reshape(-1, 1, 1)      # [B, heads, H, W]
        return out.permute(0, 2, 3, 1).reshape(b, self.n_sites, self.n_heads)

    def _forced(self, ups_before: torch.Tensor, sites_left):
        """(force_up, force_dn) of the S^z = 0 sector: the remaining ups
        fill every remaining site, or none is left (both counts include
        the site drawn)."""
        ups_left = self.n_sites / 2.0 - ups_before
        return ups_left >= sites_left, ups_left <= 0.0

    def _conditionals(self, s: torch.Tensor, logit: torch.Tensor):
        log_p_up = F.logsigmoid(logit)
        log_p_dn = F.logsigmoid(-logit)
        if not self.sz_zero:
            return log_p_up, log_p_dn
        n = self.n_sites
        up = (s > 0).to(torch.float32)
        u = torch.cumsum(up, dim=-1) - up  # ups placed before each site
        i = torch.arange(n, dtype=torch.float32, device=s.device)
        force_up, force_dn = self._forced(u, n - i)
        return (_pin(log_p_up, force_up, force_dn),
                _pin(log_p_dn, force_dn, force_up))

    def _site_windows(self, device):
        """The static layout of a ``SiteCache``: per layer, the flat kernel
        taps its mask keeps [T] and their offsets in a site's window [T];
        the window's length; each site's window start (host ints). Built
        once a device."""
        key = ("site_windows", str(device))
        if key not in self._consts:
            h, w = self.lattice_shape
            k = self.conv_kernel
            pad = k // 2
            width = w + 2 * pad
            layers = []
            for mask in self.masks:
                dy, dx = np.nonzero(mask)
                layers.append((torch.as_tensor(dy * k + dx, device=device),
                               torch.as_tensor(dy * width + dx,
                                               device=device)))
            r, c = np.divmod(np.arange(h * w), w)
            self._consts[key] = (layers, pad * width + pad + 1,
                                 (r * width + c).tolist())
        return self._consts[key]

    def forward(self, s: torch.Tensor, conditionals: bool = False):
        count("arnn.rows", batch_rows(s))
        if conditionals:
            with annotate("arnn.cond", device=False):
                logit, _, _ = self._heads(s)
                return self._conditionals(s, logit)
        with annotate("arnn"):
            logit, ph_up, ph_dn = self._heads(s)
            log_p_up, log_p_dn = self._conditionals(s, logit)
            is_up = s > 0
            re = 0.5 * torch.where(is_up, log_p_up, log_p_dn).sum(-1)
            im = torch.zeros_like(re)
            if self._half is not None:
                with true_f32():
                    im = im + s.to(torch.float32) @ self._const(
                        "half", self._half, s.device)
            if self.complex_params:
                im = im + torch.where(is_up, ph_up, ph_dn).sum(-1)
            return C(re, im)

    def init(self, seed: int, device="cpu") -> Params:
        """Fresh flat Flax-keyed parameters: normal(std) kernels, zero
        biases (torch draws, not the JAX init's)."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape, std in self.specs:
            t = (torch.zeros(shape) if std is None
                 else torch.randn(shape, generator=gen) * std)
            out[f"params/{name}"] = t.to(device)
        return out


def _pin(log_p: torch.Tensor, to_zero: torch.Tensor,
         to_forbidden: torch.Tensor) -> torch.Tensor:
    """``log_p`` with 0 where ``to_zero`` and ``_FORBIDDEN`` where
    ``to_forbidden`` (a sector-forced branch)."""
    return torch.where(to_zero, 0.0,
                       torch.where(to_forbidden, _FORBIDDEN, log_p))


class SiteCache:
    """The PixelCNN trunk's activations over one ancestral pass of M
    walkers, so that drawing site i computes position i only, at every
    layer and the head.

    Exact, the same sums in another order: a layer-0 value at site p reads
    spins at sites < p only (mask A), a later layer's value reads the
    layer below at p and its causal taps (mask B), so every activation at
    p is final once the sites < p are drawn. Each layer's input lives in a
    zero buffer [M, (H + pad) (W + 2 pad), C_in], padded above and on
    both sides as ``F.conv2d(padding=pad)`` pads; a site not drawn yet
    holds 0 in the spin buffer (-1 in the full forward's input), which no
    mask-A tap reads. In raster order a site's taps all lie in one run of
    positions, from its top-left tap to itself (its window, pad (W + 2 pad)
    + pad + 1 positions), so a site's layer is one ``addmm`` of that window
    (a view, no gather) with the layer's kernel laid out over the window
    (the taps its mask keeps, zeros between them) and the bias, the
    model's activation, and one copy into position i.
    """

    def __init__(self, model: LogPsiARNN, weights: Params, m: int, device):
        h, w = model.lattice_shape
        k, pad = model.conv_kernel, model.conv_kernel // 2
        self.model = model
        layers, self.span, self.starts = model._site_windows(device)
        # each layer's kernel over the window, once a pass (the params
        # move every step)
        self.mats = []
        for li, (ch, (ktaps, offsets)) in enumerate(zip(model.hidden,
                                                        layers)):
            kern = weights[f"conv{li}"].reshape(k * k, -1, ch)
            mat = torch.zeros(self.span, kern.shape[1], ch, device=device)
            mat.index_copy_(0, offsets, kern.index_select(0, ktaps))
            self.mats.append(mat.reshape(-1, ch))
        self.biases = [weights[f"cb{li}"] for li in range(len(model.hidden))]
        self.w_head = weights["conv_out"][0, 0, :, 0].contiguous()
        self.b_head = weights["cb_out"][0]
        size = (h + pad) * (w + 2 * pad)
        # layer li's input; the last layer's output feeds the head only
        self.bufs = [torch.zeros(m, size, c, device=device)
                     for c in (1,) + model.hidden[:-1]]
        self.spins = self.bufs[0].select(2, 0)
        self.ups = torch.zeros(m, device=device)  # ups placed so far

    def log_p_up(self, i: int) -> torch.Tensor:
        """log p(s_i = +1 | s_<i) [M], the sector forced as
        ``LogPsiARNN._conditionals`` forces it."""
        model = self.model
        start = self.starts[i]
        with annotate("arnn.cond", device=False), true_f32():
            for li, (mat, bias) in enumerate(zip(self.mats, self.biases)):
                window = self.bufs[li].narrow(1, start, self.span)
                x = model._act(torch.addmm(bias, window.flatten(1), mat))
                if li + 1 < len(self.bufs):
                    self.bufs[li + 1].select(1, start + self.span - 1
                                             ).copy_(x)
            log_p_up = F.logsigmoid(torch.addmv(self.b_head, x, self.w_head))
            if not model.sz_zero:
                return log_p_up
            force_up, force_dn = model._forced(self.ups,
                                               model.n_sites - i)
            return _pin(log_p_up, force_up, force_dn)

    def place(self, i: int, spins: torch.Tensor) -> None:
        """Site i's drawn spins [M] (+-1) into the cache."""
        self.spins.select(1, self.starts[i] + self.span - 1).copy_(spins)
        if self.model.sz_zero:
            self.ups += spins > 0


def conditional_fn(model: LogPsiARNN, prefix: str = "params/"):
    """(params, s [B, N]) -> (log_p_up, log_p_dn) of ``model``, whose
    parameters are the keys under ``prefix`` (``params/inner/`` for an
    ARNN inside a wrapper). For the PixelCNN trunk the function also
    carries ``site_cache(params, m, device)``, a fresh ``SiteCache`` for
    one ancestral pass of m walkers."""

    def own(params: Params) -> Params:
        return module_names({"params/" + k[len(prefix):]: v
                             for k, v in params.items()
                             if k.startswith(prefix)})

    def fn(params: Params, s: torch.Tensor):
        return torch.func.functional_call(model, own(params), (s,),
                                          {"conditionals": True},
                                          strict=True)

    if model.conv_kernel:
        fn.site_cache = lambda params, m, device: SiteCache(
            model, own(params), m, device)
    return fn
