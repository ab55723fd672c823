"""Fused GCNN forward: the CUDA kernel's wrapper, its plain version and the
evaluation-only log psi built on them (port of
``qmcnn_tpu/kernels/gcnn_pallas.py``).

  * :func:`expand_gcnn_params` gathers the flat Flax-keyed GCNN parameters
    into G-expanded, tap-major dense kernels (``GCNNWeights``);
  * :func:`gcnn_group_sums` runs the stack and returns the per-element
    readout sums S_g ``[B, 8]`` as a (re, im) pair, on one of two routes
    (``compute_dtype``): float32, or bfloat16 (the TPU kernel's
    ``dtype_name='bfloat16'``: bf16 operands and activations, f32 sums,
    bias and activation in f32, a bf16 residual, f32 readout). On a CUDA
    tensor it launches the kernel (``csrc/gcnn_forward.cu``; that file's
    header note gives the design and the bound) or raises; on a CPU tensor
    it runs :func:`gcnn_group_sums_reference`, the plain PyTorch version
    with the same contract and rounding points. Nothing falls back silently;
  * :func:`pack_group_weights` (float32: TF32 hi/lo parts from
    ``kernels/tf32.py`` in m16n8k8 fragment order) and
    :func:`pack_group_weights_bf16` (bf16 in m16n8k16 fragment order) give
    the kernel's own weight layouts, built once per parameter state and
    cached beside ``GCNNWeights`` (:func:`packed_weights`);
  * :class:`FusedLogPsi` is the counterpart of ``make_fused_log_psi``:
    the character phase, the logmeanexp over G and the spin-flip pairing
    run outside the kernel, and the expanded weights are reused until the
    parameters change.

Scope: evaluation only (the sampler's proposals and refresh, the local
energy batch). The gradient and the SR Jacobian differentiate the plain
model (``models/gcnn.py``). The kernel takes equal channel widths, float32
or bfloat16, the bare GCNN (optionally spin-flip projected) and a block's
activations within Hopper's shared memory (``builder.gcnn_kernel_eligible``).
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qmcnn_tpu_torch.kernels.nvcc import CSRC, MAX_SMEM_BYTES, build_library
from qmcnn_tpu_torch.kernels.tf32 import tf32_split
from qmcnn_tpu_torch.models.cnn import compute_dtype_of, skip_scale, true_f32
from qmcnn_tpu_torch.models.gcnn import (_group_kernel, _lift_kernel,
                                         c4v_tables, conv_expanded,
                                         effective_kernel)
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C

SOURCE = CSRC / "gcnn_forward.cu"
G = 8
#: threads per block are capped by the kernel's __launch_bounds__
MAX_THREADS = 384
#: a warp task of the tensor-core layers: at most ROW_TILES 16-row tiles x
#: COL_TILES 8-column tiles (kRowTiles, kColTiles in the .cu source)
ROW_TILES = 2
COL_TILES = 4
#: rows (configurations x sites) one block takes at most
MAX_ROWS = 256
_ACTIVATION_CODES = {"lncosh": 0, "selu": 1}
#: the routes (the launch's dtype code)
_DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_LIB: Dict[str, ctypes.CDLL] = {}


def build():
    """Compile the kernel library if needed: (library path, compiler log)."""
    return build_library(SOURCE)


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("gcnn")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gcnn_forward_launch.argtypes = [vp] * 9 + [ci] * 13 + [vp]
        lib.gcnn_forward_launch.restype = ci
        _LIB["gcnn"] = lib
    return lib


class GCNNWeights(NamedTuple):
    """G-expanded, tap-major dense kernels (the ``_im`` fields are None for
    real parameters):
      lift [k*k, 1, W]; layers [L-1, k*k, W, W]; biases [L, W] (G-tiled)."""

    lift_re: torch.Tensor
    lift_im: Optional[torch.Tensor]
    w_re: torch.Tensor
    w_im: Optional[torch.Tensor]
    b_re: torch.Tensor
    b_im: Optional[torch.Tensor]


def expand_gcnn_params(params, kernel_size: int, complex_params: bool,
                       prefix: str = "params/") -> GCNNWeights:
    """Flat GCNN params under ``prefix`` -> :class:`GCNNWeights`.
    ``kernel_size`` is the model's effective kernel. Raises for parameters
    the bare GCNN does not have (priors, wrappers other than the spin-flip
    projection)."""
    k = kernel_size
    _, _, elem_idx, tap_perm, _, _ = c4v_tables(k)
    names = ["kernel_re", "bias_re"] + (["kernel_im", "bias_im"]
                                        if complex_params else [])
    n_layers = 0
    while f"{prefix}GroupConv_{n_layers}/kernel_re" in params:
        n_layers += 1
    if not n_layers or len(params) != n_layers * len(names):
        raise ValueError("the fused GCNN forward takes the bare GCNN "
                         f"({prefix}GroupConv_i/{{{','.join(names)}}} only); "
                         f"got keys {sorted(params)[:4]}...")

    def leaf(i, name):
        return params[f"{prefix}GroupConv_{i}/{name}"].detach().to(
            torch.float32)

    def expand(i, name):
        w = leaf(i, name)
        big = (_lift_kernel(w, tap_perm, k) if i == 0
               else _group_kernel(w, elem_idx, tap_perm, k))
        return big.reshape(k * k, big.shape[-2], big.shape[-1])

    def stack(name):
        layers = [expand(i, name) for i in range(1, n_layers)]
        if layers:
            return torch.stack(layers)
        width = G * leaf(0, name).shape[-1]
        return leaf(0, name).new_zeros((0, k * k, width, width))

    lift_re = expand(0, "kernel_re")
    w_re = stack("kernel_re")
    b_re = torch.stack([leaf(i, "bias_re").repeat(G) for i in range(n_layers)])
    if not complex_params:
        return GCNNWeights(lift_re, None, w_re, None, b_re, None)
    return GCNNWeights(
        lift_re, expand(0, "kernel_im"), w_re, stack("kernel_im"), b_re,
        torch.stack([leaf(i, "bias_im").repeat(G) for i in range(n_layers)]))


def _check_shapes(x, weights: GCNNWeights, lattice_shape, channels,
                  kernel_size, activation, compute_dtype):
    if len(lattice_shape) != 2:
        raise ValueError(f"the fused GCNN forward needs a 2D lattice, got "
                         f"{tuple(lattice_shape)}")
    if len(set(channels)) != 1:
        raise ValueError("the fused GCNN forward needs equal channel widths, "
                         f"got {tuple(channels)}")
    if activation not in _ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    hw = int(np.prod(lattice_shape))
    if x.dim() != 2 or x.shape[1] != hw or x.dtype != torch.float32:
        raise ValueError(f"x must be [B, {hw}] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    kk, width, n_layers = kernel_size ** 2, G * channels[0], len(channels)
    want = {"lift_re": (kk, 1, width), "w_re": (n_layers - 1, kk, width, width),
            "b_re": (n_layers, width)}
    want.update({"lift_im": want["lift_re"], "w_im": want["w_re"],
                 "b_im": want["b_re"]})
    complex_params = weights.lift_im is not None
    for name, shape in want.items():
        w = getattr(weights, name)
        if name.endswith("_im") and not complex_params:
            if w is not None:
                raise ValueError(f"{name} given for real parameters")
            continue
        if w is None or tuple(w.shape) != shape or w.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{None if w is None else tuple(w.shape)}")
    return complex_params


def gcnn_group_sums_reference(x: torch.Tensor, weights: GCNNWeights, *,
                              lattice_shape: Sequence[int],
                              channels: Sequence[int], kernel_size: int,
                              activation: str = "lncosh",
                              residual: bool = False,
                              compute_dtype: str = "float32") -> C:
    """Plain PyTorch version of the kernel, same contract: the expanded
    stack as circular ``F.conv2d`` layers in true float32, the complex ones
    in the kernel's direct 4-product form (the model, ``GroupConv``, uses
    3-product Karatsuba: a second plain implementation with other rounding).

    ``compute_dtype='bfloat16'`` rounds where the TPU kernel rounds
    (``gcnn_pallas.py`` at ``dtype_name='bfloat16'``): the weights once to
    bf16 (the f32 biases are not rounded), every product of bf16 values
    exact and summed in f32, bias and activation in f32 with one rounding
    of the result to bf16, the residual skip as a bf16 add and a bf16
    multiply by bf16(1/sqrt 2), and the readout sums in f32. Its tensors
    stay float32 holding bf16 values, so the sums run in true f32.
    Returns S_g [B, 8] (re, im)."""
    complex_params = _check_shapes(x, weights, lattice_shape, channels,
                                   kernel_size, activation, compute_dtype)
    k, width, n_layers = kernel_size, G * channels[0], len(channels)
    act = cplx.ACTIVATIONS[activation][0 if complex_params else 1]
    dtype = compute_dtype_of(compute_dtype)
    scale = skip_scale(dtype)
    batch = x.shape[0]

    def rnd(t):  # round to the compute dtype, keep f32 storage
        if dtype == torch.float32:
            return t
        if isinstance(t, C):
            return C(rnd(t.re), rnd(t.im))
        return t.to(dtype).to(torch.float32)

    def flax(w, cin):  # tap-major [k*k, Cin, W] -> [k, k, Cin, W]
        return rnd(w.reshape(k, k, cin, width))

    with true_f32():
        z = x.reshape(batch, 1, *lattice_shape)
        lr = flax(weights.lift_re, 1)
        if complex_params:
            li = flax(weights.lift_im, 1)
            z = C(conv_expanded(z, lr), conv_expanded(z, li))
        else:
            z = conv_expanded(z, lr)
        for i in range(n_layers):
            z_in = z
            if i > 0:
                wr = flax(weights.w_re[i - 1], width)
                if complex_params:
                    wi = flax(weights.w_im[i - 1], width)
                    z = C(conv_expanded(z.re, wr) - conv_expanded(z.im, wi),
                          conv_expanded(z.re, wi) + conv_expanded(z.im, wr))
                else:
                    z = conv_expanded(z, wr)
            br = weights.b_re[i].reshape(-1, 1, 1)
            if complex_params:
                z = act(C(z.re + br, z.im + weights.b_im[i].reshape(-1, 1, 1)))
            else:
                z = act(z + br)
            z = rnd(z)
            if residual and 0 < i < n_layers - 1:
                z = rnd(rnd(z + z_in) * scale)
    z = cplx.as_c(z)
    c = channels[-1]
    return C(z.re.reshape(batch, G, c, -1).sum((2, 3)),
             z.im.reshape(batch, G, c, -1).sum((2, 3)))


def pack_group_weights(w: torch.Tensor) -> torch.Tensor:
    """Tap-major group-layer weights [L-1, k*k, W, W] (in, out) -> the
    kernel's fragment layout [L-1, k*k, W/8, W/8, 8, 4, 4]: per layer, tap,
    k step (8 input channels), column tile (8 output channels) and lane
    (g, t) = (lane // 4, lane % 4) of an m16n8k8 B fragment, the words
    (hi b0, hi b1, lo b0, lo b1) with b0 = w[8 ks + 2 t, 8 nt + g] and
    b1 = w[8 ks + 2 t + 1, 8 nt + g]. (The fragment's k = t and t + 4 are
    taken as channels 2 t and 2 t + 1, so that the kernel loads a lane's
    two activations of a row as one 8-byte word.)"""
    n, kk, width, _ = w.shape
    t = w.reshape(n, kk, width // 8, 4, 2, width // 8, 8)
    hi, lo = tf32_split(t.permute(0, 1, 2, 5, 6, 3, 4))
    return torch.cat([hi, lo], dim=-1).contiguous()


def k_padded(width: int) -> int:
    """The bf16 route's GEMM depth per tap: W rounded up to the m16n8k16
    step (the padded input channels have zero weights and zero
    activations)."""
    return -(-width // 16) * 16


def pack_group_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """Tap-major group-layer weights [L-1, k*k, W, W] (in, out) -> the bf16
    route's fragment layout [L-1, k*k, Kp/16, W/8, 8, 4, 4] of bf16 (Kp =
    :func:`k_padded`, the input channels past W zero): per layer, tap, k
    step (16 input channels), column tile (8 output channels) and lane
    (g, t) = (lane // 4, lane % 4) of an m16n8k16 B fragment, the four
    values w[16 ks + 4 t + j, 8 nt + g], j = 0..3, each rounded to nearest
    even. (The fragment's k = 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 are taken
    as channels 4 t .. 4 t + 3, so that the kernel loads a lane's four
    activations of a row as one 8-byte word.)"""
    n, kk, width, _ = w.shape
    kp = k_padded(width)
    t = F.pad(w, (0, 0, 0, kp - width))
    t = t.reshape(n, kk, kp // 16, 4, 4, width // 8, 8)
    return t.permute(0, 1, 2, 5, 6, 3, 4).to(torch.bfloat16).contiguous()


class PackedWeights(NamedTuple):
    """The kernel's own copy of the group-layer weights
    (:func:`pack_group_weights` or :func:`pack_group_weights_bf16` of
    ``w_re`` and ``w_im``; ``frag_im`` is None for real parameters)."""

    frag_re: torch.Tensor
    frag_im: Optional[torch.Tensor]


_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_SLOTS = 4


def packed_weights(weights: GCNNWeights,
                   compute_dtype: str = "float32") -> PackedWeights:
    """The route's packing of ``weights`` (:func:`pack_group_weights` or
    :func:`pack_group_weights_bf16`), reused while its tensors are the same
    and unchanged (their version counters), so it runs once per parameter
    update. Keeps the last few weight sets; holding the source tensors keeps
    their ids from being reused."""
    pack = {"float32": pack_group_weights,
            "bfloat16": pack_group_weights_bf16}[compute_dtype]
    src = (weights.w_re, weights.w_im)
    stamp = (compute_dtype,) + tuple((id(w), w._version) for w in src
                                     if w is not None)
    hit = _PACKED.get(stamp)
    if hit is not None:
        _PACKED.move_to_end(stamp)
        return hit[1]
    packed = PackedWeights(*(None if w is None else pack(w) for w in src))
    _PACKED[stamp] = (src, packed)
    while len(_PACKED) > _PACKED_SLOTS:
        _PACKED.popitem(last=False)
    return packed


def smem_bytes(hw: int, width: int, kk: int, complex_params: bool,
               n_cfg: int = 1, compute_dtype: str = "float32") -> int:
    """Shared memory of a block of ``n_cfg`` configurations; mirrors
    ``smem_layout`` in the .cu source, which checks that the two agree at
    every launch: two activation buffers of n_cfg * hw rows per part (a row
    of float32 padded to ``width + 4`` words; of bf16, to
    ``k_padded(width) + 8`` values), the spins, and a [kk, rows] table of
    source rows."""
    parts = 2 if complex_params else 1
    rows = n_cfg * hw
    tail = 4 * ((rows + 3) // 4 * 4 + kk * rows)
    if compute_dtype == "bfloat16":
        return 2 * 2 * parts * rows * (k_padded(width) + 8) + tail
    return 4 * 2 * parts * rows * (width + 4) + tail


def configs_per_block(hw: int, width: int, kk: int, complex_params: bool,
                      compute_dtype: str = "float32") -> int:
    """Configurations per block: as many as shared memory takes, up to
    MAX_ROWS rows (at least 1; the wrapper raises if 1 does not fit)."""
    n = max(1, MAX_ROWS // hw)
    while n > 1 and smem_bytes(hw, width, kk, complex_params, n,
                               compute_dtype) > MAX_SMEM_BYTES:
        n -= 1
    return n


def launch_threads(hw: int, width: int, n_cfg: int) -> int:
    """Threads per block: one warp per task of the tensor-core layers
    (ceil(row tiles / ROW_TILES) row groups x ceil(column tiles /
    COL_TILES)), at most MAX_THREADS (the tasks then loop)."""
    row_tiles = (n_cfg * hw + 15) // 16
    tasks = (-(-row_tiles // ROW_TILES)) * (-(-(width // 8) // COL_TILES))
    return min(MAX_THREADS, 32 * tasks)


def gcnn_group_sums(x: torch.Tensor, weights: GCNNWeights, *,
                    lattice_shape: Sequence[int], channels: Sequence[int],
                    kernel_size: int, activation: str = "lncosh",
                    residual: bool = False,
                    compute_dtype: str = "float32") -> C:
    """Per-group-element readout sums S_g [B, 8] (re, im) of the GCNN stack
    on x [B, H*W] on the ``compute_dtype`` route (see the module
    docstring). Counts its launches per route: ``gcnn_group_sums.launches``
    (float32) and ``gcnn_group_sums.launches_bf16``."""
    if x.device.type == "cpu":
        return gcnn_group_sums_reference(
            x, weights, lattice_shape=lattice_shape, channels=channels,
            kernel_size=kernel_size, activation=activation, residual=residual,
            compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gcnn_group_sums runs on cuda or cpu tensors, got "
                         f"{x.device}")
    lattice_shape = tuple(int(v) for v in lattice_shape)
    complex_params = _check_shapes(x, weights, lattice_shape, channels,
                                   kernel_size, activation, compute_dtype)
    dev = x.device
    x = x.contiguous()
    ws = GCNNWeights(*(None if w is None else w.contiguous()
                       for w in weights))
    for w in ws:
        if w is not None and w.device != dev:
            raise ValueError(f"weights on {w.device}, x on {dev}")
    hw = int(np.prod(lattice_shape))
    width, kk = G * channels[0], kernel_size ** 2
    one = smem_bytes(hw, width, kk, complex_params, 1, compute_dtype)
    if one > MAX_SMEM_BYTES:
        raise ValueError(f"the fused GCNN forward ({compute_dtype}) needs "
                         f"{one} bytes of shared memory per block at {hw} "
                         f"sites x width {width}, above Hopper's "
                         f"{MAX_SMEM_BYTES}")
    n_cfg = configs_per_block(hw, width, kk, complex_params, compute_dtype)
    packed = packed_weights(weights, compute_dtype)
    batch = x.shape[0]
    out_re = torch.empty((batch, G), dtype=torch.float32, device=dev)
    out_im = torch.empty((batch, G), dtype=torch.float32, device=dev)

    def ptr(t):  # the _im pointers are NULL for real parameters
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().gcnn_forward_launch(
            x.data_ptr(), ptr(ws.lift_re), ptr(ws.lift_im),
            ptr(packed.frag_re), ptr(packed.frag_im), ptr(ws.b_re),
            ptr(ws.b_im), out_re.data_ptr(), out_im.data_ptr(), batch, n_cfg,
            lattice_shape[0], lattice_shape[1], kernel_size, channels[0],
            len(channels), int(complex_params),
            _ACTIVATION_CODES[activation], int(residual),
            _DTYPE_CODES[compute_dtype], launch_threads(hw, width, n_cfg),
            smem_bytes(hw, width, kk, complex_params, n_cfg, compute_dtype),
            stream)
    if compute_dtype == "bfloat16":
        gcnn_group_sums.launches_bf16 += 1
    else:
        gcnn_group_sums.launches += 1
    if err != 0:
        raise RuntimeError(f"gcnn_group_sums launch failed: CUDA error {err}")
    return C(out_re, out_im)


#: launches of the CUDA kernel since the last reset, per route (CPU calls,
#: which run the plain version, do not count)
gcnn_group_sums.launches = 0
gcnn_group_sums.launches_bf16 = 0


class FusedLogPsi:
    """``(params, s) -> log psi(s)`` [B] of ``LogPsiGCNN`` (wrapped in
    ``SpinFlipSymmetrized`` when ``spin_flip_sector`` is +-1) through
    :func:`gcnn_group_sums` on the model's ``compute_dtype`` route.
    Evaluation only: no autograd through the kernel. Which configs may take it is decided once, by
    ``builder.gcnn_kernel_eligible``; the wrapper checks shapes and device.

    The G-expanded weights and the character phases are kept between calls:
    the weights are gathered again only when ``params`` is another dict or
    one of its tensors was changed in place (its version counter moved), so
    the sampler's many calls between two parameter updates reuse them."""

    def __init__(self, *, lattice_shape: Tuple[int, int],
                 channels: Sequence[int], kernel_size: int,
                 complex_params: bool, character: str = "A1",
                 activation: str = "lncosh", residual: bool = False,
                 spin_flip_sector: int = 0, compute_dtype: str = "float32"):
        if spin_flip_sector not in (0, 1, -1):
            raise ValueError("spin-flip sector must be 0, +1 or -1")
        if compute_dtype not in _DTYPE_CODES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.lattice_shape = tuple(int(v) for v in lattice_shape)
        self.channels = tuple(channels)
        self.k = effective_kernel(kernel_size, self.lattice_shape)
        self.complex_params = complex_params
        self.activation = activation
        self.residual = residual
        self.sector = spin_flip_sector
        self.prefix = "params/inner/" if spin_flip_sector else "params/"
        chi = c4v_tables(self.k)[4][character]
        #: +i pi on S_g where chi(g) = -1; +i pi on the flipped half, sector -1
        self._phase = torch.as_tensor(np.where(chi < 0, np.pi, 0.0),
                                      dtype=torch.float32)
        self._shift = torch.tensor([[0.0], [np.pi]], dtype=torch.float32)
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._stamp = None
        self._leaves: tuple = ()
        self._weights: Optional[GCNNWeights] = None

    def weights(self, params) -> GCNNWeights:
        """``expand_gcnn_params`` of ``params``, reused while neither the
        dict nor a tensor in it changed. The cached tensors are held, so
        their ids cannot be reused by new tensors."""
        stamp = tuple((k, id(v), v._version) for k, v in params.items())
        if stamp != self._stamp:
            self._weights = expand_gcnn_params(params, self.k,
                                               self.complex_params,
                                               self.prefix)
            self._stamp, self._leaves = stamp, tuple(params.values())
        return self._weights

    def _device_consts(self, device) -> Tuple[torch.Tensor, ...]:
        consts = self._consts.get(device)
        if consts is None:
            consts = (self._phase.to(device), self._shift.to(device))
            self._consts[device] = consts
        return consts

    def __call__(self, params, s: torch.Tensor) -> C:
        weights = self.weights(params)
        phase, shift = self._device_consts(s.device)
        s_eval = torch.cat([s, -s], dim=0) if self.sector else s
        with torch.no_grad():
            s_g = gcnn_group_sums(
                s_eval.to(torch.float32), weights,
                lattice_shape=self.lattice_shape, channels=self.channels,
                kernel_size=self.k, activation=self.activation,
                residual=self.residual, compute_dtype=self.compute_dtype)
            lp = cplx.logmeanexp(C(s_g.re, s_g.im + phase[None, :]), dim=1)
            if self.sector:
                pair = lp.reshape(2, s.shape[0])
                if self.sector == -1:
                    pair = C(pair.re, pair.im + shift)
                lp = cplx.logmeanexp(pair, dim=0)
        return lp

