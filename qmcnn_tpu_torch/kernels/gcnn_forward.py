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
    :func:`pack_group_weights_bf16` (bf16: each complex layer as one real
    GEMM matrix, cut into the ring stages the bf16 route's wgmma reads from
    shared memory) give the kernel's own weight layouts, built once per
    parameter state and cached beside ``GCNNWeights``
    (:func:`packed_weights`); :func:`bf16_plan` mirrors the bf16 route's
    tiling and shared memory;
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
#: the float32 route's threads per block are capped by its kernel's
#: __launch_bounds__ (kMaxThreads in the .cu source)
MAX_THREADS = 384
#: a warp task of the float32 route's tensor-core layers: at most ROW_TILES
#: 16-row tiles x COL_TILES 8-column tiles (kRowTiles, kColTiles)
ROW_TILES = 2
COL_TILES = 4
#: rows (configurations x sites) one block takes at most
MAX_ROWS = 256
#: the bf16 route's mirrors of the .cu source: the column-block widths in
#: 8-column tiles of one wgmma (`plan_bf16`), k16 steps per ring stage
#: (kStageSteps), the ring's stage counts (kMinStages, kMaxStages) and the
#: consumer warpgroups of a block (kMaxConsumerGroups)
BF16_TILE_COLS = (8, 16, 20, 32)
BF16_STAGE_STEPS = 2
BF16_MIN_STAGES = 2
BF16_MAX_STAGES = 16
BF16_MAX_GROUPS = 2
#: the bf16 route's k order within a k16 step: GEMM row k reads input
#: channel K_PERM[k] (the A fragment's k = 2t, 2t+1, 2t+8, 2t+9 are a lane's
#: channels 4t .. 4t+3, one 8-byte load per row)
K_PERM = tuple(4 * ((k % 8) // 2) + 2 * (k // 8) + k % 2 for k in range(16))
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
    """The bf16 route's GEMM depth per tap and part: W rounded up to the k
    step (the padded input channels have zero weights and zero
    activations)."""
    return -(-width // 16) * 16


def gemm_weights_bf16(w_re: torch.Tensor,
                      w_im: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tap-major group-layer weights [L-1, k*k, W, W] (in, out) -> each
    layer as one real GEMM matrix per tap, [L-1, k*k, K, N]: real
    parameters K = Kp (:func:`k_padded`), N = W; complex parameters
    ``[yr | yi] = [xr | xi] . [[wr, wi], [-wi, wr]]`` with K = 2 Kp (the re
    input channels, then the im ones) and N = 2W, the columns interleaved
    in 8s (column group 2j: the re parts of output channels 8j .. 8j+7;
    2j + 1: their im parts), so that a thread's accumulators hold both parts
    of a channel. Input channels past W are zero."""
    n, kk, width, _ = w_re.shape
    kp = k_padded(width)

    def pad(w):
        return F.pad(w, (0, 0, 0, kp - width))

    if w_im is None:
        return pad(w_re)
    wr, wi = pad(w_re), pad(w_im)

    def interleave(a, b):  # [.., Kp, W] x 2 -> [.., Kp, 2W], groups of 8
        return torch.stack([a.reshape(n, kk, kp, width // 8, 8),
                            b.reshape(n, kk, kp, width // 8, 8)],
                           dim=-2).reshape(n, kk, kp, 2 * width)

    return torch.cat([interleave(wr, wi), interleave(-wi, wr)], dim=2)


def tile_cols(n_tiles: int) -> int:
    """8-column tiles of one wgmma (a column block) for a GEMM of
    ``n_tiles`` 8-column tiles: the first of BF16_TILE_COLS that holds them
    all, else the largest (several column blocks)."""
    return next((b for b in BF16_TILE_COLS if n_tiles <= b),
                BF16_TILE_COLS[-1])


def pack_group_weights_bf16(w_re: torch.Tensor,
                            w_im: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The bf16 route's ring stages: :func:`gemm_weights_bf16` rounded to
    bf16 (to nearest even) as [L-1, col_blocks, steps_pad, NTB, 2, 8, 8]:
    per layer and column block of NTB 8-column tiles (:func:`tile_cols`,
    columns past N zero), the k16 steps (tap-major, then the K rows in 16s;
    padded with zero steps to whole stages of BF16_STAGE_STEPS), and per
    step the wgmma's K-major shared-memory layout without swizzle: core
    matrices [column group, k half] of 8 columns x 8 k, a column's 8 k
    values contiguous, with k -> input channel 16 ks + K_PERM[k]. A stage
    is BF16_STAGE_STEPS consecutive steps, one bulk copy."""
    b = gemm_weights_bf16(w_re, w_im)
    n, kk, kdim, ncols = b.shape
    ntb = tile_cols(ncols // 8)
    n_cb = -(-ncols // (8 * ntb))
    steps = kk * kdim // 16
    steps_pad = -(-steps // BF16_STAGE_STEPS) * BF16_STAGE_STEPS
    b = F.pad(b, (0, n_cb * ntb * 8 - ncols))
    b = b.reshape(n, steps, 16, n_cb * ntb * 8)[:, :, list(K_PERM)]
    b = F.pad(b, (0, 0, 0, 0, 0, steps_pad - steps))
    b = b.reshape(n, steps_pad, 2, 8, n_cb, ntb, 8)
    return b.permute(0, 4, 1, 5, 2, 6, 3).to(torch.bfloat16).contiguous()


class PackedWeights(NamedTuple):
    """The kernel's own copy of the weights: float32,
    :func:`pack_group_weights` of ``w_re`` and ``w_im`` (``frag_im`` None
    for real parameters); bfloat16, :func:`pack_group_weights_bf16` of both
    in ``frag_re`` (``frag_im`` None) and the lift's weights rounded to bf16
    (kept in float32; ``lift_im`` None for real parameters)."""

    frag_re: torch.Tensor
    frag_im: Optional[torch.Tensor]
    lift_re: Optional[torch.Tensor] = None
    lift_im: Optional[torch.Tensor] = None


_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_SLOTS = 4


def packed_weights(weights: GCNNWeights,
                   compute_dtype: str = "float32") -> PackedWeights:
    """The route's packing of ``weights`` (:func:`pack_group_weights` or
    :func:`pack_group_weights_bf16`), reused while its tensors are the same
    and unchanged (their version counters), so it runs once per parameter
    update. Keeps the last few weight sets; holding the source tensors keeps
    their ids from being reused."""
    src = (weights.w_re, weights.w_im)
    if compute_dtype == "bfloat16":
        src += (weights.lift_re, weights.lift_im)
    stamp = (compute_dtype,) + tuple((id(w), w._version) for w in src
                                     if w is not None)
    hit = _PACKED.get(stamp)
    if hit is not None:
        _PACKED.move_to_end(stamp)
        return hit[1]
    if compute_dtype == "bfloat16":
        packed = PackedWeights(
            pack_group_weights_bf16(*src[:2]), None,
            *(None if w is None
              else w.to(torch.bfloat16).to(torch.float32).contiguous()
              for w in src[2:]))
    else:
        packed = PackedWeights(*(None if w is None else pack_group_weights(w)
                                 for w in src))
    _PACKED[stamp] = (src, packed)
    while len(_PACKED) > _PACKED_SLOTS:
        _PACKED.popitem(last=False)
    return packed


class Bf16Plan(NamedTuple):
    """The bf16 route's tiling of one launch (``plan_bf16`` in the .cu
    source): column blocks of ``ntb`` 8-column tiles, ``c_wg``
    configurations (``rows_wg`` rows) per consumer warpgroup in
    ``row_passes`` 64-row M tiles x ``col_blocks`` passes per layer
    (``n_buf`` activation buffers: 1, in place, for one pass), ``n_wg``
    consumer warpgroups, a ring of ``stages`` stages of ``stage_bytes``,
    ``threads`` per block and ``smem_bytes`` in all."""

    ntb: int
    col_blocks: int
    c_wg: int
    rows_wg: int
    row_passes: int
    n_buf: int
    n_wg: int
    stage_bytes: int
    stages: int
    threads: int
    smem_bytes: int


def bf16_group_configs(hw: int) -> int:
    """Configurations one consumer warpgroup of the bf16 route owns: as
    many whole ones as a 64-row M tile holds (at least 1)."""
    return max(1, 64 // hw)


def bf16_plan(hw: int, width: int, kk: int, complex_params: bool,
              n_wg: int, stages: Optional[int] = None) -> Bf16Plan:
    """The bf16 route's tiling for ``n_wg`` consumer warpgroups, with as
    many ring stages as shared memory holds (at most BF16_MAX_STAGES) unless
    ``stages`` is given; mirrors ``plan_bf16`` in the .cu source, which
    checks ``smem_bytes`` and ``threads`` at every launch."""
    parts = 2 if complex_params else 1
    kp = k_padded(width)
    n_tiles = parts * width // 8
    ntb = tile_cols(n_tiles)
    col_blocks = -(-n_tiles // ntb)
    c_wg = bf16_group_configs(hw)
    rows = c_wg * hw
    row_passes = -(-rows // 64)
    n_buf = 1 if row_passes * col_blocks == 1 else 2
    stage_bytes = BF16_STAGE_STEPS * ntb * 256
    # activations, spins and the source-row table (8-aligned); 16 bytes of
    # mbarriers per stage
    fixed = -(-(n_wg * (2 * n_buf * parts * rows * (kp + 8)
                        + 4 * ((rows + 3) // 4 * 4)) + 4 * kk * rows)
              // 8) * 8
    if stages is None:
        stages = min(BF16_MAX_STAGES,
                     (MAX_SMEM_BYTES - fixed) // (stage_bytes + 16))
    return Bf16Plan(ntb, col_blocks, c_wg, rows, row_passes, n_buf, n_wg,
                    stage_bytes, stages, 128 * (n_wg + 1),
                    fixed + stages * (stage_bytes + 16))


def smem_bytes(hw: int, width: int, kk: int, complex_params: bool,
               n_cfg: int = 1, compute_dtype: str = "float32") -> int:
    """Shared memory a block of ``n_cfg`` configurations needs at least.
    float32 (mirrors ``smem_layout`` in the .cu source): two activation
    buffers of n_cfg * hw rows per part (a row of float32 padded to
    ``width + 4`` words), the spins, and a [kk, rows] table of source rows.
    bfloat16: :func:`bf16_plan` with the warpgroups those configurations
    take and a ring of BF16_MIN_STAGES stages."""
    if compute_dtype == "bfloat16":
        c_wg = bf16_group_configs(hw)
        return bf16_plan(hw, width, kk, complex_params, -(-n_cfg // c_wg),
                         BF16_MIN_STAGES).smem_bytes
    parts = 2 if complex_params else 1
    rows = n_cfg * hw
    tail = 4 * ((rows + 3) // 4 * 4 + kk * rows)
    return 4 * 2 * parts * rows * (width + 4) + tail


def configs_per_block(hw: int, width: int, kk: int, complex_params: bool,
                      compute_dtype: str = "float32") -> int:
    """Configurations per block: float32, as many as shared memory takes,
    up to MAX_ROWS rows (at least 1; the wrapper raises if 1 does not fit);
    bfloat16, a warpgroup's configurations times the warpgroups (at most
    BF16_MAX_GROUPS) whose buffers and a minimal ring fit."""
    if compute_dtype == "bfloat16":
        c_wg = bf16_group_configs(hw)
        n_wg = BF16_MAX_GROUPS
        while n_wg > 1 and smem_bytes(hw, width, kk, complex_params,
                                      n_wg * c_wg, compute_dtype) > \
                MAX_SMEM_BYTES:
            n_wg -= 1
        return n_wg * c_wg
    n = max(1, MAX_ROWS // hw)
    while n > 1 and smem_bytes(hw, width, kk, complex_params, n,
                               compute_dtype) > MAX_SMEM_BYTES:
        n -= 1
    return n


def launch_threads(hw: int, width: int, n_cfg: int) -> int:
    """Threads per block of the float32 route (the bf16 route's are
    :func:`bf16_plan`'s): one warp per task of the tensor-core layers
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
    if compute_dtype == "bfloat16":
        plan = bf16_plan(hw, width, kk, complex_params,
                         n_cfg // bf16_group_configs(hw))
        threads, smem = plan.threads, plan.smem_bytes
    else:
        threads = launch_threads(hw, width, n_cfg)
        smem = smem_bytes(hw, width, kk, complex_params, n_cfg)
    packed = packed_weights(weights, compute_dtype)
    batch = x.shape[0]
    out_re = torch.empty((batch, G), dtype=torch.float32, device=dev)
    out_im = torch.empty((batch, G), dtype=torch.float32, device=dev)

    def ptr(t):  # the _im pointers are NULL for real parameters
        return None if t is None else t.data_ptr()

    lift = ws if packed.lift_re is None else packed
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().gcnn_forward_launch(
            x.data_ptr(), ptr(lift.lift_re), ptr(lift.lift_im),
            ptr(packed.frag_re), ptr(packed.frag_im), ptr(ws.b_re),
            ptr(ws.b_im), out_re.data_ptr(), out_im.data_ptr(), batch, n_cfg,
            lattice_shape[0], lattice_shape[1], kernel_size, channels[0],
            len(channels), int(complex_params),
            _ACTIVATION_CODES[activation], int(residual),
            _DTYPE_CODES[compute_dtype], threads, smem, stream)
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

