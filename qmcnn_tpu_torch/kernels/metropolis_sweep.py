"""Fused Metropolis sweep: the CUDA kernel's wrapper and its plain version
(port of ``qmcnn_tpu/kernels/metropolis_pallas.py``).

``metropolis_sweep`` runs ``n_props`` sequential Metropolis proposals for
every walker of the real, lncosh, skip-free, periodic ``LogPsiCNN`` in one
kernel launch (``csrc/metropolis_sweep.cu``; that file's header note gives
the design and the bound). On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs ``sweep_reference``, the plain PyTorch
version with the same contract. Nothing falls back silently.

The kernel takes its weights as one blob in its own layout
(:func:`pack_sweep_weights`: TF32 hi/lo parts in mma fragment order for
the tensor-core layers), built once per parameter state
(:func:`packed_weights`), and runs ``walkers_per_block`` walkers per block
(a mirror of the source's ``smem_layout``). Its recompute mode
(``n_props = 0``) is also the CNN's evaluation forward,
:class:`FusedCNNLogPsi`.

Noise comes in from outside, as in the TPU kernel: ``noise=(choices,
log_u)``, both ``[n_props, M]`` (flip: the site; exchange: the bond index).
Identical noise gives identical Metropolis decisions in the kernel, in
``sweep_reference``, in the port's torch sampler and in the JAX sampler,
up to forward-pass rounding at the acceptance threshold.

Build: the kernel is compiled at first use with ``nvcc`` for ``sm_90a``
into ``qmcnn_tpu_torch/_build/`` (git-ignored), from this repository's
sources only, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qmcnn_tpu_torch.kernels.nvcc import CSRC, MAX_SMEM_BYTES, build_library
from qmcnn_tpu_torch.kernels.tf32 import tf32_split
from qmcnn_tpu_torch.models.cnn import LogPsiCNN, _tap_offsets, log_psi_apply
from qmcnn_tpu_torch.ops.cplx import C

SOURCE = CSRC / "metropolis_sweep.cu"
MAX_LAYERS = 16

_LIB: Dict[str, ctypes.CDLL] = {}


def build():
    """Compile the kernel library if needed: (library path, compiler log)."""
    return build_library(SOURCE)


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("sweep")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.metropolis_sweep_launch.argtypes = [vp] * 10 + [ci] * 6 + [
            vp, ci, ci, ci, vp]
        lib.metropolis_sweep_launch.restype = ci
        _LIB["sweep"] = lib
    return lib


@functools.lru_cache(maxsize=None)
def source_sites(lattice_shape: Tuple[int, ...], kernel: Tuple[int, ...]
                 ) -> np.ndarray:
    """[taps, N] int32: output site p reads input site ``table[t, p]``
    through tap t under periodic wrap (the circular padding of
    ``models.cnn._circular_pad``)."""
    n = int(np.prod(lattice_shape))
    coords = np.stack(np.unravel_index(np.arange(n), lattice_shape), -1)
    offs = _tap_offsets(kernel)
    table = np.zeros((len(offs), n), np.int32)
    for t, off in enumerate(offs):
        src = (coords + np.asarray(off)) % np.asarray(lattice_shape)
        table[t] = np.ravel_multi_index(src.T, lattice_shape)
    return table


def conv_layers(params, lattice_shape: Sequence[int]):
    """[(kernel [*k, Cin, Cout], bias [Cout])] of a plain real LogPsiCNN;
    raises for anything else (complex or wrapped models)."""
    layers = []
    while f"params/RealConv_{len(layers)}/kernel" in params:
        i = len(layers)
        layers.append((params[f"params/RealConv_{i}/kernel"],
                       params[f"params/RealConv_{i}/bias"]))
    if not layers or len(params) != 2 * len(layers):
        raise ValueError("the sweep kernel takes a plain real LogPsiCNN "
                         "(params/RealConv_i/{kernel,bias} only); got keys "
                         f"{sorted(params)[:4]}...")
    nd = len(lattice_shape)
    cin = 1
    for kern, bias in layers:
        k = tuple(kern.shape[:-2])
        if len(k) != nd or any(a > L for a, L in zip(k, lattice_shape)):
            raise ValueError(f"kernel shape {tuple(kern.shape)} does not fit "
                             f"lattice {tuple(lattice_shape)}")
        if kern.shape[-2] != cin or bias.shape != (kern.shape[-1],):
            raise ValueError("RealConv channel counts do not chain (the "
                             "sweep kernel needs basis 1)")
        cin = kern.shape[-1]
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {len(layers)}")
    return layers


def _site_noise(s, move, bonds, n_props, noise):
    """Validate the inputs; return (site_a, site_b, log_u), each
    [n_props, M] on the device of ``s`` (None when n_props == 0)."""
    if s.dim() != 2 or s.dtype != torch.float32:
        raise ValueError(f"s must be [M, N] float32, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if move not in ("flip", "exchange"):
        raise ValueError(f"the sweep supports flip/exchange, got {move!r}")
    if move == "exchange" and bonds is None:
        raise ValueError("exchange move requires bonds")
    if n_props < 0:
        raise ValueError(f"n_props must be >= 0, got {n_props}")
    if n_props == 0:
        return None, None, None
    if noise is None:
        raise ValueError("n_props > 0 needs noise=(choices, log_u)")
    m, n = s.shape
    choices, log_u = noise
    if tuple(choices.shape) != (n_props, m) or tuple(log_u.shape) != (
            n_props, m):
        raise ValueError(f"noise must be [n_props={n_props}, M={m}], got "
                         f"{tuple(choices.shape)} / {tuple(log_u.shape)}")
    if log_u.dtype != torch.float32:
        raise ValueError(f"log_u must be float32, got {log_u.dtype}")
    n_choices = n if move == "flip" else len(bonds)
    lo, hi = int(choices.min()), int(choices.max())
    if lo < 0 or hi >= n_choices:
        raise ValueError(f"choices must lie in [0, {n_choices}), got "
                         f"[{lo}, {hi}]")
    choices = choices.to(device=s.device, dtype=torch.long)
    log_u = log_u.to(s.device)
    if move == "exchange":
        b = torch.as_tensor(np.asarray(bonds, np.int64), device=s.device)
        return b[choices, 0], b[choices, 1], log_u
    return choices, choices, log_u


def _check_log_psi(s, log_psi_re):
    if log_psi_re.shape != (s.shape[0],) or log_psi_re.dtype != torch.float32:
        raise ValueError("log_psi_re must be [M] float32, got "
                         f"{tuple(log_psi_re.shape)} {log_psi_re.dtype}")


def sweep_reference(params, s: torch.Tensor, log_psi_re: torch.Tensor, *,
                    lattice_shape: Sequence[int], n_props: int,
                    move: str = "flip", bonds: Optional[np.ndarray] = None,
                    noise=None):
    """Plain PyTorch version of the kernel, same contract: a Python loop
    over proposals, each one batched over walkers through ``LogPsiCNN``.

    Returns (s_out [M, N] f32, log_psi_out [M] f32, n_accept [M] int32).
    """
    lattice_shape = tuple(lattice_shape)
    layers = conv_layers(params, lattice_shape)
    site_a, site_b, log_u = _site_noise(s, move, bonds, n_props, noise)
    _check_log_psi(s, log_psi_re)
    model = LogPsiCNN(lattice_shape,
                      channels=[int(k.shape[-1]) for k, _ in layers],
                      kernel_size=tuple(layers[0][0].shape[:-2]))
    m, n = s.shape
    n_acc = torch.zeros(m, dtype=torch.int32, device=s.device)
    if n_props == 0:
        return s.clone(), log_psi_apply(model, params, s).re, n_acc
    idx = torch.arange(n, device=s.device)[None, :]
    s_cur, lp = s.clone(), log_psi_re.clone()
    for t in range(n_props):
        a, b = site_a[t][:, None], site_b[t][:, None]
        if move == "flip":
            flip = idx == a
        else:
            anti = s_cur.gather(1, a) * s_cur.gather(1, b) < 0.0
            flip = ((idx == a) | (idx == b)) & anti
        s_prop = torch.where(flip, -s_cur, s_cur)
        lp_prop = log_psi_apply(model, params, s_prop).re
        accept = log_u[t] < 2.0 * (lp_prop - lp)
        s_cur = torch.where(accept[:, None], s_prop, s_cur)
        lp = torch.where(accept, lp_prop, lp)
        n_acc += accept.to(torch.int32)
    return s_cur, lp, n_acc


#: threads per block are capped by the kernel's __launch_bounds__
#: (kMaxThreads in the .cu source)
MAX_THREADS = 800
#: a warp task of the tensor-core layers: ROW_TILES 16-row tiles x at most
#: COL_TILES 8-column tiles (kRowTiles, kMaxColTiles)
ROW_TILES = 2
COL_TILES = 3
#: state words per walker slot (kSlotWords)
SLOT_WORDS = 7
#: walker slots per block at most: at M = 2048 walkers of 10x10 on 132
#: SMs, 8 per block run in two full waves of one block per SM (shared
#: memory would take 11; fewer per block, with two or three blocks per SM,
#: measured no faster)
MAX_WALKERS = 8


def _pad8(x: int) -> int:
    return (x + 7) // 8 * 8


def _r4(x: int) -> int:
    return (x + 3) // 4 * 4


def col_tiles(n_ct: int) -> int:
    """8-column tiles per warp task for a layer of ``n_ct`` column tiles
    (the source's ``col_tiles``): as few column groups as COL_TILES allows,
    spread evenly."""
    groups = -(-n_ct // COL_TILES)
    return -(-n_ct // groups)


def col_groups(c: int) -> int:
    """Column groups (warp tasks across the columns) of a tensor-core layer
    with ``c`` output channels."""
    n_ct = _pad8(c) // 8
    return -(-n_ct // col_tiles(n_ct))


def blob_words(taps: int, channels: Sequence[int]) -> int:
    """Words of :func:`pack_sweep_weights`' blob (``channels`` includes the
    input channel count first)."""
    cp = [_pad8(c) for c in channels]
    frag = sum(2 * taps * cp[i] * cp[i + 1] for i in range(1, len(cp) - 1))
    return _r4(taps * cp[1]) + _r4(sum(cp[1:])) + frag


def smem_bytes(n_sites: int, taps: int, channels: Sequence[int],
               walkers: int = 1) -> int:
    """Shared memory of a block of ``walkers`` slots; mirrors
    ``smem_layout`` in the .cu source, which checks that the two agree at
    every launch: the weight blob, two activation buffers of walkers x N
    rows (one for a 2-layer stack, none for one layer), a row padded to
    pad8(max hidden C) + 4 words, the spins, the last layer's per-row
    partial sums (one per column group), SLOT_WORDS words of state per slot
    and the [taps, N] table."""
    n_layers = len(channels) - 1
    rows = walkers * n_sites
    stride = max([8] + [_pad8(c) for c in channels[1:-1]]) + 4
    parts = 1 if n_layers == 1 else col_groups(channels[-1])
    words = (blob_words(taps, channels) + min(n_layers - 1, 2) * rows * stride
             + _r4(rows) + _r4(rows * parts) + SLOT_WORDS * _r4(walkers)
             + taps * n_sites)
    return 4 * words


def walkers_per_block(n_sites: int, taps: int,
                      channels: Sequence[int]) -> int:
    """Walker slots per block: as many as shared memory takes, up to
    MAX_WALKERS (at least 1; the wrapper raises if 1 does not fit)."""
    w = MAX_WALKERS
    while w > 1 and smem_bytes(n_sites, taps, channels, w) > MAX_SMEM_BYTES:
        w -= 1
    return w


def launch_threads(n_sites: int, channels: Sequence[int],
                   walkers: int) -> int:
    """Threads per block: one warp per task of the widest tensor-core layer
    (ceil(row tiles / ROW_TILES) row groups x its column groups), at most
    MAX_THREADS (the tasks then loop)."""
    row_tiles = -(-walkers * n_sites // 16)
    groups = max([1] + [col_groups(c) for c in channels[2:]])
    return min(MAX_THREADS, 32 * -(-row_tiles // ROW_TILES) * groups)


def pack_sweep_weights(layers, taps: int) -> torch.Tensor:
    """The kernel's weight blob (float32 words, on the layers' device):
      * the first layer's kernel [taps, pad8(C1)];
      * every layer's bias, each padded to a multiple of 8;
      * per later layer the B fragments of m16n8k8 TF32 mma,
        [taps, Cin/8, Cout/8, 8, 4, 4] with Cin and Cout padded to 8: per
        tap, k step (8 input channels), column tile (8 output channels) and
        lane (g, t) = (lane // 4, lane % 4) the words (hi b0, hi b1, lo b0,
        lo b1), b0 = w[8 ks + t, 8 nt + g] and b1 = w[8 ks + t + 4,
        8 nt + g], split by ``kernels/tf32.tf32_split``.
    The first two parts are each padded to a multiple of 4 words. Padding
    is zero."""
    f = torch.nn.functional
    kern0, _ = layers[0]
    c1 = int(kern0.shape[-1])
    w0 = f.pad(kern0.detach().to(torch.float32).reshape(taps, c1),
               (0, _pad8(c1) - c1)).reshape(-1)
    biases = torch.cat([f.pad(b.detach().to(torch.float32),
                              (0, _pad8(b.shape[0]) - b.shape[0]))
                        for _, b in layers])
    parts = [f.pad(w0, (0, _r4(w0.numel()) - w0.numel())),
             f.pad(biases, (0, _r4(biases.numel()) - biases.numel()))]
    for kern, _ in layers[1:]:
        cin, cout = int(kern.shape[-2]), int(kern.shape[-1])
        cinp, coutp = _pad8(cin), _pad8(cout)
        w = f.pad(kern.detach().to(torch.float32).reshape(taps, cin, cout),
                  (0, coutp - cout, 0, cinp - cin))
        t = w.reshape(taps, cinp // 8, 2, 4, coutp // 8, 8)
        hi, lo = tf32_split(t.permute(0, 1, 4, 5, 3, 2))
        parts.append(torch.cat([hi, lo], dim=-1).reshape(-1))
    return torch.cat(parts).contiguous()


_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_SLOTS = 4


def packed_weights(layers, taps: int) -> torch.Tensor:
    """:func:`pack_sweep_weights` of ``layers``, reused while its tensors
    are the same and unchanged (their version counters), so the split runs
    once per parameter state, not once per call. Keeps the last few weight
    sets; holding the source tensors keeps their ids from being reused."""
    src = tuple(v for pair in layers for v in pair)
    stamp = (taps,) + tuple((id(v), v._version) for v in src)
    hit = _PACKED.get(stamp)
    if hit is not None:
        _PACKED.move_to_end(stamp)
        return hit[1]
    blob = pack_sweep_weights(layers, taps)
    _PACKED[stamp] = (src, blob)
    while len(_PACKED) > _PACKED_SLOTS:
        _PACKED.popitem(last=False)
    return blob


_TABLES: Dict[tuple, torch.Tensor] = {}


def _device_table(lattice_shape, kernel, dev) -> torch.Tensor:
    key = (lattice_shape, kernel, str(dev))
    table = _TABLES.get(key)
    if table is None:
        table = torch.as_tensor(source_sites(lattice_shape, kernel),
                                device=dev)
        _TABLES[key] = table
    return table


def metropolis_sweep(params, s: torch.Tensor, log_psi_re: torch.Tensor, *,
                     lattice_shape: Sequence[int], n_props: int,
                     move: str = "flip", bonds: Optional[np.ndarray] = None,
                     noise=None):
    """Fused Metropolis sweep (see the module docstring).

    Args:
      params: flat Flax-keyed LogPsiCNN params (real, lncosh, no skips,
        periodic; the builder checks the model, this checks the params).
      s: [M, N] float32 walker configurations; log_psi_re: [M] cached
        Re log psi.
      n_props: proposals per walker (0 = recompute log psi only).
      move: 'flip' | 'exchange' (needs ``bonds`` [n_bonds, 2]).
      noise: (choices, log_u), each [n_props, M].

    Returns (s_out [M, N] f32, log_psi_out [M] f32, n_accept [M] int32).
    """
    if s.device.type == "cpu":
        return sweep_reference(params, s, log_psi_re,
                               lattice_shape=lattice_shape, n_props=n_props,
                               move=move, bonds=bonds, noise=noise)
    if s.device.type != "cuda":
        raise ValueError(f"metropolis_sweep runs on cuda or cpu tensors, got "
                         f"{s.device}")
    lattice_shape = tuple(int(v) for v in lattice_shape)
    layers = conv_layers(params, lattice_shape)
    site_a, site_b, log_u = _site_noise(s, move, bonds, n_props, noise)
    _check_log_psi(s, log_psi_re)
    m, n = s.shape
    if n != int(np.prod(lattice_shape)):
        raise ValueError(f"s has {n} sites, lattice {lattice_shape} has "
                         f"{int(np.prod(lattice_shape))}")
    dev = s.device
    kernel = tuple(int(k) for k in layers[0][0].shape[:-2])
    taps = int(np.prod(kernel))
    channels = [1] + [int(k.shape[-1]) for k, _ in layers]
    walkers = walkers_per_block(n, taps, channels)
    smem = smem_bytes(n, taps, channels, walkers)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the sweep kernel needs {smem} bytes of shared "
                         f"memory per block, above Hopper's {MAX_SMEM_BYTES}")
    for v in (x for pair in layers for x in pair):
        if v.device != dev:
            raise ValueError(f"params on {v.device}, s on {dev}")
    blob = packed_weights(layers, taps)
    nbr = _device_table(lattice_shape, kernel, dev)
    if n_props == 0:  # the kernel reads no noise
        site_a = site_b = nbr
        log_u = blob
    site_a = site_a.to(torch.int32).contiguous()
    site_b = site_b.to(torch.int32).contiguous()
    log_u = log_u.contiguous()
    s_in = s.contiguous()
    lp_in = log_psi_re.contiguous()
    for name, x in (("log_psi_re", lp_in), ("noise", log_u)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, s on {dev}")
    s_out = torch.empty_like(s_in)
    lp_out = torch.empty_like(lp_in)
    n_acc = torch.empty(m, dtype=torch.int32, device=dev)
    ch = (ctypes.c_int * len(channels))(*channels)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().metropolis_sweep_launch(
            s_in.data_ptr(), lp_in.data_ptr(), site_a.data_ptr(),
            site_b.data_ptr(), log_u.data_ptr(), blob.data_ptr(),
            nbr.data_ptr(), s_out.data_ptr(), lp_out.data_ptr(),
            n_acc.data_ptr(), m, n, taps, n_props, int(move == "exchange"),
            len(layers), ctypes.cast(ch, ctypes.c_void_p), walkers,
            launch_threads(n, channels, walkers), smem, stream)
    metropolis_sweep.launches += 1
    if err != 0:
        raise RuntimeError(f"metropolis_sweep launch failed: CUDA error {err}")
    return s_out, lp_out, n_acc


#: launches of the CUDA kernel since the last reset (CPU calls, which run
#: the plain version, do not count)
metropolis_sweep.launches = 0


class FusedCNNLogPsi:
    """``(params, s) -> log psi(s)`` [B] (im zero) of the plain real
    ``LogPsiCNN`` through the kernel's recompute mode (``n_props = 0``): the
    CNN's evaluation forward for the sampler's refresh and proposals and the
    local-energy batch. Evaluation only: no autograd through the kernel.
    Which configs may take it is decided once, by
    ``builder.cnn_forward_eligible``; the wrapper checks the params, shapes
    and device, and its packed weights are reused until the parameters
    change (:func:`packed_weights`)."""

    def __init__(self, *, lattice_shape: Sequence[int]):
        self.lattice_shape = tuple(int(v) for v in lattice_shape)

    def __call__(self, params, s: torch.Tensor) -> C:
        with torch.no_grad():
            s = s.to(torch.float32)
            _, lp, _ = metropolis_sweep(params, s, s.new_zeros(s.shape[0]),
                                        lattice_shape=self.lattice_shape,
                                        n_props=0)
        return C(lp, torch.zeros_like(lp))
