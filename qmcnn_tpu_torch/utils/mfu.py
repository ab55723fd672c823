"""Model FLOPs Utilization (MFU): achieved FLOP/s over the card's peak
(port of ``qmcnn_tpu/utils/mfu.py``).

FLOP counts:
  * :func:`counted_flops` counts one call of a function through
    ``torch.utils.flop_counter.FlopCounterMode``, the counterpart of the
    JAX module's ``compiled_flops`` (XLA's cost analysis). Both count a
    multiply-add as 2 FLOPs and agree exactly on a product. FlopCounterMode
    counts only matrix products, convolutions and attention, where XLA also
    counts elementwise ops and transcendentals, so on a model forward this
    count is lower than XLA's by the elementwise share. Its formula for a
    convolution's backward ignores ``groups`` in the weight gradient, which
    it counts ``groups`` times over; ``torch.func``'s per-sample gradients
    (the SR Jacobian) are such grouped convolutions, one group per sample,
    so the counter here divides that term by the groups
    (:func:`_conv_backward_flop`).
  * The hand kernels (``kernels/metropolis_sweep.py``,
    ``kernels/gcnn_forward.py``) launch through ``ctypes`` and are
    invisible to the counter; their work is counted by hand:
    :func:`forward_flop` (one forward of the real CNN, the work of K1 per
    configuration and proposal) and :func:`gcnn_flop` (K2's group sums).
  * :func:`step_flops` is one ``VMC.step``: the counted torch ops plus the
    configurations each kernel computed in the step (the wrappers' ``rows``
    tallies) times the hand model. Eager PyTorch runs every loop trip, so
    there is no trip correction (the JAX module's ``true_step_flops`` needs
    one: XLA counts a loop body once).
  * :func:`pallas_sweep_flops_per_proposal` is the JAX module's hand model
    of the TPU sweep kernel (dense circulant matrices [N Cin, N Cout] per
    layer), kept for parity: it counts the TPU kernel's work, N / taps
    times K1's, so it is not the numerator of K1's MFU.

Peak table (dense, NVIDIA's data sheet, at the 700 W limit):
  * H100 SXM ("H100 80GB HBM3", "H100 SXM"): bfloat16 989e12; float32
    495e12 / 3, the 3xTF32 rate at which both f32 hand kernels run (three
    TF32 passes for an f32-accurate product, the same 3-pass convention as
    the JAX module's v5e entry). The FP32-core rate, 67e12, is
    :data:`H100_FP32_CORE_FLOPS`.
  * Any other card, and the CPU: None (callers print 'n/a').
"""
from __future__ import annotations

from typing import Optional

import torch

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
#: float32 on the FP32 cores, outside the tensor cores
H100_FP32_CORE_FLOPS = 67e12
#: TF32 passes of an f32-accurate product (3xTF32: hi*hi + hi*lo + lo*hi)
TF32_PASSES = 3
_H100 = {"bfloat16": H100_BF16_FLOPS,
         "float32": H100_TF32_FLOPS / TF32_PASSES}
_PEAKS = {
    # torch.cuda.get_device_name substring (lowercased) -> dtype -> FLOP/s
    "h100 80gb hbm3": _H100,
    "h100 sxm": _H100,
}


def device_peak_flops(compute_dtype: str = "float32",
                      device=None) -> Optional[float]:
    """Per-card dense peak for the model's compute dtype, or None (the CPU,
    or a card not in the table)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev).lower()
    for sub, table in _PEAKS.items():
        if sub in name:
            return table.get(str(compute_dtype))
    return None


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                        padding, dilation, transposed, output_padding, groups,
                        output_mask, out_shape, **kwargs) -> int:
    """FlopCounterMode's convolution-backward formula with the weight
    gradient's term divided by ``groups`` (the formula counts it as an
    ungrouped convolution)."""
    from torch.utils import flop_counter

    # the registered formula is wrapped to take tensors; this takes shapes
    raw = getattr(flop_counter.conv_backward_flop, "__wrapped__",
                  flop_counter.conv_backward_flop)

    def term(mask):
        return raw(grad_out_shape, x_shape, w_shape, bias,
                                  stride, padding, dilation, transposed,
                                  output_padding, groups, mask, out_shape)

    return (term([output_mask[0], False, False])
            + term([False, output_mask[1], False]) // max(groups, 1))


def flop_counter():
    """A ``FlopCounterMode`` (no display) with the grouped weight gradient
    counted once (:func:`_conv_backward_flop`)."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})


def counted_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)`` as FlopCounterMode counts
    them (matrix products, convolutions, attention; 2 per multiply-add);
    None when it counts none."""
    counter = flop_counter()
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def forward_flop(params, n_sites: int) -> int:
    """FLOPs of one LogPsiCNN forward's convolutions (2 per MAC): the work
    of K1 per configuration and proposal."""
    flop = 0
    for k, v in params.items():
        if k.endswith("/kernel"):
            flop += 2 * n_sites * v.numel()
    return flop


def gcnn_flop(hw: int, width: int, n_layers: int, cplx: bool,
              batch: int) -> float:
    """The least FLOPs for the readout sums of ``batch`` configurations:
    the lift (9 taps, Cin = 1, real input: 1 real product per part) and
    L-1 group layers (9 taps, W -> W), 2 per MAC. A complex group layer
    takes 3 real products (Karatsuba, as the model computes it) plus
    4 HW W additions (the input sum re + im, and p1 - p2, p3 - p1 - p2 on
    the outputs), and 9 W^2 for the weight sum, once per call. The kernel
    itself does the direct form's 4 products."""
    lift = 9 * hw * width * 2 * (2 if cplx else 1)
    group = 9 * hw * width * width * 2 * (3 if cplx else 1)
    if cplx:
        group += 4 * hw * width
    once = (n_layers - 1) * 9 * width * width if cplx else 0
    return float(batch) * (lift + (n_layers - 1) * group) + once


def _kernel_rows() -> dict:
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    return {"k1": k1.metropolis_sweep.rows,
            "k2": k2.gcnn_group_sums.rows + k2.gcnn_group_sums.rows_bf16}


def step_flops(vmc, state, ids, key: int = 0) -> Optional[float]:
    """FLOPs of one ``vmc.step(state, key, ids)``: FlopCounterMode over the
    step's torch ops, plus each kernel's configurations in the step times
    its hand model (K1: :func:`forward_flop` of the state's params; K2:
    :func:`gcnn_flop` at the GCNN's shape; its rows count the spin-flip
    projection's doubled batch). None when nothing is counted. Runs the
    step once; its result is discarded."""
    before = _kernel_rows()
    counter = flop_counter()
    with counter:
        vmc.step(state, key, ids)
    after = _kernel_rows()
    total = float(counter.get_total_flops())
    if after["k1"] > before["k1"]:
        n_sites = int(state.walkers.s.shape[1])
        total += (after["k1"] - before["k1"]) * forward_flop(state.params,
                                                             n_sites)
    if after["k2"] > before["k2"]:
        shape = _gcnn_shape(vmc)
        total += gcnn_flop(*shape, batch=after["k2"] - before["k2"])
    return total if total > 0 else None


def _gcnn_shape(vmc):
    """(hw, width, n_layers, complex) of the fused GCNN forward behind
    ``vmc.eval_log_psi_fn``."""
    from qmcnn_tpu_torch.kernels.gcnn_forward import G

    fused = vmc.eval_log_psi_fn
    hw = int(fused.lattice_shape[0] * fused.lattice_shape[1])
    return (hw, G * fused.channels[0], len(fused.channels),
            bool(fused.complex_params))


def pallas_sweep_flops_per_proposal(params, lattice_shape,
                                    move: str = "exchange") -> float:
    """The JAX module's hand model of one TPU sweep-kernel proposal, PER
    WALKER, over the port's ``conv_layers``: the dense circulant matmuls
    (2 Ni No per layer, Ni = N Cin, No = N Cout), ~6 FLOPs per activation
    element for the bias and lncosh readout, and ~6N (flip) or ~14N
    (exchange) for the proposal and the accept/update."""
    import numpy as np

    from qmcnn_tpu_torch.kernels.metropolis_sweep import conv_layers

    n = float(np.prod(lattice_shape))
    mm = elem = 0.0
    for kern, _ in conv_layers(params, tuple(lattice_shape)):
        ni, no = n * kern.shape[-2], n * kern.shape[-1]
        mm += 2.0 * ni * no
        elem += 6.0 * no
    prop = (6.0 if move == "flip" else 14.0) * n
    return mm + elem + prop


def mfu(flops_per_call: Optional[float], seconds_per_call: float,
        compute_dtype: str = "float32") -> Optional[float]:
    """Fraction of the card's peak: (flops/s achieved) / peak. None if
    unknown."""
    peak = device_peak_flops(compute_dtype)
    if flops_per_call is None or peak is None or seconds_per_call <= 0:
        return None
    return (flops_per_call / seconds_per_call) / peak


def fmt_mfu(value: Optional[float]) -> str:
    return "n/a" if value is None else f"{100.0 * value:.1f}%"
