"""Peaks of the card, frozen from NVIDIA's H100 SXM data sheet (dense rates,
no sparsity, at the 700 W limit). A float32 product at float32 accuracy
on the tensor cores takes three TF32 passes, so float32 work counts
against a third of the TF32 rate; a bf16 configuration's float32 parts
count against the bf16 peak, which can only understate its share.
"""
from __future__ import annotations

#: dense FLOP/s by compute dtype
FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3.0}
#: HBM3 bytes/s
HBM_BYTES = 3.35e12
#: the power limit the rates above assume
POWER_LIMIT_W = 700.0


def peak_flops(dtype: str) -> float:
    return FLOPS[dtype]


def roofline_seconds(flop: float, nbytes: float, dtype: str) -> float:
    """The least time the work can take: the larger of its operations over
    the peak and its bytes over the bandwidth."""
    return max(flop / FLOPS[dtype], nbytes / HBM_BYTES)
