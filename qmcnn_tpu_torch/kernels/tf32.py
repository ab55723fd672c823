"""TF32 helpers shared by the port's tensor-core kernels (the fused sweep,
``kernels/metropolis_sweep.py``, and the fused GCNN forward,
``kernels/gcnn_forward.py``): the host-side split of float32 weights into
the hi/lo TF32 parts that their 3xTF32 products take."""
from __future__ import annotations

from typing import Tuple

import torch


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (the low 13 mantissa bits zero), to
    nearest with ties away from zero, as PTX ``cvt.rna.tf32.f32`` rounds
    finite values."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``w`` = hi + lo with both parts TF32: hi is ``w`` rounded to
    nearest (:func:`tf32_rna`), and lo the same rounding of the exact
    remainder ``w - hi``. hi + lo is within 2^-22 of ``w``, relative."""
    hi = tf32_rna(w)
    return hi, tf32_rna(w - hi)
