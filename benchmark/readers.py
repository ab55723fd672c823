"""Arithmetic the metric readers (``metrics/<name>.py``) share. A reader
takes the run record a driver returns and gives a number, or None where
the record holds nothing for it."""
from __future__ import annotations

import math
from typing import Optional

from benchmark import devtrace
from benchmark.counts import flops, peaks


def per_item_ms(run: dict) -> Optional[float]:
    """The window over the steps (or samples) it completed, in ms."""
    n = run.get("steps", run.get("samples"))
    if not n:
        return None
    return 1e3 * run["window_s"] / n


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def idle_percent(run: dict) -> Optional[float]:
    tr = run.get("devtrace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_roofline(run: dict, kernel: str, dtype: str) -> Optional[float]:
    """100 x the least time of the evaluation forwards the traced steps
    needed (``counts/flops``) over the device time of ``kernel`` in the
    trace; None when the trace holds no such kernel."""
    tr = run.get("devtrace")
    if not tr:
        return None
    seconds = devtrace.kernel_seconds(tr, kernel)
    if seconds <= 0:
        return None
    a, b = run["traced_steps"]
    rows = sum(run["eval_rows"][a:b])
    cfg = run["cfg"]
    bound = peaks.roofline_seconds(rows * flops.forward_flop(cfg),
                                   rows * flops.forward_bytes(cfg), dtype)
    return 100.0 * bound / seconds


def step_mfu(run: dict) -> Optional[float]:
    """100 x the counted FLOPs of the window's steps over their time and
    the card's peak at the configuration's dtype. The
    steps run under the profiler, and the one whose interval holds its
    start and stop, are left out: the time of a step is the interval
    between its start event and the next one."""
    work, times = run.get("step_flop"), run.get("intervals_ms")
    if not work or not times:
        return None
    a, b = run.get("traced_steps", (0, 0))
    keep = [t for t in range(len(times)) if not a - 1 <= t <= b]
    seconds = sum(times[t] for t in keep) / 1e3
    if seconds <= 0:
        return None
    dtype = run["cfg"]["model"]["compute_dtype"]
    return 100.0 * sum(work[t] for t in keep) / seconds / peaks.peak_flops(
        dtype)


def mean(values) -> Optional[float]:
    return sum(values) / len(values) if values else None
