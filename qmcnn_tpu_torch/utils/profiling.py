"""Tracing and timing helpers (port of ``qmcnn_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — context manager around ``torch.profiler.profile``
    with the CPU and (where a card is present) CUDA activities; writes the
    gzipped chrome trace (``export_chrome_trace``) into ``logdir`` and
    yields the profiler, which :func:`kernel_table` and :func:`idle_share`
    read.
  * ``annotate(name)`` — ``torch.profiler.record_function``, to label the
    sampler / local-energy / SR regions in the trace timeline.
  * ``timed(fn)`` — wall-clock timing with ``torch.cuda.synchronize()``
    after each call on CUDA (the JAX helper's ``block_until_ready``).
  * ``scan_rate`` — throughput by length differencing: run a body N1 and
    N2 times and difference the wall-clocks, which cancels the fixed cost
    of a call.
  * ``kernel_table(prof)`` — device time and count by kernel name, from the
    profiler's ``key_averages()``.
  * ``idle_share(prof)`` — 1 - (union of the device's busy intervals) /
    (the traced window), from the trace's events.

The JAX module's ``enable_compilation_cache`` has no counterpart: the port
compiles nothing at run time but its CUDA kernels, which
``kernels/nvcc.py`` caches in ``qmcnn_tpu_torch/_build/`` already.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import torch

annotate = torch.profiler.record_function

#: the chrome trace's file name under ``trace``'s logdir
TRACE_FILE = "trace.json.gz"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/prof') as prof: run()``. The
    device is synchronized before the profiler stops, so the window holds
    every kernel launched inside it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """(mean seconds, last result), synchronizing the card after each
    call."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
        _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        result = fn(*args)
        _sync()
    return (time.perf_counter() - t0) / reps, result


def scan_rate(make_scan: Callable[[int], Callable], n_short: int,
              n_long: int, reps: int = 3) -> float:
    """Iterations/sec of a repeated body, the fixed cost of a call
    cancelled. ``make_scan(n)`` returns a zero-arg callable that runs the
    body n times."""

    def timeit(f):
        f()  # warm (first launches build and cache)
        _sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
            _sync()
        return (time.perf_counter() - t0) / reps

    t_short = timeit(make_scan(n_short))
    t_long = timeit(make_scan(n_long))
    dt = max((t_long - t_short) / (n_long - n_short), 1e-12)
    return 1.0 / dt


def _device_type(name: str):
    return getattr(torch.autograd.DeviceType, name.upper())


def _self_time_us(avg, device: str) -> float:
    if device == "cpu":
        return float(avg.self_cpu_time_total)
    for attr in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total", "cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    return 0.0


def kernel_table(prof, device: str = "cuda") -> List[dict]:
    """[{"name", "count", "total_ms"}] of the events run on ``device``
    ('cuda': the kernels, memory copies and sets; 'cpu': the host ops, by
    self time), by total time, largest first."""
    want = _device_type(device)
    rows = [{"name": avg.key, "count": int(avg.count),
             "total_ms": _self_time_us(avg, device) / 1e3}
            for avg in prof.key_averages() if avg.device_type == want]
    return sorted((r for r in rows if r["total_ms"] > 0),
                  key=lambda r: -r["total_ms"])


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_share(prof, device: str = "cuda") -> Optional[float]:
    """1 - (union of the intervals of the events run on ``device``) / (the
    traced window: the first event's start to the last event's end, over
    every event). None when the trace holds no event on ``device``."""
    want = _device_type(device)
    events = list(prof.events())
    busy = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == want and e.time_range.end > e.time_range.start]
    if not busy:
        return None
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    return 1.0 - _union_us(busy) / max(end - start, 1e-9)
