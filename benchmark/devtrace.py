"""A trace of the device alone: ``torch.profiler`` with CUDA activity only
(host-side op recording would slow the host, which is the bottleneck of
these steps, and inflate the idle share), reduced to device time by kernel
name, the union of busy intervals, and the idle gaps by the operation that
ends them."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import torch

from benchmark.counts import idle


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("std::enable_if<") and ">::type " in name:
        name = name.split(">::type ", 1)[1]
    head = name.split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return (head or name)[:96]


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` around synchronized work; then
    ``tr.summary()`` gives {"window_s", "busy_s", "kernels": {name:
    [seconds, count]}, "gaps": {name: [seconds, count]}}."""

    def __init__(self):
        self._prof = None
        self.window_s = 0.0
        self.t0 = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        cuda = torch.autograd.DeviceType.CUDA
        spans = []
        kernels = defaultdict(lambda: [0.0, 0])
        for ev in self._prof.events():
            if ev.device_type != cuda:
                continue
            a, b = ev.time_range.start, ev.time_range.end
            if b <= a:
                continue
            name = short_name(ev.name)
            spans.append((a * 1e-6, b * 1e-6, name))
            kernels[name][0] += (b - a) * 1e-6
            kernels[name][1] += 1
        busy = idle.union((a, b) for a, b, _ in spans)
        gaps = defaultdict(lambda: [0.0, 0])
        for length, name in idle.gaps(spans):
            gaps[f"before {name}"][0] += length
            gaps[f"before {name}"][1] += 1
        return {"window_s": self.window_s, "busy_s": busy,
                "kernels": dict(kernels), "gaps": dict(gaps)}


class TraceWindow:
    """The traced part of a measured window: whole units (steps or samples)
    from the ``first``-th on, until ``seconds`` of them are traced or the
    window ends."""

    def __init__(self, on: bool, first: int, seconds: float = 2.0):
        self.on, self.first, self.seconds = on, first, seconds
        self.active: Optional[DeviceTrace] = None
        self.finished: Optional[DeviceTrace] = None
        self.units = [0, 0]

    def before(self, count: int) -> None:
        if (self.on and self.finished is None and self.active is None
                and count >= self.first):
            self.active = DeviceTrace().__enter__()
            self.units[0] = count

    def after(self, count: int, window_done: bool) -> None:
        if self.active is None:
            return
        traced = time.perf_counter() - self.active.t0
        if window_done or traced >= self.seconds:
            self.active.__exit__(None, None, None)
            self.units[1] = count
            self.finished, self.active = self.active, None

    def summary(self) -> Optional[dict]:
        return None if self.finished is None else self.finished.summary()


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time, and the ten largest
    totals of idle gaps by the operation that ended them."""
    def top(table):
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:10]
        return [[name, sec] for name, (sec, _) in rows]
    return {"device_ops": top(summary["kernels"]),
            "idle_gaps": top(summary["gaps"])}


def kernel_seconds(summary: dict, key: str) -> float:
    """Device seconds of the kernels whose name holds ``key``."""
    return sum(sec for name, (sec, _) in summary["kernels"].items()
               if key in name)
