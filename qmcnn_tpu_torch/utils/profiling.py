"""Tracing and timing (port of ``qmcnn_tpu/utils/profiling.py``): the
program's spans and counters, and the profiler helpers that read a trace.

  * ``annotate(name, device=True)`` — the program's span, a context
    manager. It records only while a ``torch.profiler`` runs or inside
    :func:`recording`; otherwise it is one flag test and returns a shared
    no-op context. A recorded span holds its name, its parent (the span
    open around it), the unit (step or sample index, see :func:`unit`)
    and its host start and end on ``time.time_ns()`` (the profiler's
    ``trace_start_ns`` clock); with ``device`` and CUDA in use, also a
    CUDA event pair on the current stream, so its device time needs no
    synchronize (a pair is reused once its span has been read). Each
    span opens a ``torch.profiler.record_function`` range of its name, so
    a chrome trace shows it. Spans of the profiler's windows stay in memory
    until read (:func:`spans`, :func:`clear`).
  * ``recording()`` — a window that records spans without a profiler and
    keeps them: ``with recording() as w: ...`` then ``w.spans`` and
    ``w.seconds(names)``.
  * ``paused()`` — no span records inside it, profiler or window alike (a
    CUDA graph's capture, whose Python runs once and launches nothing).
  * ``count(name, value)`` / ``counters()`` — always-on process counters
    (the kernels' ``nvcc`` builds; pcg's blocks, masked overrun and CUDA
    graph captures, a few dict adds a solve); ``batch_rows(s)`` is the
    rows a model's forward sees, ``torch.func``'s batch included.
  * ``trace(logdir)`` — ``torch.profiler.profile`` with the CPU and (where
    a card is present) CUDA activities; writes the gzipped chrome trace into
    ``logdir`` and yields the profiler, which :func:`kernel_table`,
    :func:`idle_share` and :func:`idle_by_span` read.
  * ``idle_by_span(prof, spans)`` — the device's idle time in a trace put
    down to the host code that left it: each idle moment to the innermost
    span open on the host at that moment (:func:`attribute`), the rest to
    "untraced"; :func:`device_intervals` puts the trace's device events on
    the spans' clock.
  * ``step_split(vmc, state)`` — ms per step of each phase of
    ``VMC.step``, read from a recording window's spans.

Span names are dotted paths under their layer (``sr``, ``sr.pcg``,
``sr.pcg.wait``), so a reader can group a subtree by prefix.

The JAX module's ``enable_compilation_cache`` has no counterpart: the port
compiles nothing at run time but its CUDA kernels, which
``kernels/nvcc.py`` caches in ``qmcnn_tpu_torch/_build/`` already.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: the chrome trace's file name under ``trace``'s logdir
TRACE_FILE = "trace.json.gz"
#: a span's profiler range (torch's C++ fast path of ``record_function``)
_RANGE = torch._C._profiler._RecordFunctionFast


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "events",
                 "_device_ms")

    def __init__(self, name: str, parent: Optional["Span"], unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.start_ns = self.end_ns = None
        self.events = self._device_ms = None

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's CUDA events (waits for the end
        event, then hands the pair back for reuse); None for a host-only
        span."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            _free_events.extend(self.events)
            self.events = None
        return self._device_ms

    def ms(self) -> float:
        """Device ms where the span has events, else host ms."""
        dev = self.device_ms()
        return self.host_ms() if dev is None else dev


#: every span recorded since the last ``clear`` (or, outside a profiler,
#: since the outermost recording window opened), in order of opening
_spans: List[Span] = []
#: the spans open now, innermost last
_open: List[Span] = []
_counters: Dict[str, float] = defaultdict(float)
#: CUDA events whose span was read, taken again before new ones are made
_free_events: list = []
#: the stream object of each CUDA stream handle, so that a span's events
#: record without building one (``torch.cuda.current_stream`` does)
_streams: dict = {}
_windows = 0
_paused = 0
_unit = None


def _event():
    return (_free_events.pop() if _free_events
            else torch.cuda.Event(enable_timing=True))


def _current_stream():
    dev = torch.cuda.current_device()
    handle = torch._C._cuda_getCurrentRawStream(dev)
    stream = _streams.get(handle)
    if stream is None:
        stream = _streams[handle] = torch.cuda.current_stream(dev)
    return stream


class _Open:
    """The context of one recorded span."""

    __slots__ = ("name", "device", "span", "range", "stream")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device and torch.cuda.is_initialized()

    def __enter__(self) -> Span:
        parent = _open[-1] if _open else None
        span = self.span = Span(self.name, parent,
                                _unit if parent is None else parent.unit)
        span.start_ns = time.time_ns()
        self.range = _RANGE(span.name)
        self.range.__enter__()
        if self.device:
            self.stream = _current_stream()
            start = _event()
            start.record(self.stream)
            span.events = (start, None)
        _open.append(span)
        _spans.append(span)
        return span

    def __exit__(self, *exc) -> bool:
        span = self.span
        if self.device:
            end = _event()
            end.record(self.stream)
            span.events = (span.events[0], end)
        self.range.__exit__(*exc)
        _open.pop()
        span.end_ns = time.time_ns()
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str, device: bool = True):
    """The program's span ``name`` (see the module docstring); ``device``
    False records host times only (spans inside a tight loop, and parts of
    a layer whose device time nothing reads)."""
    if (_windows or _autograd_profiler._is_profiler_enabled) and not _paused:
        return _Open(name, device)
    return _OFF


@contextlib.contextmanager
def paused():
    """No span records inside (see the module docstring)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def unit(index) -> None:
    """The step or sample index that the spans opened from now on carry
    (a child takes its parent's)."""
    global _unit
    _unit = index


def spans() -> List[Span]:
    """The spans recorded under a profiler since the last :func:`clear`."""
    return list(_spans)


def clear() -> None:
    del _spans[:]


class Window:
    """The spans of one :func:`recording` window."""

    def __init__(self):
        self.spans: List[Span] = []

    def seconds(self, names: Iterable[str]) -> Dict[str, float]:
        """Total seconds of the spans of each of ``names`` (device time
        where a span has events, else host time), in the order first
        seen."""
        keep = set(names)
        out: Dict[str, float] = {}
        for sp in self.spans:
            if sp.name in keep:
                out[sp.name] = out.get(sp.name, 0.0) + sp.ms() / 1e3
        return out


@contextlib.contextmanager
def recording():
    """Record spans without a profiler; yields a :class:`Window` whose
    ``spans`` hold the spans opened inside it once it closes. When the
    outermost window closes, its spans leave the process's list unless a
    profiler runs."""
    global _windows
    window = Window()
    first = len(_spans)
    _windows += 1
    try:
        yield window
    finally:
        _windows -= 1
        window.spans = _spans[first:]
        if not (_windows or _autograd_profiler._is_profiler_enabled):
            del _spans[first:]


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to the process counter ``name``."""
    _counters[name] += value


def counters() -> Dict[str, float]:
    return dict(_counters)


def batch_rows(s: torch.Tensor) -> int:
    """Rows of a model input s [B, N], times the batch of every
    ``torch.func`` level that wraps it (a Jacobian's vmap over walkers
    calls the model once with B = 1): what a row counter adds."""
    n = s.shape[-1]
    while torch._C._functorch.is_functorch_wrapped_tensor(s):
        s = torch._C._functorch.get_unwrapped(s)
    return s.numel() // n


# ---------------------------------------------------------------------------
# the training step's phases
# ---------------------------------------------------------------------------

def step_split(vmc, state, n_steps: int = 3) -> Dict[str, float]:
    """Mean ms per step of each phase of ``vmc.step`` over ``n_steps``
    steps after one warm-up step from ``state``, read from the spans:
    ``sample`` (``sampler``), ``e_loc`` (in sector mode the sector ratio),
    ``deflation`` where the run deflates (``e_loc.deflation``, out of
    ``e_loc``), ``gradient``, ``sr`` and ``update``. With a walker group
    (``vmc.group``) this rank's split, collectives included."""
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key

    group = vmc.group
    m = vmc.sampler.physical(state.walkers).s.shape[0]
    ids = (torch.arange(m, device=state.walkers.s.device) if group is None
           else group.local_ids(m))
    key, warm = prng_key(7), state.step
    with recording() as window:
        for i in range(n_steps + 1):
            state, _ = vmc.step(state, fold_in(key, i), ids)
    totals: Dict[str, float] = defaultdict(float)
    for sp in window.spans:
        if sp.unit != warm:
            totals[sp.name] += sp.ms() / n_steps
    deflation = totals.get("e_loc.deflation")
    split = {"sample": totals["sampler"],
             "e_loc": totals["e_loc"] - (deflation or 0.0)}
    if deflation is not None:
        split["deflation"] = deflation
    split.update(gradient=totals["gradient"], sr=totals["sr"],
                 update=totals["update"])
    return split


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

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


def device_intervals(prof, device: str = "cuda") -> List[Tuple[int, int]]:
    """[(start, end)] of the events ``prof`` traced on ``device``, sorted,
    in ns on the spans' clock: the trace's ``trace_start_ns`` (epoch ns, as
    ``time.time_ns()``) plus each event's offset."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    want = _device_type(device)
    return sorted((t0 + round(e.time_range.start * 1e3),
                   t0 + round(e.time_range.end * 1e3))
                  for e in prof.events() if e.device_type == want
                  and e.time_range.end > e.time_range.start)


def _idle_pieces(busy, window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The parts of ``window`` that no interval of ``busy`` (sorted by
    start) covers, in time order."""
    lo, hi = window
    out, t = [], lo
    for a, b in busy:
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def _innermost(spans) -> List[Tuple[int, int, str]]:
    """[(start, end, name)] sorted: the parts of each span's host interval
    that none of its children covers, where it is the innermost open span.
    Spans nest, so the parts are disjoint."""
    children = defaultdict(list)
    for sp in spans:
        if sp.parent is not None:
            children[id(sp.parent)].append(sp)
    out = []
    for sp in spans:
        t = sp.start_ns
        for ch in sorted(children[id(sp)], key=lambda c: c.start_ns):
            if ch.start_ns > t:
                out.append((t, ch.start_ns, sp.name))
            t = max(t, ch.end_ns)
        if sp.end_ns > t:
            out.append((t, sp.end_ns, sp.name))
    return sorted(out)


def attribute(spans, busy, window: Tuple[int, int]
              ) -> Tuple[Dict[str, int], int]:
    """({span name: idle ns}, untraced idle ns) of ``window``: each moment
    that no interval of ``busy`` covers goes to the innermost span open on
    the host at that moment, and to "untraced" where none is open. The
    parts sum to the window's idle time."""
    idle = _idle_pieces(sorted(busy), window)
    inner = _innermost(spans)
    parts: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b in idle:
        while j < len(inner) and inner[j][1] <= a:
            j += 1
        k = j
        while k < len(inner) and inner[k][0] < b:
            s0, s1, name = inner[k]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                parts[name] += overlap
            k += 1
    untraced = sum(b - a for a, b in idle) - sum(parts.values())
    return dict(parts), untraced


def idle_by_span(prof, spans, device: str = "cuda"
                 ) -> Optional[Tuple[Dict[str, float], float]]:
    """The idle time of ``prof``'s window on ``device`` (the window of
    :func:`idle_share`) put down to the host code that left it, by
    :func:`attribute` over ``spans`` (those recorded under ``prof``):
    ({span name: share of the window}, untraced share). The shares sum to
    ``idle_share(prof)``. None when the trace holds no event on
    ``device``."""
    busy = device_intervals(prof, device)
    if not busy:
        return None
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = list(prof.events())
    lo = t0 + round(min(e.time_range.start for e in events) * 1e3)
    hi = t0 + round(max(e.time_range.end for e in events) * 1e3)
    parts, untraced = attribute(spans, busy, (lo, hi))
    scale = 1.0 / max(hi - lo, 1)
    return {k: v * scale for k, v in parts.items()}, untraced * scale
