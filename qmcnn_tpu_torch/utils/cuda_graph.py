"""CUDA graphs of the port: pcg's blocks (``sr.PCGGraph``) and the torch
Metropolis sweep (``sampler/metropolis.SweepGraph``) are captured here.

  * ``capture_stream(device)`` — the device's capture stream, made at first
    use and shared by every graph of the process (cuBLAS keeps a workspace
    for every stream it runs on).
  * ``capture(run, warm_up, device, tallies)`` — runs ``warm_up`` on the
    capture stream (cuBLAS's workspace, a forward's lazy set-up), then
    captures ``run`` there as a ``torch.cuda.CUDAGraph``, with no span
    recording (:func:`profiling.paused`): the capture's Python runs once
    and launches nothing. The cycle collector is off during the capture:
    a graph it freed there (one held in a reference cycle) would end the
    capture. What the capture moved of ``tallies`` is taken
    back and returned, for each replay to add again (:func:`add_tallies`).
  * :class:`GraphSafe` — a log psi forward's declaration, as its attribute
    ``graph_safe``, that a graph may replay its calls: it makes no host
    sync and keeps no host-side cache that a replay would leave stale.

A tally is a process counter of ``utils/profiling`` by its name, or a
number held as an attribute (a kernel's launch and row tallies) by its
``(holder, attribute)`` pair.
"""
from __future__ import annotations

import gc
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from qmcnn_tpu_torch.utils.profiling import count, counters, paused

_streams: dict = {}


class GraphSafe(NamedTuple):
    """See the module docstring. ``span``: the span a call records, which a
    replay opens around itself so that the span's readers keep its time;
    ``tallies``: what a call adds to, which a replay adds again."""

    span: Optional[str] = None
    tallies: Tuple = ()


def capture_stream(device) -> torch.cuda.Stream:
    device = torch.device(device)
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


def tallies(names) -> dict:
    """The values of the tallies ``names`` (see the module docstring)."""
    held = counters()
    return {n: getattr(*n) if isinstance(n, tuple) else held.get(n, 0)
            for n in names}


def add_tallies(change: dict, times: int = 1) -> None:
    """Add ``times`` x ``change`` ({tally: value}) to the tallies."""
    for n, v in change.items():
        if isinstance(n, tuple):
            setattr(n[0], n[1], getattr(*n) + v * times)
        else:
            count(n, v * times)


def capture(run: Callable, warm_up: Callable, device, tallies_of=()):
    """``(graph, what run returned, change)`` (see the module docstring)."""
    device = torch.device(device)
    side = capture_stream(device)
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm_up()
        cur.wait_stream(side)
        before = tallies(tallies_of)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with paused(), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                out = run()
        finally:
            if collecting:
                gc.enable()
    after = tallies(tallies_of)
    change = {n: after[n] - before[n] for n in after
              if after[n] != before[n]}
    add_tallies(change, -1)
    return graph, out, change
