"""Device busy time from a trace: the union of the intervals in which an
operation ran on the device, so overlapping kernels count once."""
from __future__ import annotations

from typing import Iterable, List, Tuple


def union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float, str]]
         ) -> List[Tuple[float, str]]:
    """[(length, name of the operation that ends it)] of every idle gap
    between the device's operations, in time order."""
    out, end = [], None
    for a, b, name in sorted(intervals):
        if end is not None and a > end:
            out.append((a - end, name))
        end = b if end is None else max(end, b)
    return out
