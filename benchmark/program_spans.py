"""The program's own spans and counters, read in the run's process from
its recorder (``qmcnn_tpu_torch/utils/profiling``).

The program records spans only while a profiler runs, so the spans held
after a traced run are those of its traced window (``DeviceTrace``). A
span's name is a dotted path under its layer (``sr``, ``sr.pcg``,
``sr.pcg.wait``). Each reader finds nothing, and returns None, where the
program keeps no recorder or counters (a program older than its spans),
where the run was not traced, or where no span of the name was recorded.
"""
from __future__ import annotations

from typing import Optional


def recorded() -> Optional[list]:
    """The spans the program holds, or None where it keeps no recorder."""
    from qmcnn_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def counter(name: str) -> Optional[float]:
    """The program's process counter ``name`` (0 where nothing counted),
    or None where the program keeps no counters."""
    from qmcnn_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return None if read is None else float(read().get(name, 0.0))


def per_unit_ms(run: dict, name: str, device: bool = True
                ) -> Optional[float]:
    """ms per traced step (or sample) inside the spans named ``name``: the
    spans' CUDA-event time with ``device``, else their host time."""
    spans = recorded()
    a, b = run.get("traced_steps", (0, 0))
    picked = [sp for sp in spans or () if sp.name == name]
    if not picked or b <= a:
        return None
    ms = [sp.device_ms() if device else sp.host_ms() for sp in picked]
    if any(x is None for x in ms):
        return None
    return sum(ms) / (b - a)

