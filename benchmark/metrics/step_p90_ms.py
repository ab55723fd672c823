"""step_p90_ms: the 90th percentile of the intervals between consecutive
step-start CUDA events, every step of the window."""
from benchmark import readers


def read(run):
    return readers.percentile(run.get("intervals_ms"), 90.0)
