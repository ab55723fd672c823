"""device_idle.train: 1 - (union of the device's operations) / (the traced
window) of a training run, from a CUDA-only profiler trace."""
from benchmark import readers


def read(run):
    return readers.idle_percent(run) if "steps" in run else None
