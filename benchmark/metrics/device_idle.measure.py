"""device_idle.measure: the device's idle share of the traced window of a
measurement run."""
from benchmark import readers


def read(run):
    return readers.idle_percent(run) if "samples" in run else None
