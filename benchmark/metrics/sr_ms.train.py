"""sr_ms.train: device ms per step between the events around the SR
solver's solve."""
from benchmark import readers


def read(run):
    return readers.mean(run.get("sr_ms")) if "steps" in run else None
