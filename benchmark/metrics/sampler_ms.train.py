"""sampler_ms.train: device ms per step between the events around the
sampler's refresh and sample."""
from benchmark import readers


def read(run):
    return readers.mean(run.get("sampler_ms")) if "steps" in run else None
