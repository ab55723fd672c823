"""mfu.train: the benchmark's count of a step's FLOPs (counts/flops.py)
over the step time and the card's peak at the configuration's compute
dtype."""
from benchmark import readers


def read(run):
    return readers.step_mfu(run) if "steps" in run else None
