"""step_ms: the measured window over the training steps it completed, on
the host clock, the window ending in a synchronize."""
from benchmark import readers


def read(run):
    return readers.per_item_ms(run) if "steps" in run else None
