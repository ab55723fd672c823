"""sample_ms: the measured window over the measured samples it
completed, on the host clock."""
from benchmark import readers


def read(run):
    return readers.per_item_ms(run) if "samples" in run else None
