"""sr_iters.train: the mean of StepMetrics.sr_iters over the window, the
program's own count of pcg iterations (none where the solver takes no
iterations)."""
from benchmark import readers


def read(run):
    if "steps" not in run or run["cfg"]["sr"]["solver"] != "pcg":
        return None
    return readers.mean(run.get("sr_iters"))
