"""gradient_ms.train: device ms per traced step inside the program's
``gradient`` spans (``vmc._surrogate_grads``: the surrogate loss's
backward and its mean over the walker group)."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "gradient")
