"""nn_ss_ms.measure: device ms per traced sample inside the program's
``nn_ss`` spans (``measure.sample_estimators``' nearest-neighbour S.S)."""
from benchmark import program_spans


def read(run):
    if "samples" not in run:
        return None
    return program_spans.per_unit_ms(run, "nn_ss")
