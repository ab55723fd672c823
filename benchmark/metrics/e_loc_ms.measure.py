"""e_loc_ms.measure: device ms per traced sample inside the program's
``e_loc`` spans (``measure.sample_estimators``' local energy)."""
from benchmark import program_spans


def read(run):
    if "samples" not in run:
        return None
    return program_spans.per_unit_ms(run, "e_loc")
