"""pcg_wait_ms.train: host ms per traced step blocked in pcg's loop-flag
reads, the program's ``sr.pcg.wait`` spans (``sr._agreed``: one before
the loop and one per iteration)."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "sr.pcg.wait", device=False)
