"""jacobian_ms.train: device ms per traced step inside the program's
``sr.jacobian`` spans (``sr.make_jacobian_s``: the score matrices, their
centering and diag(S))."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "sr.jacobian")
