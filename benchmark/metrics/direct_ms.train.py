"""direct_ms.train: device ms per traced step inside the program's
``sampler.direct`` spans (``sampler/direct.DirectSampler.sample``: a
pass's N conditional forwards over the walker batch and its closing log
psi)."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "sampler.direct")
