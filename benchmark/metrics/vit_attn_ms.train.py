"""vit_attn_ms.train: device ms per traced step inside the program's
``vit.attn`` spans (each block's ln1, factored attention and residual)."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "vit.attn")
