"""vit_mlp_ms.train: device ms per traced step inside the program's
``vit.mlp`` spans (each block's ln2, mlp1, GELU, mlp2 and residual)."""
from benchmark import program_spans


def read(run):
    if "steps" not in run:
        return None
    return program_spans.per_unit_ms(run, "vit.mlp")
