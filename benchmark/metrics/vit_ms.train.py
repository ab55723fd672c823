"""vit_ms.train: device ms per traced step inside the program's ``vit``
spans (``models/vit.LogPsiViT.forward``, from the rolls to the
logmeanexp: every forward of the sweep, E_loc, the gradient and the score
Jacobian; their backward passes lie outside)."""
from benchmark import program_spans


def read(run):
    return program_spans.per_unit_ms(run, "vit") if "steps" in run else None
