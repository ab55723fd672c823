"""arnn_ms.train: device ms per traced step inside the program's ``arnn``
spans (``models/arnn.LogPsiARNN.forward`` of log psi, from the trunk to
the summed log-probabilities and phases: the direct pass's closing log
psi, E_loc, the gradient and the score Jacobian; their backward passes and
the pass's conditional forwards lie outside)."""
from benchmark import program_spans


def read(run):
    return program_spans.per_unit_ms(run, "arnn") if "steps" in run else None
