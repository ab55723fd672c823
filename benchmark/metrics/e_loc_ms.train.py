"""e_loc_ms.train: device ms per traced step inside the program's ``e_loc``
spans (``vmc.energy_and_grad`` around the local energy), from the CUDA
events the program's recorder keeps."""
from benchmark import program_spans


def read(run):
    return program_spans.per_unit_ms(run, "e_loc") if "steps" in run else None
