"""k1_roofline.measure: the same for the measured samples (refresh, the
sweeps' changing proposals, E_loc and nearest-neighbour S.S rows with an
element)."""
from benchmark import readers


def read(run):
    if "samples" not in run:
        return None
    return readers.kernel_roofline(run, "sweep_kernel", "float32")
