"""k1_roofline.train: K1's least time for the evaluation forwards the
traced training steps needed (refresh, changing sweep proposals, E_loc
rows with an element) over the device time of ``sweep_kernel``, against
the float32 (3xTF32) peak."""
from benchmark import readers


def read(run):
    if "steps" not in run:
        return None
    return readers.kernel_roofline(run, "sweep_kernel", "float32")
