"""k2_bf16_roofline.train: K2's least time for the traced steps'
evaluation forwards over the device time of ``gcnn_forward_bf16_kernel``,
against the dense bf16 peak."""
from benchmark import readers


def read(run):
    if "steps" not in run:
        return None
    return readers.kernel_roofline(run, "gcnn_forward_bf16_kernel",
                                   "bfloat16")
