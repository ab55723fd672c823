"""kernel_build_s: seconds this process spent compiling the CUDA kernels
with ``nvcc``, the program's counter (``kernels/nvcc.build_library``; 0
where every kernel was built before)."""
from benchmark import program_spans


def read(run):
    return program_spans.counter("kernel_build_s")
