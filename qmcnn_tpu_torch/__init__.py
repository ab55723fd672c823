"""qmcnn_tpu_torch: the PyTorch/CUDA port of qmcnn_tpu.

Same module layout as ``qmcnn_tpu`` (each module here has one counterpart
there, which stays the reference), PyTorch inside, and the fused Metropolis
sweep as a hand-written CUDA kernel for Hopper
(``csrc/metropolis_sweep.cu``). Imports no part of JAX or of ``qmcnn_tpu``.

    python -m qmcnn_tpu_torch.train --config configs/heis10x10_sr.yaml
"""

__version__ = "0.1.0"
