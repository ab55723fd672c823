"""Building the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.

Each library is compiled at first use from this repository's sources only,
into ``qmcnn_tpu_torch/_build/`` (git-ignored), under a name that hashes the
source and the flags, so an edited source is rebuilt. Each compile adds
its seconds in ``nvcc`` to the process counter ``kernel_build_s`` (a
library found built adds nothing).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

from qmcnn_tpu_torch.utils.profiling import count

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
#: --split-compile=0: optimize the kernels of a source in parallel on every
#: core (the bf16 GCNN route's 16 instantiations build in about half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")
#: shared memory one Hopper block may use (227 KB)
MAX_SMEM_BYTES = 232448


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the GPU")


def build_library(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless this version is built already. Returns
    (library path, compiler log; empty when it was built before)."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    count("kernel_build_s", time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial
    return out, proc.stdout + proc.stderr
