"""ctypes bindings for the native ED matvec kernels (port of
``qmcnn_tpu/ops/exact_native.py``, over the repository's
``native/ed_kernels.cpp``, which has no JAX in it).

The library is compiled on first use with g++ (the JAX module's flags:
-O3 -march=native -fopenmp, retried without OpenMP and -march=native when
that fails) into the port's git-ignored ``qmcnn_tpu_torch/_build/``, under
a name that hashes the source, the flags and the host (``-march=native``
builds for this machine's CPU), as ``kernels/nvcc.py`` names its
libraries; the JAX package's ``native/build/`` is never written. When no
build succeeds, :func:`available` is False and the operators raise
``RuntimeError``: nothing falls back silently to the sparse path of
:mod:`qmcnn_tpu_torch.ops.exact`.

The matvec applies H on the fly (no matrix storage), so Lanczos ground
energies reach N ~ 24 where the sparse build would need tens of GB.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import scipy.sparse.linalg as spla

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "ed_kernels.cpp"
BUILD_DIR = _PKG / "_build"
#: the JAX module's flags, then its retry without OpenMP
FLAGS = (("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"),
         ("-O3", "-shared", "-fPIC"))

_lib = None
_load_error: Optional[str] = None


def _library_path(flags: Sequence[str]) -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(
        (*flags, platform.machine(), platform.node())).encode()).hexdigest()
    return BUILD_DIR / f"ed_kernels-{digest[:12]}.so"


def _compile() -> Path:
    """Build (or find built) the library; raises when every build fails."""
    errors = []
    for flags in FLAGS:
        out = _library_path(flags)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            errors.append(f"g++ {' '.join(flags)}: {e.stderr.strip()}")
            continue
        except FileNotFoundError as e:
            errors.append(str(e))
            break
        os.replace(tmp, out)  # atomic: concurrent builders see no partial
        return out
    raise RuntimeError("; ".join(errors))


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_compile()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.tfim_matvec.argtypes = [
            ctypes.c_int, i32p, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, f64p, f64p]
        lib.tfim_matvec.restype = None
        lib.heisenberg_matvec.argtypes = [
            ctypes.c_int, i32p, f64p, ctypes.c_int, f64p, f64p]
        lib.heisenberg_matvec.restype = None
        lib.ed_num_threads.argtypes = []
        lib.ed_num_threads.restype = ctypes.c_int
        lib.fill_sector_states.argtypes = [
            ctypes.c_int, ctypes.c_int, u64p, ctypes.c_int64]
        lib.fill_sector_states.restype = None
        lib.heisenberg_sector_matvec.argtypes = [
            i32p, f64p, ctypes.c_int, u64p, ctypes.c_int64, f64p, f64p]
        lib.heisenberg_sector_matvec.restype = None
        _lib = lib
    except (OSError, RuntimeError) as e:  # no compiler / load failure
        _load_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ED unavailable: {_load_error}")
    return lib


def _bond_array(bonds, n: int) -> np.ndarray:
    bonds = np.ascontiguousarray(bonds, np.int32)
    if bonds.ndim != 2 or bonds.shape[1] != 2:
        raise ValueError(f"bonds must be [n_bonds, 2], got {bonds.shape}")
    if bonds.size and (bonds.min() < 0 or bonds.max() >= n):
        raise ValueError(f"bond sites outside [0, {n})")
    return bonds


def _coupling_array(bonds, couplings, j) -> np.ndarray:
    if couplings is None:
        couplings = np.full(len(bonds), j, np.float64)
    couplings = np.ascontiguousarray(couplings, np.float64)
    if couplings.shape != (len(bonds),):
        raise ValueError(f"{couplings.shape[0]} couplings for "
                         f"{len(bonds)} bonds")
    return couplings


def tfim_operator(n: int, bonds: np.ndarray, j: float = 1.0,
                  h: float = 1.0) -> spla.LinearOperator:
    lib = _require()
    bonds = _bond_array(bonds, n)
    dim = 1 << n

    def mv(v):
        v = np.ascontiguousarray(v.reshape(dim), np.float64)
        out = np.empty(dim, np.float64)
        lib.tfim_matvec(n, bonds, len(bonds), j, h, v, out)
        return out

    return spla.LinearOperator((dim, dim), matvec=mv, dtype=np.float64)


def heisenberg_operator(n: int, bonds: np.ndarray,
                        couplings: Optional[np.ndarray] = None,
                        j: float = 1.0) -> spla.LinearOperator:
    lib = _require()
    bonds = _bond_array(bonds, n)
    couplings = _coupling_array(bonds, couplings, j)
    dim = 1 << n

    def mv(v):
        v = np.ascontiguousarray(v.reshape(dim), np.float64)
        out = np.empty(dim, np.float64)
        lib.heisenberg_matvec(n, bonds, couplings, len(bonds), v, out)
        return out

    return spla.LinearOperator((dim, dim), matvec=mv, dtype=np.float64)


def heisenberg_sector_operator(n: int, bonds: np.ndarray,
                               couplings: Optional[np.ndarray] = None,
                               j: float = 1.0,
                               n_up: Optional[int] = None
                               ) -> spla.LinearOperator:
    """Heisenberg/J1-J2 restricted to the S^z sector with ``n_up`` up
    spins (default N/2, where the antiferromagnetic ground state lives).

    The sector dimension C(N, N/2) is ~2^N / sqrt(N) states smaller than
    the full Hilbert space: memory and per-matvec work shrink by that
    factor. Column indices are recovered by combinadic ranking in the C++
    kernel; the enumerated basis ([dim] uint64) is the only auxiliary
    storage."""
    from math import comb

    lib = _require()
    if n_up is None:
        if n % 2:
            raise ValueError("default n_up = N/2 needs an even N")
        n_up = n // 2
    bonds = _bond_array(bonds, n)
    couplings = _coupling_array(bonds, couplings, j)
    dim = comb(n, n_up)
    states = np.empty(dim, np.uint64)
    lib.fill_sector_states(n, n_up, states, dim)

    def mv(v):
        v = np.ascontiguousarray(v.reshape(dim), np.float64)
        out = np.empty(dim, np.float64)
        lib.heisenberg_sector_matvec(bonds, couplings, len(bonds), states,
                                     dim, v, out)
        return out

    return spla.LinearOperator((dim, dim), matvec=mv, dtype=np.float64)


def ground_energy(op: spla.LinearOperator) -> float:
    return float(spla.eigsh(op, k=1, which="SA",
                            return_eigenvectors=False)[0])
