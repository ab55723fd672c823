"""Functional sanitizers (port of ``qmcnn_tpu/utils/debug.py``).

PyTorch has no ``checkify``. Its counterpart here is a
``TorchDispatchMode`` (:class:`CheckMode`) that sees every aten op of the
wrapped call and raises at the first fault, with the same three classes of
checks as ``checkify.index_checks | float_checks | user_checks``:

  * **index checks**: the indices of ``index``, ``index_put``,
    ``index_select``, ``gather``, ``take``, ``scatter`` (and their in-place
    and accumulating forms, ``index_add``, ``index_copy``, ``index_fill``,
    ``embedding``) are bounds-checked on the host *before* the op runs. On
    CUDA an out-of-bounds gather is a device-side assert that leaves the
    context unusable, so it must never be launched.
  * **float checks**: what JAX's checkify checks (``float_checks`` is
    ``{DivisionByZeroError, NaNError}``): a NaN in a floating op's output
    raises, naming the aten op; a division by zero raises, of floats too
    (``div``, ``floor_divide`` and ``reciprocal``, as checkify's check on
    the ``div`` primitive), and an integer remainder by zero; +-inf from
    any other op passes (``log(0)`` and ``exp(1000)`` are not faults,
    ``inf - inf`` is). Ops that generate no values are not checked: the
    uninitialized allocations (``empty``...), views, the in-place writes of
    a part of a tensor (``index_put_``, ``scatter_``...: the values they
    write were checked where they were made) and the collectives.
  * **user checks**: :func:`check` raises under the mode, and is a no-op
    outside it.

The mode only reads outputs, so a checked call computes bitwise what the
unchecked call does. The hand kernels are not aten ops: they launch
through ``ctypes``, and the mode does not see them. So under the mode
(:func:`active`) the kernel wrappers check their own outputs
(``kernels/metropolis_sweep.py``, ``kernels/gcnn_forward.py``: each
output NaN-checked right after its launch, the message naming the
kernel). The flag costs one integer test per launch when it is off.

Not on the hot path by design: every checked op costs a device-to-host
read (a synchronization on CUDA). The train CLI exposes it as
``run.checkify=true``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: how many CheckModes are entered (0: the kernel wrappers skip their check)
_ACTIVE = 0


class CheckError(RuntimeError):
    """A fault found by :class:`CheckMode` or :func:`check`."""


def active() -> bool:
    """True inside a :class:`CheckMode`."""
    return _ACTIVE > 0


def check(cond, msg: str) -> None:
    """A user check: raise ``CheckError(msg)`` where ``cond`` is false, under
    the mode; a no-op outside it (as ``checkify.check`` without
    ``user_checks``)."""
    if _ACTIVE and not bool(cond):
        raise CheckError(f"check failed: {msg}")


def check_kernel_output(kernel: str, *outputs: torch.Tensor) -> None:
    """Under the mode, raise if a hand kernel's output holds a NaN (the
    kernel wrappers call this right after a launch)."""
    if not _ACTIVE:
        return
    for out in outputs:
        if out is not None and bool(torch.isnan(out).any()):
            raise CheckError(f"nan generated by the {kernel} kernel")


#: ops whose index argument is bounded by self.size(dim), in [0, size)
_DIM_INDEX_OPS = frozenset((
    "index_select", "gather", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add",
    "index_add_", "index_copy", "index_copy_", "index_fill", "index_fill_"))
#: ops indexed by a list of optional tensors, negatives wrapping
_LIST_INDEX_OPS = frozenset(("index", "index_put", "index_put_",
                             "_index_put_impl_", "_unsafe_index",
                             "_unsafe_index_put"))
#: uninitialized allocations: their values are not generated
_UNINITIALIZED = frozenset(("empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_",
                            "set_"))
#: in-place writes of a part of ``self``: the rest of ``self`` may be an
#: allocation not yet written, and the written values were checked where
#: they were made
_PARTIAL_WRITES = frozenset((
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_copy_", "index_fill_", "index_add_",
    "masked_fill_", "masked_scatter_", "_unsafe_index_put"))
#: divisions checked for a zero divisor in any dtype (JAX's
#: DivisionByZeroError on the div primitive), and in integers only
_DIV_OPS = frozenset(("div", "div_", "floor_divide", "floor_divide_",
                      "reciprocal", "reciprocal_"))
_INT_REM_OPS = frozenset(("remainder", "remainder_", "fmod", "fmod_"))


def _bounds(op: str, idx: torch.Tensor, size: int, wrap: bool) -> None:
    if idx.numel() == 0:
        return
    lo, hi = int(idx.min()), int(idx.max())
    low = -size if wrap else 0
    if lo < low or hi >= size:
        raise CheckError(
            f"out-of-bounds index in aten.{op}: indices span [{lo}, {hi}] "
            f"for a dimension of size {size}")


def _check_indices(op: str, args, kwargs) -> None:
    if op in _LIST_INDEX_OPS:
        self, indices = args[0], args[1]
        dim = 0
        for idx in indices:
            if idx is None:
                dim += 1
                continue
            if idx.dtype in (torch.bool, torch.uint8):
                want = tuple(self.shape[dim:dim + idx.dim()])
                if tuple(idx.shape) != want:
                    raise CheckError(
                        f"out-of-bounds index in aten.{op}: a mask of shape "
                        f"{tuple(idx.shape)} for dimensions of shape {want}")
                dim += idx.dim()
                continue
            _bounds(op, idx, self.shape[dim] if self.dim() else 1, True)
            dim += 1
    elif op == "take":
        _bounds(op, args[1], args[0].numel(), True)
    elif op == "embedding":
        _bounds(op, args[1], args[0].shape[0], False)
    else:  # (self, dim, index, ...)
        self = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        index = kwargs.get("index", args[2] if len(args) > 2 else None)
        size = self.shape[dim] if self.dim() else 1
        _bounds(op, index, size, False)


def _is_integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int)


def _check_divisor(op: str, args) -> None:
    if op.startswith("reciprocal"):
        d = args[0]
    elif op in _INT_REM_OPS and not (_is_integral(args[0])
                                     and _is_integral(args[1])):
        return
    else:
        d = args[1]
    zero = bool((d == 0).any()) if isinstance(d, torch.Tensor) else d == 0
    if zero:
        raise CheckError(f"division by zero in aten.{op}")


def _generates_values(func) -> bool:
    """False for an op whose outputs are views of its inputs."""
    for ret in func._schema.returns:
        info = ret.alias_info
        if info is not None and not info.is_write:
            return False
    return True


def _check_nan(op: str, out) -> None:
    if isinstance(out, torch.Tensor):
        if ((out.is_floating_point() or out.is_complex())
                and bool(torch.isnan(out).any())):
            raise CheckError(f"nan generated by aten.{op}")
    elif isinstance(out, (tuple, list)):
        for o in out:
            _check_nan(op, o)


class CheckMode(TorchDispatchMode):
    """Index, float and user checks on every aten op run inside it (see the
    module docstring). The checks run with the mode popped, so they are not
    themselves checked."""

    def __enter__(self):
        global _ACTIVE
        _ACTIVE += 1
        try:
            return super().__enter__()
        except BaseException:
            _ACTIVE -= 1
            raise

    def __exit__(self, *exc):
        global _ACTIVE
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace not in ("aten", "prims"):
            return func(*args, **kwargs)  # collectives and custom ops
        op = func.overloadpacket.__name__
        if (op in _DIM_INDEX_OPS or op in _LIST_INDEX_OPS
                or op in ("take", "embedding")):
            _check_indices(op, args, kwargs)
        if op in _DIV_OPS or op in _INT_REM_OPS:
            _check_divisor(op, args)
        out = func(*args, **kwargs)
        if (op not in _UNINITIALIZED and op not in _PARTIAL_WRITES
                and _generates_values(func)):
            _check_nan(op, out)
        return out


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it runs under :class:`CheckMode` and raises
    ``CheckError`` at the first out-of-bounds index, NaN, division by zero
    or failed :func:`check` (where ``checkify`` raises after the
    dispatch, this raises at the op, before an out-of-bounds index is
    used)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with CheckMode():
            return fn(*args, **kwargs)

    return wrapper
