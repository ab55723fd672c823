"""Parameters across the two packages, and warm starts (port of
``qmcnn_tpu/utils/transfer.py``).

Both packages name parameters by the flat key paths of
``qmcnn_tpu.utils.transfer._flatten`` (``params/RealConv_0/kernel``) with
Flax layouts (``[*k, Cin, Cout]``), which is also the format of the
``<csv>.params.npz`` snapshots that either train loop writes. The port keeps
its parameters as such a flat dict of tensors, so:

  * :func:`params_from_jax` turns a flat ``{key: ndarray}`` dict (a JAX
    ``_flatten`` of the params tree, or a loaded npz) into port params;
  * :func:`params_to_jax` is its inverse (float32 numpy, same keys);
  * :func:`load_checkpoint_params`, :func:`transfer_params` and
    :func:`warm_start` serve ``run.init_from``: a ``<x>.params.npz``
    snapshot or one of the port's own checkpoint directories
    (``utils/checkpoint.py``).

The JAX package's Orbax checkpoint directories are not readable here (the
port does not depend on orbax); export their params to an npz snapshot.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def params_from_jax(flat: Dict[str, np.ndarray], device="cpu") -> Params:
    """Port params from a flat Flax-keyed dict of arrays (copied)."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in sorted(flat.items())}


def params_to_jax(params: Params) -> Dict[str, np.ndarray]:
    """Flat Flax-keyed numpy arrays (the npz snapshot format)."""
    return {k: v.detach().cpu().numpy() for k, v in sorted(params.items())}


def load_checkpoint_params(path: str, step: Optional[int] = None,
                           field: str = "params") -> Dict[str, np.ndarray]:
    """Read the params of a flat ``.npz`` snapshot, or of a port checkpoint
    directory (at ``step``, None: the latest), as host arrays.

    ``field="ema"`` reads the parameter EMA instead: a checkpoint's
    ``TrainState.ema``, or beside a ``<csv>.params.npz`` snapshot the
    ``<csv>.ema.npz`` that the train loops write (where the JAX package's
    loader returns the raw params of an npz whatever the field). Raises
    ``ValueError`` when there is no EMA to read."""
    if field not in ("params", "ema"):
        raise ValueError(f"unknown params field {field!r}")
    if not path.endswith(".npz"):
        from qmcnn_tpu_torch.utils.checkpoint import (load_state_dict,
                                                      saved_steps)

        if not saved_steps(path):
            raise NotImplementedError(
                f"{path}: neither a .params.npz snapshot nor a checkpoint "
                "directory of the PyTorch port (an Orbax directory of the "
                "JAX package is not readable here: export its params to a "
                ".params.npz snapshot)")
        params = load_state_dict(path, step)[field]
        if params is None:
            raise ValueError(
                f"{path}: the checkpoint has no EMA state (train with "
                "optimizer.ema_decay > 0)")
        return {k: v.numpy() for k, v in sorted(params.items())}
    if field == "ema":
        stem = path[:-len(".params.npz")]
        if not path.endswith(".params.npz") or not os.path.isfile(
                stem + ".ema.npz"):
            raise ValueError(
                f"{path}: no parameter EMA beside this snapshot (a "
                "<csv>.params.npz whose run wrote <csv>.ema.npz, with "
                "optimizer.ema_decay > 0)")
        path = stem + ".ema.npz"
    with np.load(path) as z:
        flat = {k: np.asarray(z[k]) for k in z.files}
    if not flat:
        raise ValueError(f"empty params snapshot {path}")
    return flat


def _strip_inner(key: str) -> str:
    """Drop path segments named 'inner' (the wrapper-module nesting), so
    bare <-> wrapped checkpoints transfer."""
    return "/".join(p for p in key.split("/") if p != "inner")


def transfer_params(fresh: Params, source: Dict[str, np.ndarray],
                    expand: bool = False) -> Tuple[Params, int, int]:
    """Copy leaves of ``source`` into ``fresh`` where key and shape match;
    exact keys first, then an 'inner'-transparent retry (skipped for keys
    that would become ambiguous). ``expand=True`` also embeds a source leaf
    whose shape is contained in the fresh one at the leading corner, fresh
    entries at 0.1x their init. Returns (merged, n_copied, n_kept_fresh)."""
    norm_counts: dict = {}
    for k in source:
        nk = _strip_inner(k)
        norm_counts[nk] = norm_counts.get(nk, 0) + 1
    src_norm = {_strip_inner(k): v for k, v in source.items()
                if norm_counts[_strip_inner(k)] == 1}
    merged, copied, kept = {}, 0, 0
    for key, leaf in fresh.items():
        shape = tuple(leaf.shape)
        cand = source.get(key)
        if cand is None or np.shape(cand) != shape:
            alt = src_norm.get(_strip_inner(key))
            if alt is not None and (np.shape(alt) == shape or cand is None):
                cand = alt
        if cand is not None and np.shape(cand) == shape:
            merged[key] = torch.as_tensor(np.asarray(cand)).to(
                device=leaf.device, dtype=leaf.dtype)
            copied += 1
        elif (expand and cand is not None and np.ndim(cand) == leaf.dim()
              and all(c <= s for c, s in zip(np.shape(cand), shape))):
            out = leaf.clone() * 0.1
            out[tuple(slice(0, d) for d in np.shape(cand))] = torch.as_tensor(
                np.asarray(cand)).to(device=leaf.device, dtype=leaf.dtype)
            merged[key] = out
            copied += 1
        else:
            merged[key] = leaf
            kept += 1
    return merged, copied, kept


def warm_start(fresh_params: Params, path: str, step: Optional[int] = None,
               expand: bool = False, field: str = "params") -> Params:
    """Load + transfer, with a one-line report; ``field`` as in
    :func:`load_checkpoint_params`."""
    source = load_checkpoint_params(path, step, field=field)
    merged, n_copied, n_fresh = transfer_params(fresh_params, source,
                                                expand=expand)
    print(f"warm-start from {path}"
          + (f" ({field})" if field != "params" else "")
          + f": {n_copied} param leaves transferred, {n_fresh} kept at "
          "fresh init")
    if n_copied == 0:
        raise ValueError(
            f"warm-start from {path} matched no parameters — wrong "
            "model family/width? (transfer matches on key-path + shape)")
    return merged
