"""Checkpointing of the full train state (port of
``qmcnn_tpu/utils/checkpoint.py``, in the port's own format).

A checkpoint holds everything the next step reads: the params and the
optimizer state, the walkers' configurations, their stored log psi and the
sampler's counters, SPRING's carried delta (``sr_aux``), the parameter EMA
(``ema``), and the step counter (the per-step random key is
``fold_in(base_key, step)``, and SR's shift and the learning-rate schedule
are functions of the step and the optimizer count). So a run resumed from a
checkpoint continues exactly as the uninterrupted run would have.

Layout: ``<directory>/<step>/state.pt``, one subdirectory per saved step,
each a ``torch.save`` of a dict of CPU tensors and plain Python values that
loads with ``weights_only=True``. A save is written under a temporary name
and moved into place with ``os.replace``, so a reader never sees a partial
checkpoint; the last ``keep`` steps are kept.

Under walker sharding (``group``, a ``parallel.mesh.WalkerGroup``) a save
gathers every rank's walkers to one global state, which rank 0 writes in
the same format, then all ranks wait for it; a restore loads the global
state on every rank, which keeps its own rows. So a checkpoint written by
n ranks restores in any number of ranks that divides its walkers, one
included. The ranks share the directory (one host, or a shared file
system).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import WalkerState
from qmcnn_tpu_torch.vmc import TrainState

STATE_FILE = "state.pt"


def _to(tree, fn):
    """Map ``fn`` over the tensors of a nest of dicts."""
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def state_to_dict(state: TrainState, group=None) -> dict:
    """The train state as plain dicts of CPU tensors and Python values; with
    a walker ``group``, every rank's walkers in rank order (a collective)."""
    w = state.walkers
    walkers = {"s": w.s, "log_psi_re": w.log_psi.re,
               "log_psi_im": w.log_psi.im, "n_accept": w.n_accept,
               "n_prop": w.n_prop}
    if group is not None:
        walkers = {k: group.all_gather(v) for k, v in walkers.items()}
    return {
        "params": _to(state.params, lambda t: t.detach().cpu()),
        "opt_state": _to(state.opt_state, lambda t: t.detach().cpu()),
        "walkers": {k: v.cpu() for k, v in walkers.items()},
        "step": int(state.step),
        "sr_aux": (None if state.sr_aux is None
                   else state.sr_aux.detach().cpu()),
        "ema": (None if state.ema is None
                else _to(state.ema, lambda t: t.detach().cpu())),
    }


def state_from_dict(d: dict, template: TrainState) -> TrainState:
    """A saved dict as a TrainState on the devices of ``template``."""
    dev = template.walkers.s.device

    def like(t, ref):
        return t.to(device=ref.device, dtype=ref.dtype)

    params = {k: like(v, template.params[k]) for k, v in d["params"].items()}
    if sorted(params) != sorted(template.params):
        raise ValueError("the checkpoint's params do not match the model's: "
                         f"{sorted(set(params) ^ set(template.params))[:4]}")
    w = d["walkers"]
    walkers = WalkerState(
        s=w["s"].to(dev), log_psi=C(w["log_psi_re"].to(dev),
                                     w["log_psi_im"].to(dev)),
        n_accept=w["n_accept"].to(dev), n_prop=w["n_prop"].to(dev))
    sr_aux = d.get("sr_aux")
    if template.sr_aux is None:
        sr_aux = None
    elif sr_aux is None:  # saved without SPRING: its carry starts at 0
        sr_aux = torch.zeros_like(template.sr_aux)
    elif sr_aux.shape != template.sr_aux.shape:
        raise ValueError(f"the checkpoint's SPRING carry has shape "
                         f"{tuple(sr_aux.shape)}, the model "
                         f"{tuple(template.sr_aux.shape)}")
    else:
        sr_aux = like(sr_aux, template.sr_aux)
    ema = d.get("ema")
    if template.ema is None:
        ema = None
    elif ema is None:  # saved without EMA: the average starts at params
        ema = {k: v.clone() for k, v in params.items()}
    else:
        if sorted(ema) != sorted(template.ema):
            raise ValueError("the checkpoint's EMA does not match the "
                             "model's params")
        ema = {k: like(v, template.ema[k]) for k, v in ema.items()}
    return TrainState(params=params,
                      opt_state=_to(d["opt_state"], lambda t: t.to(dev)),
                      walkers=walkers, step=int(d["step"]), sr_aux=sr_aux,
                      ema=ema)


def saved_steps(directory: str) -> list:
    """The steps checkpointed in ``directory`` (a port checkpoint
    directory), ascending; [] when there is none."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(
                      os.path.join(directory, name, STATE_FILE)))


def load_state_dict(directory: str, step: Optional[int] = None) -> dict:
    """The saved dict of ``step`` (None: the latest)."""
    steps = saved_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        step = steps[-1]
    path = os.path.join(directory, str(step), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint of step {step} in "
                                f"{directory}")
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """save-every-N / keep-last-K manager over a TrainState."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: TrainState, group=None) -> None:
        """Write ``state`` as ``step``; with a walker ``group``, a collective
        that gathers the walkers, rank 0 writing, and returns on every rank
        once the checkpoint is in place."""
        d = state_to_dict(state, group)
        if group is None or group.rank == 0:
            self._write(step, d)
        if group is not None:
            group.barrier()

    def _write(self, step: int, d: dict) -> None:
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(d, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):  # the same step again (the final save)
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in saved_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = saved_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, template: TrainState, step: Optional[int] = None,
                group=None, n_replicas: int = 1) -> TrainState:
        """Restore ``step`` (None: the latest) onto the devices and dtypes
        of ``template``; with a walker ``group``, this rank's walkers
        (``n_replicas`` rows each under tempering)."""
        state = state_from_dict(load_state_dict(self.directory, step),
                                template)
        if group is None:
            return state
        from qmcnn_tpu_torch.parallel.mesh import shard_train_state

        return shard_train_state(state, group, n_replicas)

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
