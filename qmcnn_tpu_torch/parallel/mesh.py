"""Walker data-parallelism over ``torch.distributed`` (port of
``qmcnn_tpu/parallel/mesh.py``).

MCMC walkers are i.i.d., so they shard over ranks while the parameters and
the optimizer state stay replicated. The JAX package drives all of a host's
devices from one process over a device mesh; PyTorch's idiom is one process
per card, which the port follows: a rank is a process and its card, started
by ``torch.distributed.run`` (torchrun),

  python -m torch.distributed.run --nproc_per_node=N -m qmcnn_tpu_torch.train \\
      --config configs/heis10x10_sr.yaml --override run.distributed=true

over NCCL on CUDA and gloo on the CPU (``--device cpu``).

Design properties, as in the JAX package:
  * the per-rank step is the same ``VMC.step`` that runs on one device: a
    :class:`WalkerGroup` in ``VMC.group`` switches its mean all-reduces on
    (``vmc.pmean``; ``sr.py`` at every JAX ``_pmean`` site);
  * rank r holds the walkers r * M_loc .. (r + 1) * M_loc - 1 (under
    parallel tempering each with its whole ladder of R rows), and the
    noise is keyed by *global* walker id, so an n-rank run equals the
    1-rank run walker for walker;
  * only P-sized vectors, scalars and (for minSR) score rows cross ranks;
    walkers never migrate;
  * a host decision that picks the next collective (the pcg and cg loop
    tests, the Cholesky fallback) is taken from values all ranks agree on
    (:meth:`WalkerGroup.agree`), so no rank waits in a collective the
    others skipped.

The collectives are all-reduce, broadcast and the list form of all-gather,
which NCCL and gloo both run, gloo on CUDA tensors too.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import WalkerState
from qmcnn_tpu_torch.vmc import TrainState, VMC


@dataclasses.dataclass(frozen=True, eq=False)
class WalkerGroup:
    """This rank's place in the walker group: its rank, the world size, the
    process group (None: the default group) and its device."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    def rows(self, n_walkers: int) -> slice:
        """This rank's rows of the ``n_walkers`` global walkers."""
        if n_walkers % self.world_size:
            raise ValueError(f"n_walkers={n_walkers} not divisible by the "
                             f"{self.world_size} ranks")
        m_local = n_walkers // self.world_size
        return slice(self.rank * m_local, (self.rank + 1) * m_local)

    def local_ids(self, m_local: int) -> torch.Tensor:
        """Global ids of this rank's ``m_local`` walkers."""
        return self.rank * m_local + torch.arange(m_local, device=self.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (a new tensor; ``x`` is left as it is)."""
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks (``jax.lax.pmean``: the sum over n)."""
        return self.sum(x) / self.world_size

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks: the values every rank takes a
        host decision from."""
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (``x`` is written in place on
        the others and must be contiguous)."""
        dist.broadcast(x, src=src, group=self.group)
        return x

    def barrier(self) -> None:
        """Return once every rank has reached this point."""
        float(self.sum(torch.zeros((), device=self.device)))


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` alone means ``cuda:<local rank>``, one
    process per card; raises when that card is missing (never wraps)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = local_rank if dev.index is None else dev.index
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(
            f"this rank needs cuda:{index}, but {count} CUDA devices are "
            "visible: the port runs one process per card, so start at most "
            f"{count} ranks per host (or pass --device cpu)")
    return torch.device("cuda", index)


def walker_group(n_devices: Optional[int] = None, device="cuda",
                 group=None) -> WalkerGroup:
    """This rank's :class:`WalkerGroup` over an initialized process group
    (the counterpart of ``walker_mesh``). ``run.n_devices``, where it is set,
    must equal the world size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "run.distributed needs torch.distributed: launch one process per "
            "card with torchrun (python -m torch.distributed.run "
            "--nproc_per_node=N -m qmcnn_tpu_torch.train ...), or call "
            "parallel.mesh.init_distributed first")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"run.n_devices={n_devices}, but the process group "
                         f"has {world} ranks (one per card)")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return WalkerGroup(rank=rank, world_size=world,
                       device=rank_device(device, local_rank), group=group)


def init_distributed(run_cfg, backend: Optional[str] = None,
                     device="cuda") -> WalkerGroup:
    """Join the process group before any device use (the JAX package's
    ``jax.distributed.initialize``) and return this rank's walker group.

    With ``run.coordinator_address`` the group meets at
    ``tcp://<address>`` with ``run.num_processes`` ranks, this one being
    ``run.process_id``; otherwise it reads the environment torchrun sets.
    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU. A
    failing initialization raises."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {"init_method": "env://"}
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    if run_cfg.coordinator_address is not None:
        if run_cfg.num_processes is None or run_cfg.process_id is None:
            raise ValueError("run.coordinator_address needs "
                             "run.num_processes and run.process_id")
        kwargs = dict(init_method=f"tcp://{run_cfg.coordinator_address}",
                      world_size=run_cfg.num_processes,
                      rank=run_cfg.process_id)
        local_rank = int(os.environ.get("LOCAL_RANK", run_cfg.process_id))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL binds the rank to its card
    dist.init_process_group(backend, **kwargs)
    return walker_group(run_cfg.n_devices, dev)


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def shard_train_state(state: TrainState, group: WalkerGroup,
                      n_replicas: int = 1) -> TrainState:
    """This rank's part of a full train state (every rank builds the same
    one, e.g. from the seed or a checkpoint): its rows of the walkers, and
    the replicated rest (params, optimizer state, SPRING's carry, the EMA),
    on the group's device. The walker count must divide over the ranks;
    under tempering (``n_replicas`` = R rows per walker) a rank takes
    contiguous blocks of whole ladders, (M / n) * R rows."""
    phys = group.rows(state.walkers.s.shape[0] // n_replicas)
    rows = slice(phys.start * n_replicas, phys.stop * n_replicas)
    w, dev = state.walkers, group.device
    walkers = WalkerState(
        s=w.s[rows].to(dev),
        log_psi=C(w.log_psi.re[rows].to(dev), w.log_psi.im[rows].to(dev)),
        n_accept=w.n_accept[rows].to(dev), n_prop=w.n_prop[rows].to(dev))
    return TrainState(params=_on(state.params, dev),
                      opt_state=_on(state.opt_state, dev), walkers=walkers,
                      step=state.step, sr_aux=_on(state.sr_aux, dev),
                      ema=_on(state.ema, dev))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedVMC:
    """The VMC train step over the walker group. Build with
    :func:`make_sharded_vmc`; each method runs this rank's walkers with
    their global ids, the collectives inside."""

    vmc: VMC
    group: WalkerGroup

    def local_ids(self, state: TrainState) -> torch.Tensor:
        """Global ids of this rank's physical walkers (under tempering the
        state holds R rows per walker)."""
        phys = self.vmc.sampler.physical(state.walkers)
        return self.group.local_ids(phys.s.shape[0])

    def init_state(self, key: int, n_walkers: int, params) -> TrainState:
        """Every rank draws the same ``n_walkers`` configurations from
        ``key`` on the host and keeps (and evaluates) its own rows."""
        return self.vmc.init_state(key, n_walkers, params,
                                   device=self.group.device,
                                   rows=self.group.rows(n_walkers))

    def step(self, state: TrainState, key: int):
        return self.vmc.step(state, key, self.local_ids(state))

    def thermalize(self, state: TrainState, key: int,
                   n_sweeps: int) -> TrainState:
        return self.vmc.thermalize(state, key, self.local_ids(state),
                                   n_sweeps)

    def run_steps(self, state: TrainState, base_key: int, n_steps: int):
        """n_steps training steps (``VMC.run_steps``): (state, metrics per
        step)."""
        return self.vmc.run_steps(state, base_key, self.local_ids(state),
                                  n_steps)


def make_sharded_vmc(vmc: VMC, group: WalkerGroup) -> ShardedVMC:
    """Wrap a VMC built with ``group`` (``builder.build(cfg, group=...)``)."""
    if vmc.group is not group:
        raise ValueError("the VMC must be built with this walker group to "
                         f"run sharded (builder.build(cfg, group=...)); got "
                         f"group={vmc.group!r}")
    return ShardedVMC(vmc=vmc, group=group)
