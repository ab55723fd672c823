"""What the drivers share: the program's objects built from the benchmark's
configuration and weights, set-up's phases, and the run record's device
fields."""
from __future__ import annotations

import dataclasses
import json
import time
import torch

from benchmark.reference import models
from benchmark.spans import Recorder, SamplerProxy, SRProxy


def program_config(cfg: dict):
    """The program's Config of the benchmark's configuration (its YAML
    sections as run)."""
    from qmcnn_tpu_torch import configs as cfglib

    return cfglib.from_yaml(json.dumps(cfg))


def build(cfg: dict, seed: int, device, std=None):
    """(vmc, lattice, params, device): the program's VMC for ``cfg`` and
    the weights of ``seed`` (at the per-leaf ``std``, see
    ``reference.models.make_params``), made on the device by the benchmark
    (the program's own init is discarded; its keys and shapes must be the
    benchmark's)."""
    from qmcnn_tpu_torch.builder import build as build_vmc

    vmc, own, lattice = build_vmc(program_config(cfg), device=device)
    dev = torch.device(device)
    params = models.make_params(cfg, seed, dev, std)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    theirs = {k: tuple(v.shape) for k, v in own.items()}
    if shapes != theirs:
        raise RuntimeError(f"the program's parameters {theirs} are not the "
                           f"benchmark's {shapes}")
    return vmc, lattice, params, dev


def with_proxies(vmc, rec: Recorder):
    """The same VMC with its sampler and SR solver behind the proxies."""
    sr = None if vmc.sr is None else SRProxy(vmc.sr, rec)
    return dataclasses.replace(vmc, sampler=SamplerProxy(vmc.sampler, rec),
                               sr=sr)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev) -> int:
    if torch.device(dev).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))


class Phases:
    """Seconds of set-up by phase, the device synchronized at each mark;
    the first phase runs from the process's start (imports, CUDA)."""

    def __init__(self, t_start: float, device):
        self.device = device
        self.last = t_start
        self.seconds = {}

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


class Clock:
    """The window's clock: seconds since ``start()``, which waits for the
    device."""

    def __init__(self, dev):
        self.dev = dev
        self.t0 = 0.0

    def start(self) -> None:
        sync(self.dev)
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
