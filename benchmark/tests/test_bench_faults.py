"""The harness with the timed path broken underneath: each run skips the
look for a chip and drives the rest of a run on the CPU at a tiny size,
with a fault planted in the program, and ``correct`` must come out false;
the same run with nothing planted comes out true. The limits are the
cell's own (``limits/<cell>.json``)."""
import copy

import pytest
import torch

from benchmark import run as bench
from benchmark import spec

TINY = {"lattice": {"shape": [4, 4]}, "model": {"channels": [4, 4]},
        "sampler": {"n_walkers": 32, "n_therm_sweeps": 4},
        "run": {"steps_per_dispatch": 2}}


def tiny_cell(name):
    """The cell at a tiny size, its weights by the config's init rule
    (the cell's table names the full-size leaves)."""
    cell = copy.deepcopy(spec.cell(name))
    for sec, kv in TINY.items():
        cell["config"][sec].update(kv)
    cell["weight_std"] = None
    return cell


class Args:
    seed = 2 ** 31 + 11
    seconds = 0.3
    trace = 0


def correct(name) -> bool:
    cell = tiny_cell(name)
    run = bench.run_cell(Args(), cell, device="cpu")
    return bench.result_line(cell, run, False, {"platform": "cpu"})["correct"]


@pytest.mark.parametrize("name", ["heis10x10_sr.train",
                                  "heis10x10_sr.measure"])
def test_sound_run_is_correct(name):
    assert correct(name)


def _unchanged_step(monkeypatch):
    from qmcnn_tpu_torch import vmc

    orig = vmc.VMC.step

    def step(self, state, key, walker_ids, noise=None):
        _, metrics = orig(self, state, key, walker_ids, noise)
        return state._replace(step=state.step + 1), metrics

    monkeypatch.setattr(vmc.VMC, "step", step)


def _half_batch_train(monkeypatch):
    from qmcnn_tpu_torch import vmc

    orig = vmc.energy_and_grad

    def half(log_psi_fn, ham, params, walkers, **kw):
        m = walkers.s.shape[0] // 2
        part = type(walkers)(s=walkers.s[:m],
                             log_psi=type(walkers.log_psi)(
                                 walkers.log_psi.re[:m],
                                 walkers.log_psi.im[:m]),
                             n_accept=walkers.n_accept[:m],
                             n_prop=walkers.n_prop[:m])
        return orig(log_psi_fn, ham, params, part, **kw)

    monkeypatch.setattr(vmc, "energy_and_grad", half)


def _altered_energy_train(monkeypatch):
    from qmcnn_tpu_torch import vmc

    orig = vmc.local_energy

    def altered(*args, **kw):
        e = orig(*args, **kw)
        return type(e)(e.re + (torch.arange(e.re.shape[0]) == 0) * 0.5, e.im)

    monkeypatch.setattr(vmc, "local_energy", altered)


def _frozen_sampler(monkeypatch):
    from qmcnn_tpu_torch.sampler import metropolis

    monkeypatch.setattr(metropolis.MetropolisSampler, "sample",
                        lambda self, params, state, *a, **kw: state)


def _half_batch_measure(monkeypatch):
    from qmcnn_tpu_torch import measure

    orig = measure.local_energy

    def half(log_psi_fn, params, ham, s, lp, chunk_size=None):
        m = s.shape[0] // 2
        e = orig(log_psi_fn, params, ham, s[:m], lp[:m])
        return type(e)(torch.cat([e.re, e.re]), torch.cat([e.im, e.im]))

    monkeypatch.setattr(measure, "local_energy", half)


def _altered_answer_measure(monkeypatch):
    from qmcnn_tpu_torch import measure

    orig = measure.sample_estimators

    def altered(*args, **kw):
        out = orig(*args, **kw)
        out["energy"] = out["energy"] * 1.001
        return out

    monkeypatch.setattr(measure, "sample_estimators", altered)


@pytest.mark.parametrize("name, plant", [
    ("heis10x10_sr.train", _unchanged_step),
    ("heis10x10_sr.train", _half_batch_train),
    ("heis10x10_sr.train", _altered_energy_train),
    ("heis10x10_sr.measure", _frozen_sampler),
    ("heis10x10_sr.measure", _half_batch_measure),
    ("heis10x10_sr.measure", _altered_answer_measure),
])
def test_planted_fault_is_not_correct(name, plant, monkeypatch):
    plant(monkeypatch)
    assert not correct(name)
