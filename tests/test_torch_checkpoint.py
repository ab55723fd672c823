"""PyTorch port, slice 5: checkpoint/resume (``utils/checkpoint.py``), the
train loop's saves, resume and NaN rollback, warm starts from the port's
checkpoint directories, and the bf16 hero config on the CPU.

The JAX package's own resume test (tests/test_config_and_builder.py) checks
the step count. The port holds itself to more: the per-step key is
``fold_in(base_key, step)`` and a checkpoint holds everything the next step
reads, so on the CPU a resumed run equals the uninterrupted one bitwise."""
import os
import shutil

import numpy as np
import pytest
import torch

from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import train as ttrain
from qmcnn_tpu_torch import vmc as tvmc
from qmcnn_tpu_torch.builder import build
from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.utils import transfer
from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager, saved_steps
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R2 = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn_r2.yaml")
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
#: the bf16 hero config at a CPU size: 4x4, C = 2 x 3, 32 walkers
R2_SMALL = ("lattice.shape=[4,4]", "model.channels=[2,2,2]",
            "sampler.n_walkers=32", "sampler.n_therm_sweeps=4",
            "run.log_every=1", "run.steps_per_dispatch=1",
            "run.ckpt_dir=null", "run.csv_path=null",
            "optimizer.momentum=0.9")
HEIS_SMALL = ("lattice.shape=[4,4]", "model.channels=[4,4]",
              "sampler.n_walkers=32", "sampler.n_therm_sweeps=2",
              "run.log_every=1", "run.steps_per_dispatch=1",
              "run.csv_path=null")


def _r2(*over):
    return tcfg.load(R2, R2_SMALL + over)


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert sorted(a.params) == sorted(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.opt_state["count"] == b.opt_state["count"]
    for part in ("trace", "mu", "nu"):
        for k, v in a.opt_state.get(part, {}).items():
            assert torch.equal(v, b.opt_state[part][k]), (part, k)
    wa, wb = a.walkers, b.walkers
    for x, y in ((wa.s, wb.s), (wa.log_psi.re, wb.log_psi.re),
                 (wa.log_psi.im, wb.log_psi.im), (wa.n_accept, wb.n_accept),
                 (wa.n_prop, wb.n_prop)):
        assert torch.equal(x, y)


def test_resume_equals_uninterrupted_run_bitwise(tmp_path, capsys):
    """6 steps of the bf16 hero config (minSR, exchange_anti, SGD with
    momentum) with a checkpoint every 2 steps; a second run resumed from
    the step-4 checkpoint ends in the same state bit for bit, logs the same
    energies at steps 5 and 6, and appends to the CSV."""
    cfg = _r2("run.n_steps=6", "run.ckpt_every=2")
    full_dir = tmp_path / "full"
    state, logger = ttrain.train(cfg, device="cpu",
                                 ckpt_manager=CheckpointManager(
                                     str(full_dir), keep=3))
    assert saved_steps(str(full_dir)) == [2, 4, 6]
    part_dir = tmp_path / "part"
    shutil.copytree(full_dir, part_dir)
    shutil.rmtree(part_dir / "6")
    csv = str(tmp_path / "resumed.csv")
    with open(csv, "w") as f:
        f.write("step,energy_re\n")
    capsys.readouterr()
    resumed, logger2 = ttrain.train(
        tcfg.apply_overrides(cfg, (f"run.csv_path={csv}",)), device="cpu",
        ckpt_manager=CheckpointManager(str(part_dir), keep=3))
    assert "resumed from checkpoint at step 4" in capsys.readouterr().out
    _assert_states_equal(resumed, state)
    assert logger2.history["energy_re"] == logger.history["energy_re"][4:]
    with open(csv) as f:
        assert f.readline() == "step,energy_re\n"  # appended, not truncated


def test_direct_sampler_run_resumes_bitwise(tmp_path, capsys):
    """tfim16_arnn (the ARNN with the direct sampler, Adam) for 4 steps
    with a checkpoint every 2; a run resumed from the step-2 checkpoint
    ends in the same state bit for bit."""
    cfg = tcfg.load(os.path.join(ROOT, "configs", "tfim16_arnn.yaml"), (
        "sampler.n_walkers=32", "run.n_steps=4", "run.ckpt_every=2",
        "run.log_every=1", "run.steps_per_dispatch=1", "run.csv_path=null",
        "run.validate_against_ed=false"))
    full_dir = tmp_path / "full"
    state, logger = ttrain.train(cfg, device="cpu",
                                 ckpt_manager=CheckpointManager(
                                     str(full_dir), keep=3))
    assert logger.history["accept"] == [1.0] * 4
    part_dir = tmp_path / "part"
    shutil.copytree(full_dir, part_dir)
    shutil.rmtree(part_dir / "4")
    capsys.readouterr()
    resumed, logger2 = ttrain.train(cfg, device="cpu",
                                    ckpt_manager=CheckpointManager(
                                        str(part_dir), keep=3))
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    _assert_states_equal(resumed, state)
    assert logger2.history["energy_re"] == logger.history["energy_re"][2:]


def test_restore_equals_saved_state(tmp_path):
    """restore() gives back the saved params, optimizer state and walkers
    bitwise, on fresh tensors (so no cache keyed on tensor identity, the
    fused forwards' expanded and packed weights, can serve a stale
    expansion for them)."""
    cfg = _r2("run.n_steps=2")
    vmc, params, _ = build(cfg, device="cpu")
    state = vmc.init_state(prng_key(0), 32, params)
    state, _ = vmc.run_steps(state, prng_key(1), torch.arange(32), 2)
    mgr = CheckpointManager(str(tmp_path / "c"), keep=1)
    mgr.save(2, state)
    template = vmc.init_state(prng_key(5), 32, params)
    back = mgr.restore(template)
    _assert_states_equal(back, state)
    assert all(back.params[k] is not state.params[k] for k in state.params)
    fused = k2.FusedLogPsi(lattice_shape=(4, 4), channels=(2, 2, 2),
                           kernel_size=3, complex_params=True,
                           spin_flip_sector=1, compute_dtype="bfloat16")
    before = fused.weights(state.params)
    after = fused.weights(back.params)
    assert after is not before
    for a, b in zip(after, before):
        assert (a is None and b is None) or torch.equal(a, b)
    assert k2.packed_weights(after, "bfloat16") is not k2.packed_weights(
        before, "bfloat16")
    layers = [(torch.ones(3, 3, 1, 2), torch.zeros(2))]
    blob = k1.packed_weights(layers, 9)
    assert k1.packed_weights([(t.clone(), b.clone()) for t, b in layers],
                             9) is not blob


def test_ckpt_keep_prunes(tmp_path):
    cfg = _r2("run.n_steps=1")
    vmc, params, _ = build(cfg, device="cpu")
    state = vmc.init_state(prng_key(0), 32, params)
    mgr = CheckpointManager(str(tmp_path / "k"), keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3, 5, 8):
        mgr.save(step, state._replace(step=step))
    assert saved_steps(mgr.directory) == [5, 8]
    assert sorted(os.listdir(mgr.directory)) == ["5", "8"]  # no temp dirs
    assert mgr.latest_step() == 8
    assert mgr.restore(state, step=5).step == 5
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=3)
    mgr.save(8, state._replace(step=8))  # the same step again
    assert saved_steps(mgr.directory) == [5, 8]
    mgr.close()
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "z"), keep=0)


def _nan_at(monkeypatch, bad_steps, keys):
    """Make VMC.run_steps report a NaN energy for a step that starts at one
    of ``bad_steps`` (each once, or always if ``bad_steps`` is 'all'), and
    record the base key of every call."""
    real = tvmc.VMC.run_steps
    left = set() if bad_steps == "all" else set(bad_steps)

    def run_steps(self, state, base_key, walker_ids, n_steps):
        keys.append((state.step, base_key))
        new, metrics = real(self, state, base_key, walker_ids, n_steps)
        if bad_steps == "all" or state.step in left:
            left.discard(state.step)
            metrics = [metrics[0]._replace(
                energy_re=torch.tensor(float("nan")))] + metrics[1:]
        return new, metrics

    monkeypatch.setattr(tvmc.VMC, "run_steps", run_steps)


def test_rollback_on_injected_nan(tmp_path, monkeypatch, capsys):
    """A NaN energy at step 3 rolls back to the step-2 checkpoint and
    retries with the key re-folded with the retry count; the run ends at
    its step count with finite energies."""
    cfg = tcfg.load(HEIS, HEIS_SMALL + ("run.n_steps=4", "run.ckpt_every=1",
                                        "run.nan_max_retries=2"))
    keys = []
    _nan_at(monkeypatch, {2}, keys)
    state, logger = ttrain.train(cfg, device="cpu", ckpt_manager=(
        CheckpointManager(str(tmp_path / "r"), keep=2)))
    out = capsys.readouterr().out
    assert ("non-finite energy at step 3: rolled back to checkpoint step 2 "
            "with a re-folded key (retry 1/2)") in out
    base0 = fold_in(prng_key(cfg.run.seed + 100), 2)
    assert [k for _, k in keys] == [base0] * 3 + [fold_in(base0, 1)] * 2
    assert [s for s, _ in keys] == [0, 1, 2, 2, 3]
    assert state.step == 4
    assert np.isfinite(logger.history["energy_re"]).all()
    assert len(logger.history["energy_re"]) == 4


def test_rollback_gives_up_after_max_retries(tmp_path, monkeypatch):
    cfg = tcfg.load(HEIS, HEIS_SMALL + ("run.n_steps=3", "run.ckpt_every=1",
                                        "run.nan_max_retries=2"))
    keys = []
    _nan_at(monkeypatch, "all", keys)
    mgr = CheckpointManager(str(tmp_path / "g"), keep=2)
    mgr_state = build(cfg, device="cpu")
    vmc, params, _ = mgr_state
    mgr.save(1, vmc.init_state(prng_key(0), 32, params)._replace(step=1))
    with pytest.raises(RuntimeError, match="retries exhausted 2"):
        ttrain.train(cfg, device="cpu", ckpt_manager=mgr)
    base0 = fold_in(prng_key(cfg.run.seed + 100), 2)
    assert [k for _, k in keys] == [base0, fold_in(base0, 1),
                                    fold_in(base0, 2)]


@pytest.mark.parametrize("policy,with_ckpt", [("rollback", False),
                                              ("halt", True)])
def test_halt_without_checkpoint(tmp_path, monkeypatch, policy, with_ckpt):
    """rollback with no checkpoint, and halt, raise at the first NaN."""
    cfg = tcfg.load(HEIS, HEIS_SMALL + ("run.n_steps=2",
                                        f"run.nan_policy={policy}"))
    _nan_at(monkeypatch, {0}, [])
    mgr = CheckpointManager(str(tmp_path / "h")) if with_ckpt else None
    match = "no checkpoint to roll back to" if not with_ckpt else "halt"
    with pytest.raises(RuntimeError, match=match):
        ttrain.train(cfg, device="cpu", ckpt_manager=mgr)


def test_init_from_port_checkpoint_dir(tmp_path, capsys):
    """run.init_from=<port checkpoint dir> (the config's phase-2 recipe)
    warm-starts from the latest step, or from run.init_from_step; an Orbax
    directory, or any other directory, still raises."""
    d = str(tmp_path / "phase1")
    state, _ = ttrain.train(_r2("run.n_steps=2", "run.ckpt_every=1"),
                            device="cpu",
                            ckpt_manager=CheckpointManager(d, keep=2))
    flat = transfer.load_checkpoint_params(d)
    assert sorted(flat) == sorted(state.params)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, state.params[k].numpy())
    one = transfer.load_checkpoint_params(d, step=1)
    assert any(not np.array_equal(one[k], flat[k]) for k in flat)
    capsys.readouterr()
    cfg = _r2("run.n_steps=1", f"run.init_from={d}", "run.init_from_step=1",
              "sampler.n_walkers=64")
    ttrain.train(cfg, device="cpu")
    assert "12 param leaves transferred, 0 kept" in capsys.readouterr().out
    for path in (ROOT, str(tmp_path / "nothing")):
        with pytest.raises(NotImplementedError, match="Orbax"):
            transfer.load_checkpoint_params(path)


def test_gcnn_r2_config_runs_on_cpu(tmp_path):
    """configs/j1j2_8x8_gcnn_r2.yaml builds (bf16 model, fused forward off
    the card) and steps on the CPU through the CLI, with its checkpoint
    directory, where it raised before slice 5."""
    cfg = tcfg.load(R2)
    vmc, params, _ = build(tcfg.apply_overrides(cfg, R2_SMALL), device="cpu")
    state = vmc.init_state(prng_key(0), 32, params)
    state, metrics = vmc.run_steps(state, prng_key(1), torch.arange(32), 1)
    assert np.isfinite(float(metrics[0].energy_re))
    assert all(v.dtype == torch.float32 for v in state.params.values())
    d = str(tmp_path / "ck")
    ttrain.main(["--config", R2, "--device", "cpu",
                 *[x for ov in R2_SMALL + ("run.n_steps=2",
                                           f"run.ckpt_dir={d}")
                   for x in ("--override", ov)]])
    assert saved_steps(d) == [2]
