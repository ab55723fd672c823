"""PyTorch port: the train loop and CLI (the CNN path of slice 1, the GCNN
path of slice 2), the files it writes, the warm-start transfer, and the
port's import isolation."""
import csv
import importlib
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import configs as jcfg
from qmcnn_tpu import train as jtrain
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils import transfer as jtransfer
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import train as ttrain
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.utils import transfer as ttransfer
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
TFIM = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
SMALL = ("lattice.shape=[4,4]", "model.channels=[4,4]",
         "sampler.n_walkers=64", "sampler.n_therm_sweeps=4",
         "run.n_steps=3", "run.log_every=1", "run.steps_per_dispatch=2",
         "run.validate_against_ed=true")
COLUMNS = ["step", "wall_time", "energy_re", "energy_im", "energy_var",
           "e_per_site", "accept", "grad_norm", "sr_iters", "sweeps_per_sec",
           "rel_err"]


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    csv_path = str(tmp_path_factory.mktemp("run") / "heis4x4.csv")
    cfg = tcfg.load(HEIS, SMALL + (f"run.csv_path={csv_path}",))
    state, logger = ttrain.train(cfg, device="cpu")
    return cfg, state, logger, csv_path


def test_train_writes_csv_manifest_and_snapshot(run):
    cfg, state, logger, csv_path = run
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == COLUMNS
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    for r in rows:
        assert np.isfinite(float(r["energy_re"]))
        assert 0.0 < float(r["accept"]) <= 1.0
        assert float(r["sr_iters"]) > 0
        assert 0.0 < float(r["rel_err"]) < 1.0
    meta = json.load(open(csv_path + ".meta.json"))
    assert meta["platform"] == "cpu" and meta["name"] == "heis10x10_sr"
    assert tcfg.from_yaml(meta["config"]) == cfg
    assert state.step == 3


def test_snapshot_loads_in_jax_with_equal_log_psi(run):
    _, state, _, csv_path = run
    flat = jtransfer.load_checkpoint_params(csv_path + ".params.npz")
    assert sorted(flat) == sorted(state.params)
    kw = dict(lattice_shape=(4, 4), channels=(4, 4), kernel_size=3)
    s = (2.0 * np.random.default_rng(0).integers(0, 2, (8, 16)) - 1.0
         ).astype(np.float32)
    want = j_apply(JCNN(**kw), _unflatten(flat), s)
    got = t_apply(TCNN(**kw), state.params, torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=2e-5, atol=1e-4)


def test_cli_cpu_and_warm_start(run, tmp_path, capsys):
    _, _, _, csv_path = run
    out = str(tmp_path / "again.csv")
    ttrain.main(["--config", HEIS, "--device", "cpu",
                 "--override", f"run.init_from={csv_path}.params.npz",
                 "--override", f"run.csv_path={out}",
                 *[x for ov in SMALL for x in ("--override", ov)]])
    text = capsys.readouterr().out
    assert "4 param leaves transferred" in text
    assert "relative error" in text
    assert os.path.exists(out + ".params.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ttrain.main(["--config", HEIS])


def test_transfer_matches_jax():
    kw = dict(lattice_shape=(4, 4), channels=(4, 6), kernel_size=3)
    fresh = JCNN(**kw).init(jax.random.key(0), jnp.ones((1, 16)))
    rng = np.random.default_rng(1)
    source = {
        "params/inner/RealConv_0/kernel":                 # wrapped, same shape
            rng.normal(size=(3, 3, 1, 4)).astype(np.float32),
        "params/RealConv_1/kernel":                       # narrower: expand
            rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
        "params/RealConv_9/bias": np.zeros(3, np.float32),  # no match
    }
    for expand in (False, True):
        j_merged, j_n, j_f = jtransfer.transfer_params(fresh, source,
                                                       expand=expand)
        t_fresh = ttransfer.params_from_jax(
            {k: np.asarray(v) for k, v in jtransfer._flatten(fresh).items()})
        t_merged, t_n, t_f = ttransfer.transfer_params(t_fresh, source,
                                                       expand=expand)
        assert (t_n, t_f) == (j_n, j_f)
        for k, v in jtransfer._flatten(j_merged).items():
            np.testing.assert_array_equal(t_merged[k].numpy(), np.asarray(v))
    with pytest.raises(NotImplementedError):
        ttransfer.load_checkpoint_params(ROOT)  # an Orbax directory


def test_helpers_match_jax():
    for total, per in ((100, 10), (25, 10), (7, 0), (0, 5), (5, 9)):
        assert ttrain.therm_chunks(total, per) == jtrain.therm_chunks(total,
                                                                      per)
    over = ("lattice.shape=[10]", "hamiltonian.hz=0.2")
    assert ttrain.exact_reference_energy(tcfg.load(TFIM, over)) == \
        pytest.approx(jtrain.exact_reference_energy(jcfg.load(TFIM, over)),
                      rel=1e-9)
    assert ttrain.exact_reference_energy(tcfg.load(HEIS)) is None


def test_once_refused_options_train_a_step(tmp_path):
    """Options once refused now train a step on the CPU (complex
    parameters, bf16 and checkpoints since slice 5; sr.solver=cg and
    run.distributed since slice 7; the Jastrow factor and SPRING since
    slice 8; the RBM and translation averaging since slice 9; the EMA, the
    (1 + alpha H) ansatz and parallel tempering since slice 10)."""
    for ov in (("optimizer.ema_decay=0.9",), ("model.lanczos_alpha=0.1",),
               ("sampler.tempering_betas=[1.0,0.5]",),
               ("model.jastrow=true",),
               ("sr.solver=minsr", "sr.momentum=0.9"),
               ("model.kind=rbm",), ("model.translation_average=true",)):
        cfg = tcfg.load(HEIS, SMALL + ov + ("run.n_steps=1",
                                            "run.csv_path=null"))
        state, logger = ttrain.train(cfg, device="cpu")
        assert state.step == 1
        assert np.isfinite(logger.history["energy_re"]).all()
        assert (state.sr_aux is not None) == (cfg.sr.momentum > 0)
        assert (state.ema is not None) == (cfg.optimizer.ema_decay > 0)
        rows = cfg.sampler.n_walkers * len(cfg.sampler.tempering_betas or
                                           (1,))
        assert state.walkers.s.shape[0] == rows
        if cfg.model.lanczos_alpha is not None:
            assert state.params["lanczos/alpha"].shape == (2,)
    with pytest.raises(ValueError, match="requires solver='minsr'"):
        ttrain.train(tcfg.load(HEIS, SMALL + ("sr.momentum=0.9",)),
                     device="cpu")


@pytest.mark.parametrize("override", ["run.checkify=true",
                                      "run.heartbeat_path=hb.json"])
def test_unported_run_options_raise_before_building(override, tmp_path):
    """run.checkify and run.heartbeat_path were refused until they were
    ported (slice 14, ROADMAP.md A19); both now train a step: the checked
    step (utils/debug.py) is bitwise the unchecked one, and the heartbeat
    reads the last step."""
    if override.startswith("run.heartbeat_path"):
        override = f"run.heartbeat_path={tmp_path / 'hb'}"
    base = SMALL + ("run.n_steps=1", "run.csv_path=null")
    state, logger = ttrain.train(tcfg.load(HEIS, base + (override,)),
                                 device="cpu")
    plain, plain_log = ttrain.train(tcfg.load(HEIS, base), device="cpu")
    assert state.step == 1
    assert logger.history["energy_re"] == plain_log.history["energy_re"]
    for k, v in plain.params.items():
        assert torch.equal(state.params[k], v), k
    if "heartbeat" in override:
        from qmcnn_tpu_torch.supervise import read_heartbeat

        assert read_heartbeat(str(tmp_path / "hb"))[0] == 1


def test_port_imports_no_jax():
    """Importing every qmcnn_tpu_torch module and chip_smoke loads neither
    JAX (nor flax/optax/orbax) nor the JAX package; the walk includes the
    dynamics modules (evolve, analyze, ops.tdvp, ops.spectroscopy) and the
    tooling (scan, supervise, export, ops.exact_native, utils.debug,
    utils.mfu, utils.profiling)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import qmcnn_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'qmcnn_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'qmcnn_tpu'))\n"
        "new = ['evolve', 'analyze', 'ops.tdvp', 'ops.spectroscopy', "
        "'scan', 'supervise', 'export', 'ops.exact_native', 'utils.debug', "
        "'utils.mfu', 'utils.profiling']\n"
        "bad += [m for m in new if 'qmcnn_tpu_torch.' + m not in mods]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 32


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
    assert importlib.util.find_spec("qmcnn_tpu_torch") is not None


@pytest.mark.parametrize("mem_gib", [0.05, 0.5, 80])
def test_auto_chunking_matches_jax(mem_gib):
    from qmcnn_tpu import builder as jb
    from qmcnn_tpu.utils import memory as jmem
    from qmcnn_tpu_torch import builder as tb
    from qmcnn_tpu_torch.utils import memory as tmem

    over = ("run.n_devices=1",)
    jc, tc = jcfg.load(HEIS, over), tcfg.load(HEIS, over)
    mem = int(mem_gib * 2**30)
    j_lat = jb.build_lattice(jc)
    t_lat = tb.build_lattice(tc)
    j_ham = jb.build_hamiltonian(jc, j_lat)
    t_ham = tb.build_hamiltonian(tc, t_lat)
    n_params = 4800
    assert tmem.auto_chunk_size(tc, t_lat, t_ham, n_params, mem_bytes=mem) \
        == jmem.auto_chunk_size(jc, j_lat, j_ham, n_params, hbm_bytes=mem)
    assert tmem.auto_jacobian_chunk(tc, t_lat, t_ham, n_params,
                                    mem_bytes=mem) \
        == jmem.auto_jacobian_chunk(jc, j_lat, j_ham, n_params,
                                    hbm_bytes=mem)


GCNN = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn.yaml")
GCNN_SMALL = ("lattice.shape=[4,4]", "model.channels=[2,2]",
              "sampler.n_walkers=32", "sampler.n_therm_sweeps=4",
              "run.n_steps=2", "run.log_every=1", "run.chunk_size=16",
              "run.validate_against_ed=true")


def test_gcnn_cli_cpu_snapshot_loads_in_jax(tmp_path, capsys):
    """The GCNN config through the CLI on the CPU (exchange_anti, minSR):
    finite rows with sr_iters 0, the ED check, and a snapshot under
    params/inner/ that the JAX package reads with equal log psi."""
    from qmcnn_tpu.models.gcnn import LogPsiGCNN as JG
    from qmcnn_tpu.models.gcnn import SpinFlipSymmetrized as JSF
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN as TG
    from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized as TSF

    out = str(tmp_path / "gcnn.csv")
    ttrain.main(["--config", GCNN, "--device", "cpu",
                 "--override", f"run.csv_path={out}",
                 *[x for ov in GCNN_SMALL for x in ("--override", ov)]])
    text = capsys.readouterr().out
    assert "relative error" in text
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(float(r["energy_re"]))
        assert 0.0 < float(r["accept"]) <= 1.0
        assert float(r["sr_iters"]) == 0.0
    flat = jtransfer.load_checkpoint_params(out + ".params.npz")
    assert all(k.startswith("params/inner/GroupConv_") for k in flat)
    assert len(flat) == 8
    kw = dict(lattice_shape=(4, 4), channels=(2, 2), kernel_size=3,
              complex_params=True)
    s = (2.0 * np.random.default_rng(1).integers(0, 2, (8, 16)) - 1.0
         ).astype(np.float32)
    want = j_apply(JSF(inner=JG(**kw), sector=1), _unflatten(flat), s)
    got = t_apply(TSF(TG(**kw), 1), ttransfer.params_from_jax(flat),
                  torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=1e-4, atol=1e-4)
    dphi = (got.im.numpy() - np.asarray(want.im) + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dphi, 0.0, atol=1e-4)
