"""PyTorch port: walker data-parallelism over torch.distributed.

n gloo ranks on the CPU (separate processes, ``tests/torch_dist_ranks.py``,
joined over a FileStore) must equal the 1-rank run walker for walker, as
the JAX mesh run equals its 1-device run (tests/test_distributed.py, whose
tolerances these are): identical noise keyed by global walker id gives
identical walkers; estimator means and parameters agree up to the order
of the reductions, which also catches a double or missing mean (values
off by ~n). The parameters are bitwise equal across ranks after every
step. Then the matrix-free ``cg`` and distributed minSR against the JAX
package, and the CLI under torchrun."""
import csv
import glob
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
from jax import shard_map
from jax.sharding import PartitionSpec as P

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.ops.cplx import C as JC
from qmcnn_tpu.parallel.mesh import walker_mesh
from qmcnn_tpu.sr import SR as JSR
from qmcnn_tpu.sr import cg as j_cg
from qmcnn_tpu.sr import make_s_matvec as j_make_s_matvec
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.vmc import energy_and_grad as j_energy_and_grad
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import train as ttrain
from qmcnn_tpu_torch.parallel.mesh import (WalkerGroup, make_sharded_vmc,
                                           rank_device, shard_train_state)
from qmcnn_tpu_torch.sampler.metropolis import prng_key
from qmcnn_tpu_torch.sr import SR as TSR
from qmcnn_tpu_torch.sr import cg as t_cg
from qmcnn_tpu_torch.sr import make_s_matvec as t_make_s_matvec
from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests import torch_dist_ranks as R
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
WORLDS = (2, 4)


def flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def t(x):
    return torch.from_numpy(np.array(x))


def jax_gcnn_case():
    """The complex, spin-flip projected 4x4 GCNN (GCNN_SMALL) built by JAX:
    params, thermalized walkers, E_loc and the gradient."""
    vmc_j, params_j, _ = jb.build(jcfg.load(R.GCNN, R.GCNN_SMALL))
    state = vmc_j.init_state(jax.random.key(3), 32, params_j)
    state = vmc_j.thermalize(state, jax.random.key(4), jnp.arange(32),
                             n_sweeps=3)
    _, _, g_j, eloc_j, _ = j_energy_and_grad(vmc_j.log_psi_fn, vmc_j.ham,
                                             params_j, state.walkers,
                                             chunk_size=8)
    return vmc_j, params_j, state.walkers.s, eloc_j, g_j


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The 1-rank run in this process and the 2- and 4-rank runs (all
    started together), on the same inputs: the JAX GCNN case for the
    distributed minSR, and a 1-rank checkpoint to restore in n ranks."""
    base = tmp_path_factory.mktemp("dist")
    vmc_j, params_j, s_j, eloc_j, g_j = jax_gcnn_case()
    ckpt = str(base / "ckpt_1rank")
    vmc, params = R.build_case()
    CheckpointManager(ckpt).save(0, vmc.init_state(prng_key(11), R.M, params))
    spec = {"params": params_from_jax(flat_np(params_j)), "s": t(s_j),
            "e_re": t(eloc_j.re), "e_im": t(eloc_j.im),
            "grads": params_from_jax(flat_np(g_j)), "ckpt_1rank": ckpt}
    procs = {}
    for world in WORLDS:
        work = base / f"w{world}"
        work.mkdir()
        torch.save(spec, work / "spec.pt")
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"),
             str(r), str(world), str(work)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    ranks = {}
    try:
        ref = R.run_all(spec, None)
        for ps in procs.values():
            for p in ps:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0, out
    finally:  # no rank outlives a failure
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    for world in procs:
        ranks[world] = [torch.load(base / f"w{world}" / f"rank{r}.pt",
                                   weights_only=True) for r in range(world)]
    return dict(ref=ref, ranks=ranks, base=base, spec=spec,
                jax=(vmc_j, params_j, s_j, eloc_j, g_j))


def _cat(recs, key="s"):
    return torch.cat([r[key] for r in recs])


def _close(got, want, rtol, atol, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _replicated(recs, what):
    """The parameters are bitwise equal on every rank."""
    for r in recs[1:]:
        for k, v in recs[0]["params"].items():
            assert torch.equal(v, r["params"][k]), f"{what}: {k} differs"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("move", R.MOVES)
def test_sharded_steps_match_one_rank(sharded_runs, world, move):
    ref = sharded_runs["ref"]["moves"][move]
    ranks = [r["moves"][move] for r in sharded_runs["ranks"][world]]
    for i, want in enumerate(ref):
        got = [rk[i] for rk in ranks]
        # identical proposals and decisions: identical walkers
        assert torch.equal(_cat(got), want["s"]), f"step {i}"
        _replicated(got, f"{move} step {i}")
        if i == 0:
            continue
        g = got[0]
        assert g["energy_re"] == pytest.approx(want["energy_re"], rel=2e-5,
                                               abs=1e-5)
        assert g["energy_var"] == pytest.approx(want["energy_var"],
                                                rel=2e-4, abs=1e-5)
        assert g["accept"] == pytest.approx(want["accept"], rel=1e-6)
        _close(g["params"], want["params"], 2e-4, 2e-6, f"{move} step {i}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_direct_sampler_matches_one_rank(sharded_runs, world):
    """tfim16_arnn: the direct sampler's draws are keyed by global walker
    id, so n ranks sample walker for walker what 1 rank samples; the
    params are bitwise equal across ranks and within tolerance of the
    1-rank run after the step."""
    ref = sharded_runs["ref"]["arnn"]
    ranks = [r["arnn"] for r in sharded_runs["ranks"][world]]
    for i, want in enumerate(ref):
        got = [rk[i] for rk in ranks]
        assert torch.equal(_cat(got), want["s"]), f"step {i}"
        _replicated(got, f"arnn step {i}")
    g = ranks[0][1]
    assert g["accept"] == want["accept"] == 1.0
    assert g["energy_re"] == pytest.approx(want["energy_re"], rel=2e-5,
                                           abs=1e-5)
    _close(g["params"], want["params"], 2e-4, 2e-6, "arnn")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", list(R.SOLVERS))
def test_sharded_sr_matches_one_rank(sharded_runs, world, solver):
    """Every SR solver under sharding reproduces the global solve: the
    mean all-reduces in the Jacobian means, diag(S), every S v, the minSR
    Gram (gather and ring assemblies) and the dense S."""
    want = sharded_runs["ref"]["sr"][solver]
    got = [r["sr"][solver] for r in sharded_runs["ranks"][world]]
    assert torch.equal(_cat(got), want["s"])
    _replicated(got, solver)
    assert got[0]["energy_re"] == pytest.approx(want["energy_re"], rel=1e-5,
                                                abs=1e-5)
    _close(got[0]["params"], want["params"], 5e-3, 5e-6, solver)
    if solver in ("pcg", "cg"):
        assert got[0]["sr_iters"] > 0
        assert abs(got[0]["sr_iters"] - want["sr_iters"]) <= 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("assembly", ["gather", "ring"])
def test_sharded_spring_matches_one_rank(sharded_runs, world, assembly):
    """2 SPRING steps (mu 0.9) with each minSR assembly: the params and the
    carried delta bitwise equal on every rank after every step (a rank
    whose delta drifted by one ulp would diverge silently), and within rtol
    2e-3 of the 1-rank run."""
    want = sharded_runs["ref"]["spring"][assembly]
    got = [r["spring"][assembly] for r in sharded_runs["ranks"][world]]
    for it in range(2):
        recs = [g[it] for g in got]
        _replicated(recs, f"spring {assembly} step {it}")
        for r in recs[1:]:
            assert torch.equal(r["sr_aux"], recs[0]["sr_aux"])
        assert torch.equal(_cat(recs), want[it]["s"])
        _close(recs[0]["params"], want[it]["params"], 2e-3, 2e-6,
               f"spring {assembly} step {it}")
        scale = float(want[it]["sr_aux"].abs().max())
        np.testing.assert_allclose(recs[0]["sr_aux"].numpy(),
                                   want[it]["sr_aux"].numpy(), rtol=2e-3,
                                   atol=2e-3 * scale)
        assert recs[0]["sr_aux"].any()
        assert np.isfinite(recs[0]["resid"]) and recs[0]["resid"] < 1e-2


@pytest.mark.parametrize("world", WORLDS)
def test_thermalize_sharded(sharded_runs, world):
    got = [r["thermalize"] for r in sharded_runs["ranks"][world]]
    assert torch.equal(_cat(got), sharded_runs["ref"]["thermalize"]["s"])


@pytest.mark.parametrize("world", WORLDS)
def test_run_steps_matches_stepwise(sharded_runs, world):
    """run_steps (keys fold_in(base_key, step)) equals step calls, on every
    rank, and the 1-rank run_steps within the step tolerances."""
    ranks = [r["run_steps"] for r in sharded_runs["ranks"][world]]
    want = sharded_runs["ref"]["run_steps"]
    for rk in ranks:
        assert rk["step"] == 4
        assert rk["fused_e"] == rk["loop_e"]
        for k, v in rk["fused"]["params"].items():
            assert torch.equal(v, rk["loop"]["params"][k])
    assert torch.equal(_cat([rk["fused"] for rk in ranks]), want["fused"]["s"])
    np.testing.assert_allclose(ranks[0]["fused_e"], want["fused_e"],
                               rtol=1e-5)
    _close(ranks[0]["fused"]["params"], want["fused"]["params"], 2e-4, 2e-6,
           "run_steps")


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_across_rank_counts(sharded_runs, world):
    """A 1-rank checkpoint restores in n ranks (each keeps its rows), and an
    n-rank save (walkers gathered, rank 0 writing) restores in 1 rank."""
    ranks = sharded_runs["ranks"][world]
    saved = torch.load(os.path.join(sharded_runs["spec"]["ckpt_1rank"], "0",
                                    "state.pt"), weights_only=True)
    assert torch.equal(_cat([r["checkpoint"] for r in ranks], "restored_s"),
                       saved["walkers"]["s"])
    vmc, params = R.build_case()
    template = vmc.init_state(prng_key(1), R.M, params)
    back = CheckpointManager(str(sharded_runs["base"] / f"w{world}"
                                 / "ckpt_nrank")).restore(template)
    step_rec = [r["checkpoint"]["saved"] for r in ranks]
    assert back.step == 1
    assert torch.equal(back.walkers.s, _cat(step_rec))
    for k, v in step_rec[0]["params"].items():
        assert torch.equal(back.params[k], v)


def test_refusals(sharded_runs):
    """60 walkers over 8 ranks, a VMC built without the group, and
    run.n_devices other than the world size all raise, as in JAX
    (test_mesh_validation); so does a rank whose card is missing."""
    vmc, params = R.build_case()
    state = vmc.init_state(prng_key(1), 60, params)
    group = WalkerGroup(rank=0, world_size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        shard_train_state(state, group)
    with pytest.raises(ValueError, match="walker group"):
        make_sharded_vmc(vmc, group)
    part = shard_train_state(vmc.init_state(prng_key(1), 64, params), group)
    assert part.walkers.s.shape == (8, R.N)
    for world in WORLDS:
        assert "run.n_devices=" in sharded_runs["ranks"][world][0][
            "n_devices_error"]
    with pytest.raises(RuntimeError, match="one process per card"):
        rank_device("cuda", torch.cuda.device_count())


def test_one_process_refuses_several_devices(monkeypatch):
    """run.n_devices > 1 without run.distributed is one process asked for
    several cards: the port raises, naming torchrun, before it builds; and
    run.distributed without a process group raises likewise."""
    def no_build(*args, **kwargs):
        raise AssertionError("train() built the model")

    monkeypatch.setattr(ttrain, "build", no_build)
    cfg = tcfg.load(HEIS, ("run.n_devices=2",))
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.train(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.train(tcfg.load(HEIS, ("run.distributed=true",)),
                     device="cpu")


def test_measure_refuses_several_devices_in_one_process(monkeypatch):
    """measure() as train(): run.n_devices > 1 without run.distributed raises
    before it builds, naming torchrun and the measure module; a walker
    group without run.distributed raises; run.distributed without a
    process group raises, naming torchrun."""
    from qmcnn_tpu_torch import measure as tmeasure

    def no_build(*args, **kwargs):
        raise AssertionError("measure() built the model")

    monkeypatch.setattr(tmeasure, "build", no_build)
    snap = os.path.join(ROOT, "runs", "j1j2_4x4_ground.csv.params.npz")
    with pytest.raises(ValueError, match="-m qmcnn_tpu_torch.measure"):
        tmeasure.measure(tcfg.load(HEIS, ("run.n_devices=2",)), snap,
                         device="cpu")
    group = WalkerGroup(rank=0, world_size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="run.distributed"):
        tmeasure.measure(tcfg.load(HEIS), snap, device="cpu", group=group)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmeasure.measure(tcfg.load(HEIS, ("run.distributed=true",)), snap,
                         device="cpu")


@pytest.mark.parametrize("assembly", ["gather", "ring"])
def test_distributed_minsr_matches_jax(sharded_runs, assembly):
    """The port's gather and ring minSR on 4 gloo ranks against the JAX
    SR.solve under shard_map over 4 of the 8 virtual CPU devices (the
    walker mesh of make_sharded_vmc), fed the same shards: rtol 1e-4, as
    the 1-device minSR parity (float32 Jacobian, Gram and Cholesky)."""
    vmc_j, params_j, s_j, eloc_j, g_j = sharded_runs["jax"]
    sr = JSR(solver="minsr", real_log_psi=False, diag_shift0=0.5,
             minsr_assembly=assembly)

    def solve(s, e_re, e_im):
        return sr.solve(vmc_j.log_psi_fn, params_j, s, g_j, jnp.asarray(2),
                        axis_name="dp", e_loc=JC(e_re, e_im))

    fn = jax.jit(shard_map(solve, mesh=walker_mesh(4),
                           in_specs=(P("dp"), P("dp"), P("dp")),
                           out_specs=(P(), P(), P()), check_vma=False))
    d_j, _, res_j = fn(s_j, eloc_j.re, eloc_j.im)
    want = flat_np(d_j)
    scale = max(np.abs(v).max() for v in want.values())
    got = [r["minsr"][assembly] for r in sharded_runs["ranks"][4]]
    _replicated([{"params": g["delta"]} for g in got], assembly)
    for k, v in want.items():
        np.testing.assert_allclose(got[0]["delta"][k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    assert got[0]["resid"] < 1e-3 and float(res_j) < 1e-3
    # and the 1-rank port solve (the single-device path)
    one = sharded_runs["ref"]["minsr"][assembly]["delta"]
    for k, v in want.items():
        np.testing.assert_allclose(one[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
         "model.param_scale=0.1", "sampler.n_walkers=64", "run.chunk_size=64")


def _cnn_case():
    """The real 4x4 CNN of tests/test_torch_vmc_sr.py, built by JAX."""
    vmc_j, params_j, _ = jb.build(jcfg.load(HEIS, SMALL))
    state = vmc_j.init_state(jax.random.key(3), 64, params_j)
    state = vmc_j.thermalize(state, jax.random.key(4), jnp.arange(64),
                             n_sweeps=4)
    _, _, g_j, _, _ = j_energy_and_grad(vmc_j.log_psi_fn, vmc_j.ham,
                                        params_j, state.walkers)
    return vmc_j, params_j, state.walkers.s, g_j


@pytest.mark.parametrize("model", ["cnn", "gcnn"])
def test_cg_and_s_matvec_match_jax(sharded_runs, model):
    """make_s_matvec (torch.func jvp + vjp) and cg against the JAX package
    (linearize + linear_transpose, while_loop) on the real CNN and the
    complex GCNN: S v to rtol 1e-4; cg's x to rtol 2e-3 (the SR-delta
    tolerance of the other solvers' parity) and equal iteration counts,
    and the same through SR(solver='cg')."""
    if model == "cnn":
        vmc_j, params_j, s_j, g_j = _cnn_case()
        over = SMALL
        cfg_path = HEIS
    else:
        vmc_j, params_j, s_j, _, g_j = sharded_runs["jax"]
        over = R.GCNN_SMALL
        cfg_path = R.GCNN
    vmc_t, _, _ = tb.build(tcfg.load(cfg_path, over), device="cpu")
    params_t = params_from_jax(flat_np(params_j))
    s_t = t(s_j)
    shift = 0.3
    rng = np.random.default_rng(5)
    v_np = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params_t.items()}
    mv_j = j_make_s_matvec(vmc_j.log_psi_fn, params_j, s_j, shift)
    mv_t = t_make_s_matvec(vmc_t.log_psi_fn, params_t, s_t, shift)
    # flat_np's keys follow the leaf order of tree_flatten
    v_j = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params_j),
        [jnp.asarray(v_np[k]) for k in flat_np(params_j)])
    want = flat_np(mv_j(v_j))
    got = mv_t({k: t(v) for k, v in v_np.items()})
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)

    r_j = j_cg(mv_j, g_j, tol=1e-4, maxiter=50)
    r_t = t_cg(mv_t, params_from_jax(flat_np(g_j)), tol=1e-4, maxiter=50)
    assert r_t.iters == int(r_j.iters) > 0
    want = flat_np(r_j.x)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(r_t.x[k].numpy(), v, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=k)
    kw = dict(solver="cg", cg_tol=1e-4, cg_maxiter=50, diag_shift0=shift,
              diag_shift_decay=1.0, diag_shift_min=shift)
    d_j, it_j, res_j = JSR(**kw).solve(vmc_j.log_psi_fn, params_j, s_j, g_j,
                                       jnp.asarray(0))
    d_t, it_t, res_t = TSR(**kw).solve(vmc_t.log_psi_fn, params_t, s_t,
                                       params_from_jax(flat_np(g_j)), 0)
    assert it_t == int(it_j) == r_t.iters
    for k, v in flat_np(d_j).items():
        np.testing.assert_allclose(d_t[k].numpy(), v, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=k)
    assert float(res_t) < 1e-4 and float(res_j) < 1e-4


def test_cg_guard_keeps_last_finite_iterate():
    """A matvec (diag(1, 2, 3)) that turns non-finite on its third product,
    the second iteration's: cg keeps the first iterate alpha b, counts the
    failed iteration and stops (JAX's guard)."""
    calls = []
    diag = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([3.0])}

    def matvec(v):
        calls.append(1)
        bad = float("nan") if len(calls) == 3 else 1.0
        return {k: bad * diag[k] * x for k, x in v.items()}

    b = {"a": torch.tensor([1.0, 1.0]), "b": torch.tensor([1.0])}
    r = t_cg(matvec, b, tol=1e-12, maxiter=10)
    assert r.iters == 2 and len(calls) == 3
    alpha = 3.0 / 6.0  # (b . b) / (b . A b)
    for k in b:
        torch.testing.assert_close(r.x[k], alpha * b[k])
    assert torch.isfinite(r.residual)


CLI_SMALL = ("lattice.shape=[4,4]", "model.channels=[4,4]",
             "sampler.n_walkers=64", "sampler.n_therm_sweeps=4",
             "run.n_steps=3", "run.log_every=1", "run.steps_per_dispatch=2",
             "run.validate_against_ed=true", "run.ckpt_every=1")


def _torchrun(tmp, name, extra=()):
    over = CLI_SMALL + (f"run.csv_path={tmp / name}.csv",
                        f"run.ckpt_dir={tmp / name}_ckpt",
                        "run.distributed=true", "run.n_devices=2") + extra
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "qmcnn_tpu_torch.train",
           "--device", "cpu", "--config", HEIS,
           *[x for ov in over for x in ("--override", ov)]]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _saved(directory, step):
    return torch.load(os.path.join(directory, str(step), "state.pt"),
                      weights_only=True)


def _bitwise(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_cli_torchrun_two_ranks(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    qmcnn_tpu_torch.train --device cpu: rc 0, one CSV written by rank 0, a
    manifest with n_devices 2, final params equal to the 1-rank run's
    within the SR tolerance; the 2-rank checkpoint of step 2 resumes in 2
    ranks to the uninterrupted run's step 3 bitwise, and restores in 1
    rank, whose step 3 takes the same walkers."""
    text = _torchrun(tmp_path, "two")
    assert "relative error" in text and text.count("=== heis10x10_sr") == 1
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "*.csv"))) == ["two.csv"]
    with open(tmp_path / "two.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    meta = json.load(open(tmp_path / "two.csv.meta.json"))
    assert meta["n_devices"] == 2 and meta["n_processes"] == 2
    ckpt = str(tmp_path / "two_ckpt")
    final = _saved(ckpt, 3)
    assert final["walkers"]["s"].shape == (64, 16)

    one_csv = str(tmp_path / "one.csv")
    cfg1 = tcfg.load(HEIS, CLI_SMALL + (f"run.csv_path={one_csv}",))
    state1, logger1 = ttrain.train(cfg1, device="cpu")
    np.testing.assert_allclose([float(r["energy_re"]) for r in rows],
                               logger1.history["energy_re"], rtol=1e-5)
    _close(final["params"], state1.params, 5e-3, 5e-6, "2 ranks vs 1")

    # resume the step-2 checkpoint in 2 ranks: bitwise the step-3 state
    resume = str(tmp_path / "again_ckpt")
    shutil.copytree(ckpt, resume)
    shutil.rmtree(os.path.join(resume, "3"))
    text = _torchrun(tmp_path, "again")
    assert "resumed from checkpoint at step 2" in text
    assert _bitwise(_saved(resume, 3), final)

    # restore it in 1 rank: the same step-3 walkers, params within tolerance
    one_ckpt = str(tmp_path / "one_rank_ckpt")
    shutil.copytree(ckpt, one_ckpt)
    shutil.rmtree(os.path.join(one_ckpt, "3"))
    cfg1 = tcfg.load(HEIS, CLI_SMALL + (f"run.ckpt_dir={one_ckpt}",))
    state, _ = ttrain.train(cfg1, device="cpu",
                            ckpt_manager=CheckpointManager(one_ckpt))
    assert state.step == 3
    assert torch.equal(state.walkers.s, final["walkers"]["s"])
    _close(state.params, final["params"], 5e-3, 5e-6, "restored in 1 rank")


def test_pcg_margins_diagnostic():
    """``tests/torch_pcg_margins.py``, the source of the sharded pcg split's
    printed margins, at a tiny size (16 walkers, 1 sweep, 1 step, 2 ranks
    and the split-mean run): it reaches its JSON line, the walkers agree
    bitwise through step 1's sampling, a repeat of the 1-rank run is
    bitwise, and each run's trace holds one row per pcg iteration plus the
    start, with the loop stopping at its first rr <= atol2."""
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_pcg_margins.py"),
         "--walkers", "16", "--sweeps", "1", "--steps", "1", "--ranks", "2",
         "--split-mean"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["walkers_bitwise_after_therm"] and out["repeat_bitwise"]
    for st in out["steps"] + out["split_mean"]["steps"]:
        assert st["walkers_bitwise"]
        for name, iters in (("1rank", st["sr_iters_1rank"]),
                            ("nrank", st["sr_iters_nrank"])):
            margins = [row[name]["margin"] for row in st["loop"]
                       if name in row]
            assert len(margins) == iters + 1
            assert margins[-1] <= 0 < min(margins[:-1])


def _report_close(got: dict, want: dict, rtol: float, what: str) -> None:
    """The same keys; every number of a measurement report within rtol
    (atol 1e-6 near 0), a None (a NaN omega) where the other has one."""
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _report_close(g, w, rtol, f"{what} {key}")
        elif isinstance(w, bool):
            assert g is w, f"{what} {key}"
        else:
            def arr(x):
                return np.asarray([np.nan if v is None else v
                                   for v in np.atleast_1d(
                                       np.asarray(x, dtype=object))],
                                  np.float64)

            np.testing.assert_allclose(arr(g), arr(w), rtol=rtol, atol=1e-6,
                                       equal_nan=True,
                                       err_msg=f"{what} {key}")


def test_sharded_measure_matches_one_rank(tmp_path):
    """measure() with every flag the 4x4 square lattice takes (the Lanczos
    step, the q = 0 sector, three Renyi-2 regions, the SMA, <S^2>, the
    dimers and the fidelity with a second state) in 2 gloo ranks against
    1 (``tests/torch_dist_ranks.py``'s measure suite): the walkers after
    thermalization bitwise the 1-rank run's rows; the per-walker Lanczos
    (E_loc, G) and sector num / den pooled over the ranks in global walker
    order within rtol 1e-6 of 1 rank (the CPU convolutions need not be
    bitwise across batch sizes); every report number within rtol 1e-5
    (reduction order), and both ranks' reports identical."""
    spec = R.measure_spec(str(tmp_path))
    torch.save(spec, tmp_path / "spec.pt")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"),
         str(r), "2", str(tmp_path), "measure"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        ref = R.run_measure(spec, None)
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    assert torch.equal(torch.cat([rk["walkers"] for rk in ranks]),
                       ref["walkers"])
    for key in ("lanczos_e1", "lanczos_g", "sector_num", "sector_den"):
        for rk in ranks:
            assert rk[key].shape == ref[key].shape == (4, 32), key
            np.testing.assert_allclose(rk[key].numpy(), ref[key].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    assert ranks[0]["report"] == ranks[1]["report"]
    _report_close(ranks[0]["report"], ref["report"], 1e-5, "2 ranks")
    for key in ("renyi2_entropy", "sma_gap_bound", "lanczos_energy",
                "fidelity_vs_ckpt", "sector_energy", "total_spin_sq"):
        assert key in ref["report"], key


def test_sharded_tdvp_matches_one_rank(tmp_path):
    """TDVP.rhs with a walker group (``tests/torch_dist_ranks.py``'s tdvp
    suite): 2 gloo ranks, each with half the rows of the 8-site chain's
    basis (Born weights, normalized over both ranks) or of a 64-row MC
    batch (uniform weights), in imaginary and real time with the dense
    and the minSR solve, against 1 rank: theta-dot within rtol 1e-5 of
    its largest entry, the energy, its variance, epsilon^2 and the
    residual within rtol 1e-5 (atol 1e-6), both ranks identical. At
    diag_shift 0.1: the dense S summed in two halves differs from one sum
    by f32 reduction order, which the solve amplifies by S + shift's
    condition number (2.8e-5 of theta-dot's largest entry at shift 1e-2,
    4e-6 at 0.1; minSR's gathered Gram 7e-7 at either)."""
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN

    rng = np.random.default_rng(13)
    mc = (2 * rng.integers(0, 2, (64, R.N)) - 1).astype(np.float32)
    model = LogPsiCNN(lattice_shape=(R.N,), channels=(4, 4),
                      complex_params=True, param_scale=0.2)
    spec = {"params": model.init(5), "mc": torch.as_tensor(mc)}
    torch.save(spec, tmp_path / "spec.pt")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"),
         str(r), "2", str(tmp_path), "tdvp"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        ref = R.run_tdvp(spec, None)
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    assert sorted(ref) == sorted(ranks[0]) and len(ref) == 8
    for key, want in ref.items():
        for rk in ranks:
            td = want["theta_dot"].numpy()
            np.testing.assert_allclose(
                rk[key]["theta_dot"].numpy(), td, rtol=1e-5,
                atol=1e-5 * np.abs(td).max(), err_msg=key)
            np.testing.assert_allclose(rk[key]["scalars"].numpy(),
                                       want["scalars"].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        assert torch.equal(ranks[0][key]["theta_dot"],
                           ranks[1][key]["theta_dot"]), key
