"""PyTorch port, slice 14: the tooling (ROADMAP A19) against the JAX
package on equal inputs: the scan driver, export, the checked step
(``utils/debug.py``), the memory preflight, native ED, MFU and profiling.

Tolerances: the scan's ED energies rel 1e-9 (two Lanczos runs on one
matrix); the memory estimates rel 1e-12 (the same float arithmetic in
another order); the native matvecs bitwise against JAX's library (the same
C++ source and flags) and within 1e-12 of the port's sparse operators; the
sector ground energy within 1e-9 relative of the full space's; FLOP counts
exact. Everything else is exact."""
import csv
import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.utils import memory as jmem
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.utils import memory as tmem
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TFIM = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
FIXTURE = os.path.join(ROOT, "runs", "ab_cnn_float32.csv.params.npz")


# -- scan ---------------------------------------------------------------------

SCAN_OVERRIDES = ("lattice.shape=[8]", "model.channels=[4,4]",
                  "model.kernel_size=3", "sampler.n_walkers=32",
                  "sampler.n_therm_sweeps=4", "run.n_steps=4",
                  "run.log_every=2", "run.steps_per_dispatch=2",
                  "run.validate_against_ed=true", "run.seed=3")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two-point h scans of the 8-site TFIM in both packages: per package
    (rows, log lines, out dir, the configs train() saw)."""
    from qmcnn_tpu import scan as jscan
    from qmcnn_tpu import train as jtrain
    from qmcnn_tpu_torch import scan as tscan
    from qmcnn_tpu_torch import train as ttrain

    out = {}
    for name, cfglib, scan, train_mod in (("jax", jcfg, jscan, jtrain),
                                          ("torch", tcfg, tscan, ttrain)):
        d = str(tmp_path_factory.mktemp(f"scan_{name}"))
        logs, seen = [], []
        train = train_mod.train

        def spy(cfg, *a, _train=train, **kw):
            seen.append(cfg)
            return _train(cfg, *a, **kw)

        train_mod.train = spy
        try:
            kw = {} if name == "jax" else {"device": "cpu"}
            rows = scan.run_scan(cfglib.load(TFIM, SCAN_OVERRIDES),
                                 "hamiltonian.h", [2.0, 1.6], d,
                                 log=logs.append, **kw)
        finally:
            train_mod.train = train
        out[name] = (rows, logs, d, seen)
    return out


def test_scan_parse_values_matches_jax():
    from qmcnn_tpu import scan as jscan
    from qmcnn_tpu_torch import scan as tscan

    for text in ("3.0,2.0;1.5", " 1, 2 ,", "0.5"):
        assert tscan._parse_values(text) == jscan._parse_values(text)
    for mod in (jscan, tscan):
        with pytest.raises(ValueError, match="empty"):
            mod._parse_values(" , ")


def test_scan_summary_matches_jax(scans):
    """The same columns in summary.csv / .json, the same ED energies, one
    finite energy per point, and the warm-start log lines."""
    (jrows, jlogs, jdir, _), (trows, tlogs, tdir, _) = (scans["jax"],
                                                         scans["torch"])
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    for jr, tr in zip(jrows, trows):
        assert tr["value"] == jr["value"]
        assert tr["e_exact"] == pytest.approx(jr["e_exact"], rel=1e-9)
        assert np.isfinite(tr["energy"]) and tr["rel_err"] is not None
    for d in (jdir, tdir):
        with open(os.path.join(d, "summary.csv")) as f:
            header = next(csv.reader(f))
        assert header == list(jrows[0])
    with open(os.path.join(tdir, "summary.json")) as f:
        summary = json.load(f)
    assert summary["param"] == "hamiltonian.h" and summary["warm"] is True
    assert [r["value"] for r in summary["rows"]] == [2.0, 1.6]
    for logs in (jlogs, tlogs):
        assert any("(cold start)" in ln for ln in logs)
        assert any("warm from point_0_2.npz" in ln for ln in logs)


def test_scan_points_load_across_packages(scans):
    """Each port point's npz has JAX's key set and shapes; a port point
    warm-starts the JAX model and a JAX point the port's, every leaf
    transferred; point 1 started from point 0's npz, point 0 cold."""
    from qmcnn_tpu.utils.transfer import warm_start as j_warm
    from qmcnn_tpu_torch.utils.transfer import (params_to_jax,
                                                warm_start as t_warm)

    jdir, tdir = scans["jax"][2], scans["torch"][2]
    for name in ("point_0_2.npz", "point_1_1.6.npz"):
        with np.load(os.path.join(jdir, name)) as jz, \
                np.load(os.path.join(tdir, name)) as tz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in jz.files:
                assert tz[k].shape == jz[k].shape and tz[k].dtype == \
                    jz[k].dtype, k
    jcfg1 = jcfg.load(TFIM, SCAN_OVERRIDES)
    _, jparams, _ = jb.build(jcfg1)
    tpoint = os.path.join(tdir, "point_1_1.6.npz")
    merged = j_warm(jparams, tpoint)
    with np.load(tpoint) as z:
        from qmcnn_tpu.utils.transfer import _flatten
        for k, v in _flatten(merged).items():
            np.testing.assert_array_equal(np.asarray(v), z[k])
    _, tparams, _ = tb.build(tcfg.load(TFIM, SCAN_OVERRIDES), device="cpu")
    jpoint = os.path.join(jdir, "point_1_1.6.npz")
    merged = params_to_jax(t_warm(tparams, jpoint))
    with np.load(jpoint) as z:
        for k, v in merged.items():
            np.testing.assert_array_equal(v, z[k])
    seen = scans["torch"][3]
    assert seen[0].run.init_from is None
    assert seen[1].run.init_from == os.path.join(tdir, "point_0_2.npz")
    assert all(c.run.heartbeat_path is None and c.run.ckpt_dir is None
               and c.run.n_steps == 4 for c in seen)


# -- export -------------------------------------------------------------------

def test_export_reexport_matches_jax(tmp_path):
    from qmcnn_tpu import export as jexport
    from qmcnn_tpu_torch import export as texport

    want = jexport.export_params(FIXTURE, str(tmp_path / "j.npz"))
    got = texport.export_params(FIXTURE, str(tmp_path / "t.npz"))
    assert sorted(got) == sorted(want)
    with np.load(tmp_path / "t.npz") as z:
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], np.asarray(v))
            assert z[k].dtype == np.asarray(v).dtype
    for mod in (jexport, texport):
        with pytest.raises(ValueError, match=r"\.npz"):
            mod.export_params(FIXTURE, str(tmp_path / "x.bin"))


def test_export_port_checkpoint(tmp_path, capsys):
    """A port checkpoint directory exports to params_to_jax of its
    state's params, and with --field ema of its EMA (the CLI)."""
    from qmcnn_tpu_torch import export as texport
    from qmcnn_tpu_torch import train as ttrain
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    cfg = tcfg.load(TFIM, SCAN_OVERRIDES + ("optimizer.ema_decay=0.9",
                                            "run.csv_path=null"))
    ck = str(tmp_path / "ck")
    state, _ = ttrain.train(cfg, device="cpu",
                            ckpt_manager=CheckpointManager(ck))
    for field, tree in (("params", state.params), ("ema", state.ema)):
        out = str(tmp_path / f"{field}.npz")
        assert texport.main(["--ckpt-dir", ck, "--out", out, "--field",
                             field]) == 0
        want = params_to_jax(tree)
        with np.load(out) as z:
            assert sorted(z.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(z[k], v)
    assert "exported 4 leaves" in capsys.readouterr().out
    with pytest.raises(ValueError, match=r"\.npz"):
        texport.main(["--ckpt-dir", ck, "--out", str(tmp_path / "p.bin")])


# -- the checked step ---------------------------------------------------------

def _both_checked(fn_j, fn_t, *args):
    """Raise-or-result of JAX's checked(jit(fn_j)) and the port's
    checked(fn_t) on the same numpy ``args``: (jax, torch), each an
    exception message or the value."""
    from qmcnn_tpu.utils.debug import checked as jchecked
    from qmcnn_tpu_torch.utils.debug import checked as tchecked

    out = []
    for checked, fn, conv in ((jchecked, jax.jit(fn_j), jnp.asarray),
                              (tchecked, fn_t, torch.as_tensor)):
        try:
            out.append(np.asarray(checked(fn)(*map(conv, args))))
        except Exception as e:  # noqa: BLE001 - either package's error
            out.append(str(e))
    return out


def test_checked_oob_index_as_jax():
    j, t = _both_checked(lambda x, i: x[i], lambda x, i: x[i],
                         np.arange(4.0), np.array([17]))
    for msg in (j, t):
        assert isinstance(msg, str) and "out-of-bounds" in msg
    assert "aten.index" in t
    j, t = _both_checked(lambda x, i: x[i], lambda x, i: x[i],
                         np.arange(4.0), np.array([2]))
    np.testing.assert_array_equal(t, j)
    from qmcnn_tpu_torch.utils.debug import checked

    with pytest.raises(Exception, match="out-of-bounds|index"):
        checked(lambda x, i: x[i])(torch.arange(4.0), torch.tensor(17))
    with pytest.raises(Exception, match="out-of-bounds.*index_select"):
        checked(lambda x, i: torch.index_select(x, 0, i))(
            torch.arange(4.0), torch.tensor([1, 4]))
    with pytest.raises(Exception, match="out-of-bounds.*gather"):
        checked(lambda x, i: torch.gather(x, 0, i))(
            torch.arange(4.0), torch.tensor([-1]))


def test_checked_nan_inf_and_int_division_as_jax():
    """NaN raises at the op that made it (log of a negative, inf - inf, a
    NaN input times 2); a division by zero raises (integer, true and float
    division: checkify's check on the div primitive); +-inf from any other
    op passes (log 0, exp 1000)."""
    cases = [
        (lambda x: jnp.log(x).sum(), lambda x: torch.log(x).sum(),
         np.array([1.0, -1.0], np.float32), "aten.log"),
        (lambda x: x - x, lambda x: x - x, np.array([np.inf], np.float32),
         "aten.sub"),
        (lambda x: x * 2, lambda x: x * 2, np.array([np.nan], np.float32),
         "aten.mul"),
        (lambda x, y: x // y, lambda x, y: x // y,
         (np.array([3], np.int32), np.array([0], np.int32)),
         "division by zero in aten.floor_divide"),
        (lambda x, y: x / y, lambda x, y: x / y,
         (np.array([3], np.int32), np.array([0], np.int32)),
         "division by zero in aten.div"),
        (lambda x, y: x / y, lambda x, y: x / y,
         (np.array([3.0], np.float32), np.array([0.0], np.float32)),
         "division by zero in aten.div"),
        (lambda x: 1.0 / x, lambda x: 1.0 / x,
         np.array([0.0, 2.0], np.float32), "division by zero in aten."),
    ]
    for fj, ft, args, name in cases:
        args = args if isinstance(args, tuple) else (args,)
        j, t = _both_checked(fj, ft, *args)
        assert isinstance(j, str) and isinstance(t, str), (name, j, t)
        assert name in t, t
    for fj, ft, x in ((jnp.log, torch.log, np.array([0.0], np.float32)),
                      (jnp.exp, torch.exp, np.array([1000.0], np.float32))):
        j, t = _both_checked(fj, ft, x)
        np.testing.assert_array_equal(t, j)
        assert np.isinf(t).all()
    j, t = _both_checked(lambda x, y: x / y, lambda x, y: x / y,
                         np.array([3], np.int32), np.array([2], np.int32))
    np.testing.assert_array_equal(t, j)
    # JAX's DivisionByZeroError covers integer div only (lax.rem and jnp's
    # % of 3 by 0 pass unchecked); the port raises on an integer remainder
    # by zero too, which has no defined value
    from qmcnn_tpu_torch.utils.debug import checked

    for rem in (lambda x, y: x % y, torch.fmod):
        with pytest.raises(Exception, match="division by zero.*(remainder|"
                                            "fmod)"):
            checked(rem)(torch.tensor([3]), torch.tensor([0]))


def test_checked_user_check_and_outside_the_mode():
    from qmcnn_tpu_torch.utils import debug

    def f(x):
        debug.check(x.sum() > 10, "sum too small")
        return x * 2

    with pytest.raises(debug.CheckError, match="sum too small"):
        debug.checked(f)(torch.ones(3))
    np.testing.assert_array_equal(f(torch.ones(3)).numpy(), 2.0)
    assert not debug.active()
    with debug.CheckMode():
        assert debug.active()
        with pytest.raises(debug.CheckError, match="kernel"):
            debug.check_kernel_output("k", torch.tensor([float("nan")]))
    assert not debug.active()
    debug.check_kernel_output("k", torch.tensor([float("nan")]))  # off


def test_checked_train_is_bitwise_the_unchecked_one():
    """JAX's test_train_cli_checkify_path config (4x4 Heisenberg, channels
    [4], M = 32, exchange, SR off, 2 steps in one chunk) trains under
    run.checkify with no fault, bitwise as without it; so does heis10x10_sr
    at 4x4 with pcg SR."""
    from qmcnn_tpu_torch import train as ttrain

    jax_cfg = tcfg.Config(
        name="checkify_smoke",
        lattice=tcfg.LatticeConfig(shape=(4, 4)),
        model=tcfg.ModelConfig(channels=(4,), kernel_size=3),
        hamiltonian=tcfg.HamiltonianConfig(kind="heisenberg"),
        sampler=tcfg.SamplerConfig(n_walkers=32, move="exchange",
                                   n_sweeps_per_step=1, n_therm_sweeps=2),
        sr=tcfg.SRConfig(enabled=False),
        run=tcfg.RunConfig(n_steps=2, steps_per_dispatch=2, log_every=1,
                           validate_against_ed=False, checkify=True,
                           n_devices=1))
    heis = tcfg.load(HEIS, ("lattice.shape=[4,4]", "model.channels=[4,4]",
                            "sampler.n_walkers=32",
                            "sampler.n_therm_sweeps=2", "run.n_steps=2",
                            "run.log_every=1", "run.checkify=true"))
    for cfg in (jax_cfg, heis):
        got, glog = ttrain.train(cfg, device="cpu")
        plain = tcfg.apply_overrides(cfg, ("run.checkify=false",))
        want, wlog = ttrain.train(plain, device="cpu")
        assert got.step == 2
        assert glog.history["energy_re"] == wlog.history["energy_re"]
        for k, v in want.params.items():
            assert torch.equal(got.params[k], v), k
        assert torch.equal(got.walkers.s, want.walkers.s)


# -- the memory preflight -----------------------------------------------------

CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs"))
                 if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_memory_preflight_matches_jax(name, monkeypatch):
    """connected_k, peak_estimate (default and explicit chunks, every
    solver), preflight_message and describe equal JAX's at pinned memory
    sizes; the port counts as many ranks as JAX counts devices, and its
    message speaks of the card after the same numbers. The PixelCNN
    ARNN's footprint is the port's own (N sites of C channels a layer,
    where the JAX package counts a MADE's one site of max(C, 3N)): JAX's
    estimates are held to the port's with that footprint put in."""
    path = os.path.join(ROOT, "configs", name)
    jc, tc = jcfg.load(path), tcfg.load(path)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    if tc.model.kind == "arnn" and tc.model.arnn_conv_kernel:
        fp = tmem.model_footprint(tc, tl.n_sites)
        assert (fp.n_sites, fp.max_width, fp.n_layers) == (
            tl.n_sites, max(tc.model.channels), len(tc.model.channels) + 1)
        monkeypatch.setattr(jmem, "model_footprint", lambda cfg, n: (
            jmem.ModelFootprint(**dataclasses.asdict(fp))))
    jh, th = jb.build_hamiltonian(jc, jl), tb.build_hamiltonian(tc, tl)
    # JAX divides the walkers over run.n_devices, else every visible device
    world = tc.run.n_devices or jax.device_count()
    assert tmem.connected_k(th, tl.n_sites) == jmem.connected_k(jh,
                                                                jl.n_sites)
    n_params = 50_000
    for gib in (1, 16, 80):
        mem = gib * 2**30
        for solver, cs, jcs in ((None, None, None), ("minsr", 16, 8),
                                ("cg", None, 4), ("dense", 8, None)):
            if solver is not None and not tc.sr.enabled:
                continue
            want = jmem.peak_estimate(jc, jl, jh, n_params, hbm_bytes=mem,
                                      solver=solver, chunk_size=cs,
                                      jacobian_chunk=jcs)
            got = tmem.peak_estimate(tc, tl, th, n_params, mem_bytes=mem,
                                     solver=solver, chunk_size=cs,
                                     jacobian_chunk=jcs, world_size=world)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-12), k
            jmsg = jmem.preflight_message(want)
            tmsg = tmem.preflight_message(got)
            assert (tmsg is None) == (jmsg is None)
            if tmsg is not None:
                assert tmsg.split("). ")[0] == jmsg.split("). ")[0]
                assert "torch.OutOfMemoryError" in tmsg
        assert tmem.describe(tc, tl, th, n_params, mem_bytes=mem,
                             world_size=world) == jmem.describe(
            jc, jl, jh, n_params, hbm_bytes=mem)


def test_builder_prints_the_preflight_warning(capsys, monkeypatch):
    """The builder's WARNING line, with SR only, when the estimate is
    above 0.8 of the card's memory (a 64 MiB card here)."""
    monkeypatch.setattr(tmem, "device_memory_bytes",
                        lambda device="cuda": 64 * 2**20)
    over = ("lattice.shape=[4,4]", "model.channels=[4,4]",
            "sampler.n_walkers=32")
    tb.build(tcfg.load(HEIS, over), device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("WARNING: estimated peak HBM")
    tb.build(tcfg.load(HEIS, over + ("sr.enabled=false",)), device="cpu")
    assert "WARNING" not in capsys.readouterr().out


# -- native ED ----------------------------------------------------------------

def _native_cases():
    from qmcnn_tpu_torch.lattice import chain, square

    sq = square(2, 4)
    bonds = np.concatenate([sq.nn_bonds, sq.nnn_bonds])
    coup = np.concatenate([np.ones(len(sq.nn_bonds)),
                           0.5 * np.ones(len(sq.nnn_bonds))])
    return chain(10), sq, bonds, coup


def test_native_matvecs_match_jax_and_sparse():
    from qmcnn_tpu.ops import exact_native as jed
    from qmcnn_tpu_torch.ops import exact, exact_native as ted

    assert ted.available() and jed.available()
    ch, sq, bonds, coup = _native_cases()
    rng = np.random.default_rng(0)
    pairs = [
        (ted.tfim_operator(10, ch.nn_bonds, j=1.0, h=0.7),
         jed.tfim_operator(10, ch.nn_bonds, j=1.0, h=0.7),
         exact.sparse_tfim(10, ch.nn_bonds, j=1.0, h=0.7)),
        (ted.heisenberg_operator(8, bonds, coup),
         jed.heisenberg_operator(8, bonds, coup),
         exact.sparse_heisenberg(8, sq.nn_bonds, j=1.0,
                                 nnn_bonds=sq.nnn_bonds, j2=0.5)),
        (ted.heisenberg_sector_operator(8, bonds, coup),
         jed.heisenberg_sector_operator(8, bonds, coup), None),
    ]
    for top, jop, sp in pairs:
        for _ in range(2):
            v = rng.normal(size=top.shape[0])
            got = top @ v
            np.testing.assert_array_equal(got, jop @ v)
            if sp is not None:
                np.testing.assert_allclose(got, sp @ v, rtol=1e-12,
                                           atol=1e-12)


def test_native_sector_energy_equals_full_space():
    from qmcnn_tpu_torch.lattice import chain, square
    from qmcnn_tpu_torch.ops import exact, exact_native as ted

    sq = square(4)
    full = ted.ground_energy(ted.heisenberg_operator(16, sq.nn_bonds))
    sector = ted.ground_energy(ted.heisenberg_sector_operator(16,
                                                              sq.nn_bonds))
    assert sector == pytest.approx(full, rel=1e-9)
    assert full == pytest.approx(
        exact.ground_energy(exact.sparse_heisenberg(16, sq.nn_bonds)),
        rel=1e-9)
    ch = chain(12)
    assert ted.ground_energy(ted.tfim_operator(12, ch.nn_bonds)) == \
        pytest.approx(exact.ground_energy(exact.sparse_tfim(12, ch.nn_bonds)),
                      rel=1e-9)
    with pytest.raises(ValueError, match="even N"):
        ted.heisenberg_sector_operator(7, chain(7).nn_bonds)
    with pytest.raises(ValueError, match="bond sites"):
        ted.tfim_operator(4, np.array([[0, 4]]))


def test_native_unavailable_raises(tmp_path, monkeypatch):
    """A build that fails leaves available() False and every operator
    raising RuntimeError, with nothing written to the JAX package's
    native/build/."""
    from qmcnn_tpu_torch.lattice import chain
    from qmcnn_tpu_torch.ops import exact_native as ted

    monkeypatch.setattr(ted, "_lib", None)
    monkeypatch.setattr(ted, "_load_error", None)
    monkeypatch.setattr(ted, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ted, "FLAGS", (("-O3", "--no-such-flag"),))
    assert not ted.available()
    bonds = chain(6).nn_bonds
    for make in (lambda: ted.tfim_operator(6, bonds),
                 lambda: ted.heisenberg_operator(6, bonds),
                 lambda: ted.heisenberg_sector_operator(6, bonds)):
        with pytest.raises(RuntimeError, match="native ED unavailable"):
            make()
    assert ted.BUILD_DIR.parent == tmp_path
    assert not list((tmp_path / "build").glob("*.so"))


# -- MFU ----------------------------------------------------------------------

def test_counted_flops_of_a_matmul_equals_jax():
    from qmcnn_tpu.utils.mfu import compiled_flops
    from qmcnn_tpu_torch.utils.mfu import counted_flops

    want = compiled_flops(lambda x, y: x @ y, jnp.ones((64, 32)),
                          jnp.ones((32, 16)))
    got = counted_flops(lambda x, y: x @ y, torch.ones(64, 32),
                        torch.ones(32, 16))
    assert got == want == 2.0 * 64 * 32 * 16
    assert counted_flops(lambda x: x * 2, torch.ones(8)) is None


def test_counted_flops_per_sample_conv_gradients():
    """torch.func's per-sample gradients of a convolution (the SR
    Jacobian's form: one group per sample) count the weight gradient once
    per sample, not once per sample per group; an ungrouped backward
    counts as FlopCounterMode counts it."""
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    from qmcnn_tpu_torch.utils.mfu import counted_flops

    w, xs = torch.randn(8, 4, 3, 3), torch.randn(16, 4, 10, 10)
    fwd = 2 * 16 * 8 * 4 * 9 * 100  # 2 per MAC, 'same' padding

    def loss(w, x):
        return F.conv2d(x[None], w, padding=1).sum()

    per_sample = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))
    assert counted_flops(per_sample, w, xs) == 2 * fwd  # forward + wgrad
    x = xs.clone().requires_grad_()
    w.requires_grad_()

    def backward():
        F.conv2d(x, w, padding=1).sum().backward()

    counter = FlopCounterMode(display=False)
    with counter:
        backward()
    assert counted_flops(backward) == counter.get_total_flops() == 3 * fwd


def test_sweep_flop_model_matches_jax():
    """The TPU sweep kernel's hand model over the port's conv layers: the
    heis10x10_sr fixture (exchange) and tfim16's init (flip)."""
    from qmcnn_tpu.utils.mfu import pallas_sweep_flops_per_proposal as jfl
    from qmcnn_tpu.utils.transfer import load_checkpoint_params
    from qmcnn_tpu_torch.utils.mfu import pallas_sweep_flops_per_proposal
    from qmcnn_tpu_torch.utils.transfer import params_from_jax

    def unflat(flat):
        out = {}
        for k, v in flat.items():
            d = out
            *head, last = k.split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[last] = jnp.asarray(v)
        return out

    flat = load_checkpoint_params(FIXTURE)
    assert pallas_sweep_flops_per_proposal(
        params_from_jax(flat), (10, 10), "exchange") == jfl(
            unflat(flat), (10, 10), "exchange")
    _, params, _ = tb.build(tcfg.load(TFIM), device="cpu")
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    assert pallas_sweep_flops_per_proposal(params, (16,), "flip") == jfl(
        unflat(params_to_jax(params)), (16,), "flip")


def test_peak_and_mfu_contract(monkeypatch):
    from qmcnn_tpu_torch.utils import mfu as tmfu

    assert tmfu.device_peak_flops("float32") is None  # the CPU
    assert tmfu.device_peak_flops("bfloat16", device="cpu") is None
    assert tmfu.mfu(1e9, 1e-3, "float32") is None
    assert tmfu.fmt_mfu(None) == "n/a" and tmfu.fmt_mfu(0.625) == "62.5%"
    assert tmfu._PEAKS["h100 80gb hbm3"] == {"bfloat16": 989e12,
                                             "float32": 495e12 / 3}
    monkeypatch.setattr(tmfu, "device_peak_flops",
                        lambda dtype="float32", device=None:
                        {"float32": 1e12, "bfloat16": 2e12}[dtype])
    assert abs(tmfu.mfu(5e8, 1e-3, "float32") - 0.5) < 1e-12
    assert abs(tmfu.mfu(5e8, 1e-3, "bfloat16") - 0.25) < 1e-12


def test_step_flops_counts_torch_ops_and_kernel_rows(monkeypatch):
    """One step's FlopCounterMode count, plus each kernel's rows (the
    configurations its launches computed) times the hand model: a step
    that launches K1 on 10 configurations adds 10 CNN forwards."""
    from torch.utils.flop_counter import FlopCounterMode

    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.sampler.metropolis import prng_key
    from qmcnn_tpu_torch.utils import mfu as tmfu

    cfg = tcfg.load(HEIS, ("lattice.shape=[4,4]", "model.channels=[4,4]",
                           "sampler.n_walkers=16"))
    vmc, params, _ = tb.build(cfg, device="cpu")
    state = vmc.init_state(prng_key(0), 16, params)
    ids = torch.arange(16)
    counter = tmfu.flop_counter()
    with counter:
        vmc.step(state, 0, ids)
    plain = tmfu.step_flops(vmc, state, ids)
    assert plain == counter.get_total_flops() > 0
    raw = FlopCounterMode(display=False)  # counts the SR Jacobian's
    with raw:                             # per-sample wgrads M times over
        vmc.step(state, 0, ids)
    assert raw.get_total_flops() > plain

    class FakeVMC:
        def step(self, st, key, i):
            k1.metropolis_sweep.rows += 10
            return torch.ones(4, 8) @ torch.ones(8, 2)

    fwd = tmfu.forward_flop(params, 16)
    assert fwd == 2 * 16 * (9 * 4 + 9 * 4 * 4)
    assert tmfu.step_flops(FakeVMC(), state, ids) == 2 * 4 * 8 * 2 + 10 * fwd
    assert tmfu.gcnn_flop(64, 64, 3, True, 2) == 2 * (
        9 * 64 * 64 * 2 * 2 + 2 * (9 * 64 * 64 * 64 * 2 * 3 + 4 * 64 * 64)
    ) + 2 * 9 * 64 * 64


# -- profiling ----------------------------------------------------------------

def test_trace_kernel_table_and_idle_share(tmp_path):
    """trace() writes a chrome trace on the CPU and yields the profiler;
    kernel_table and idle_share read it (host ops here: a CPU run has no
    device events, so the device table is empty and its idle share None)."""
    from qmcnn_tpu_torch.utils import profiling

    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            with profiling.annotate("block"):
                b = a @ a
            torch.sin(b)
    with gzip.open(tmp_path / profiling.TRACE_FILE, "rt") as f:
        assert json.load(f)["traceEvents"]
    rows = profiling.kernel_table(prof, "cpu")
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::mm"]["count"] == 3
    assert by_name["aten::sin"]["count"] == 3
    assert all(r["total_ms"] > 0 for r in rows)
    assert [r["total_ms"] for r in rows] == sorted(
        (r["total_ms"] for r in rows), reverse=True)
    share = profiling.idle_share(prof, "cpu")
    assert 0.0 <= share < 1.0
    assert profiling.kernel_table(prof) == []
    assert profiling.idle_share(prof) is None


def test_union_and_timing_contracts():
    from qmcnn_tpu_torch.utils import profiling

    assert profiling._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
