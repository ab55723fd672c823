"""PyTorch port, slice 13: the dynamics entry point
(``qmcnn_tpu_torch/evolve.py``), the quench spectroscopy
(``qmcnn_tpu_torch/ops/spectroscopy.py``) and the analysis CLI
(``qmcnn_tpu_torch/analyze.py``) against the JAX package.

``evolve()`` runs in both packages from the same params (JAX's init
written as a ``.params.npz`` snapshot, read by both through
``init_from``) on the JAX tests' own systems (tests/test_tdvp.py: the
untied RBM on the 6-site TFIM chain, real for imaginary time, complex for
real time), 5 full-sum steps with ``--corr-csv``: the same CSV header,
column for column, and every column but ``wall_time`` and
``steps_per_sec`` within rtol 1e-4 (``energy_im``, a cancellation, within
1e-4 of |energy_re|; epsilon^2 and the residual within 1e-5 absolute);
the correlation CSV within 1e-6 (its 8 printed digits). The MC mode gives
finite rows under JAX's header, and a diverging run halts. The
spectroscopy and analysis functions are host numpy copies: equal to
1e-12 on the committed CSVs.
"""
import contextlib
import csv
import io
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import analyze as jan
from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.evolve import evolve as j_evolve
from qmcnn_tpu.ops import spectroscopy as jsp
from qmcnn_tpu.utils import metrics as jmetrics
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import analyze as tan
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import evolve as tev
from qmcnn_tpu_torch.ops import spectroscopy as tsp
from qmcnn_tpu_torch.utils import metrics as tmetrics
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
CHAIN12_CORR = os.path.join(RUNS, "tvmc_chain12_corr.csv")
TRAIN_CSVS = [os.path.join(RUNS, f) for f in (
    "ab_cnn_float32.csv", "ab_cnn_bfloat16.csv", "heis10x10_sma.csv",
    "j1j2_4x4_ground.csv", "tfim12_h2.csv")]
SKIP_COLS = ("wall_time", "steps_per_sec")


def rbm_yaml(complex_params: bool, alpha: int) -> str:
    """The JAX tests' system (tests/test_tdvp.py): an untied RBM on the
    6-site TFIM chain at h = 1."""
    return f"""
lattice: {{shape: [6]}}
model: {{kind: rbm, rbm_alpha: {alpha}, rbm_tie_translations: false,
         param_scale: 0.05, complex_params: {str(complex_params).lower()}}}
hamiltonian: {{kind: tfim, h: 1.0}}
sampler: {{n_walkers: 32, n_therm_sweeps: 4}}
run: {{seed: 1, chunk_size: null}}
"""


def configs(text: str, over=()):
    return (jcfg.apply_overrides(jcfg.from_yaml(text), tuple(over)),
            tcfg.apply_overrides(tcfg.from_yaml(text), tuple(over)))


def jax_snapshot(cfg_j, path: str) -> str:
    """JAX's fresh init of ``cfg_j``'s model as a .params.npz snapshot."""
    lat = jb.build_lattice(cfg_j)
    model = jb.build_model(cfg_j, lat)
    params = model.init(jax.random.key(cfg_j.run.seed),
                        jnp.ones((1, lat.n_sites), jnp.float32))
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(params).items()})
    return path


def read_rows(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


#: (mode, integrator, solver, complex RBM, alpha, dt)
RUNS_FULLSUM = [("imag", "heun", "dense", False, 3, 0.05),
                ("imag", "euler", "minsr", False, 3, 0.05),
                ("real", "heun", "minsr", True, 2, 0.01),
                ("real", "euler", "dense", True, 2, 0.01)]


@pytest.mark.parametrize("mode, integrator, solver, cplx, alpha, dt",
                         RUNS_FULLSUM)
def test_evolve_fullsum_matches_jax(tmp_path, mode, integrator, solver,
                                    cplx, alpha, dt):
    cfg_j, cfg_t = configs(rbm_yaml(cplx, alpha))
    snap = jax_snapshot(cfg_j, str(tmp_path / "init.params.npz"))
    kw = dict(mode=mode, dt=dt, n_steps=5, solver=solver,
              integrator=integrator, sampling="fullsum", init_from=snap,
              log_every=1)
    out = {}
    for name, fn, extra in (("jax", j_evolve, {}),
                            ("port", tev.evolve, {"device": "cpu"})):
        csv_path = str(tmp_path / f"{name}.csv")
        corr = str(tmp_path / f"{name}_corr.csv")
        quiet(fn, cfg_j if name == "jax" else cfg_t, csv_path=csv_path,
              corr_csv=corr, **kw, **extra)
        out[name] = (read_rows(csv_path), read_rows(corr))
    (hj, rj), (chj, cj) = out["jax"]
    (ht, rt), (cht, ct) = out["port"]
    assert ht == hj and cht == chj
    assert ht[-3:] == ["stag_m2", "sx", "szsz_nn"]
    assert rt.shape == rj.shape == (5, len(hj))
    e_scale = np.abs(rj[:, hj.index("energy_re")]).max()
    for i, col in enumerate(hj):
        if col in SKIP_COLS:
            continue
        if col == "energy_im":
            atol, rtol = 1e-4 * e_scale, 0.0
        elif col in ("tdvp_error", "solver_residual"):
            atol, rtol = 1e-5, 0.0
        else:
            atol, rtol = 1e-6, 1e-4
        np.testing.assert_allclose(rt[:, i], rj[:, i], rtol=rtol, atol=atol,
                                   err_msg=col)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1.01e-6)
    np.testing.assert_allclose(ct[:, 1], 0.25, atol=1e-6)  # C(0) = 1/4


def test_evolve_mc_rows_and_header(tmp_path):
    """MC mode (flip moves on the RBM chain, Heun reusing the samples):
    finite rows under JAX's header, and the energy lowered."""
    cfg_j, cfg_t = configs(rbm_yaml(False, 2))
    kw = dict(mode="imag", dt=0.05, n_steps=4, solver="minsr",
              integrator="heun", sampling="mc", log_every=2)
    quiet(j_evolve, cfg_j, csv_path=str(tmp_path / "j.csv"), **kw)
    _, logger = quiet(tev.evolve, cfg_t, csv_path=str(tmp_path / "t.csv"),
                      device="cpu", **kw)
    hj, _ = read_rows(str(tmp_path / "j.csv"))
    ht, rt = read_rows(str(tmp_path / "t.csv"))
    assert ht == hj
    assert rt.shape == (2, len(ht)) and np.isfinite(rt).all()
    assert list(rt[:, ht.index("step")]) == [2, 4]
    assert logger.history["energy_re"][-1] < -6.0  # E of |+x>^6 is -6


def test_evolve_mc_is_deterministic():
    """MC mode's draws are keyed streams of the seed (the walkers from
    prng_key(seed + 1), thermalized from prng_key(seed + 2), each step's
    sweeps from fold_in(prng_key(seed + 3), step)): a second run is
    identical."""
    _, cfg = configs(rbm_yaml(False, 2))
    kw = dict(mode="imag", dt=0.05, n_steps=2, solver="minsr",
              integrator="euler", sampling="mc", device="cpu")
    p1, l1 = quiet(tev.evolve, cfg, **kw)
    p2, l2 = quiet(tev.evolve, cfg, **kw)
    assert l1.history["energy_re"] == l2.history["energy_re"]
    for k in p1:
        assert torch.equal(p1[k], p2[k])


def test_evolve_halts_on_nonfinite_state(tmp_path):
    """Real-time Euler at an absurd dt diverges within a few steps: the
    trajectory stops at the first non-finite state, whose row is the
    last one written (tests/test_tdvp.py's case)."""
    _, cfg = configs(rbm_yaml(True, 2))
    csv_path = str(tmp_path / "blowup.csv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tev.evolve(cfg, mode="real", dt=50.0, n_steps=200, solver="dense",
                   integrator="euler", sampling="fullsum", csv_path=csv_path,
                   log_every=1, device="cpu")
    head, rows = read_rows(csv_path)
    assert rows.shape[0] < 200, "trajectory was not halted"
    assert "halting the trajectory" in buf.getvalue()
    e = rows[:, head.index("energy_re")]
    assert np.isfinite(e[:-1]).all() or rows.shape[0] <= 2


def test_evolve_refuses_real_mode_on_real_ansatz(tmp_path):
    _, cfg = configs(rbm_yaml(False, 2))
    with pytest.raises(ValueError, match="complex_params"):
        tev.evolve(cfg, mode="real", dt=0.01, n_steps=5, solver="dense",
                   integrator="euler", sampling="fullsum", device="cpu",
                   csv_path=str(tmp_path / "x.csv"))
    # imaginary time on the same real ansatz remains legal
    quiet(tev.evolve, cfg, mode="imag", dt=0.05, n_steps=2, solver="dense",
          integrator="euler", sampling="fullsum", device="cpu",
          csv_path=str(tmp_path / "ok.csv"))
    _, lz = configs(rbm_yaml(True, 2), ("model.lanczos_alpha=0.1",))
    with pytest.raises(ValueError, match="lanczos_alpha"):
        tev.evolve(lz, mode="real", n_steps=1, device="cpu")
    with pytest.raises(ValueError, match="unknown sampling"):
        tev.evolve(cfg, mode="imag", n_steps=1, sampling="exact",
                   device="cpu")


def test_init_zero_scale():
    """--init-zero: exact zeros at --init-perturb 0; otherwise Gaussian
    noise whose std over every parameter is within 20% of the perturb
    (JAX's draws cannot be reproduced, so the scale is what is held)."""
    _, cfg = configs(rbm_yaml(True, 4))
    from qmcnn_tpu_torch.builder import build_lattice, build_model

    model = build_model(cfg, build_lattice(cfg))
    zero = tev.initial_params(cfg, model, "cpu", init_zero=True,
                              init_perturb=0.0)
    assert all(bool((v == 0).all()) for v in zero.values())
    noisy = tev.initial_params(cfg, model, "cpu", init_zero=True,
                               init_perturb=1e-3)
    flat = torch.cat([v.reshape(-1) for v in noisy.values()])
    assert flat.numel() > 100
    assert abs(float(flat.std()) / 1e-3 - 1.0) < 0.2
    again = tev.initial_params(cfg, model, "cpu", init_zero=True,
                               init_perturb=1e-3)
    assert all(torch.equal(noisy[k], again[k]) for k in noisy)
    p, _ = quiet(tev.evolve, cfg, mode="imag", n_steps=0, init_zero=True,
                 init_perturb=0.0, device="cpu")
    assert all(bool((v == 0).all()) for v in p.values())


def test_evolve_cli(tmp_path):
    """``python -m qmcnn_tpu_torch.evolve`` parses every JAX flag plus
    --device and writes both CSVs."""
    cfg_path = tmp_path / "rbm.yaml"
    cfg_path.write_text(rbm_yaml(True, 2))
    csv_path, corr = tmp_path / "e.csv", tmp_path / "c.csv"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tev.main(["--config", str(cfg_path), "--override", "hamiltonian.h=2.0",
                  "--mode", "real", "--dt", "0.01", "--steps", "3",
                  "--solver", "dense", "--diag-shift", "1e-3",
                  "--integrator", "heun", "--sampling", "fullsum",
                  "--init-zero", "--init-perturb", "1e-2", "--sector", "free",
                  "--csv", str(csv_path), "--corr-csv", str(corr),
                  "--log-every", "2", "--device", "cpu", "--timings"])
    out = buf.getvalue()
    assert "=== evolve" in out and '"timings_s"' in out
    _, rows = read_rows(str(csv_path))
    _, crows = read_rows(str(corr))
    assert list(rows[:, 0]) == [2, 3] and crows.shape == (2, 7)
    np.testing.assert_allclose(crows[:, 0], [0.02, 0.03])


# ---------------------------------------------------------------------------
# spectroscopy and analyze: host numpy copies, equal on the committed CSVs
# ---------------------------------------------------------------------------

def test_metrics_autocorr_time_is_jax():
    for path in TRAIN_CSVS:
        e = jan.read_csv(path)["energy_re"]
        assert tmetrics.integrated_autocorr_time(e) == \
            jmetrics.integrated_autocorr_time(e)
    assert tmetrics.integrated_autocorr_time(np.ones(10)) == 1.0
    assert tmetrics.integrated_autocorr_time(np.arange(3.0)) == 1.0


def test_read_corr_csv_truncates_chain12_with_warning():
    """The chain-12 quench went non-finite at t = 1.815: both packages keep
    the 362 finite rows and warn."""
    with pytest.warns(UserWarning, match="non-finite correlation row"):
        tj, cj = jsp.read_corr_csv(CHAIN12_CORR)
    with pytest.warns(UserWarning, match="non-finite correlation row") as w:
        tt, ct = tsp.read_corr_csv(CHAIN12_CORR)
    assert "keeping the 362 rows" in str(w[0].message)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(ct, cj)
    assert ct.shape == (362, 12)


@pytest.mark.parametrize("rows", [64, 200, 362])
def test_spectroscopy_functions_match_jax(rows):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        times, corr = tsp.read_corr_csv(CHAIN12_CORR)
    times, corr = times[:rows], corr[:rows]
    sj = jsp.structure_factor_qt(corr, (12,))
    st = tsp.structure_factor_qt(corr, (12,))
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-12)
    qj = jsp.quench_spectrum(times, sj, pad=4)
    qt = tsp.quench_spectrum(times, st, pad=4)
    assert sorted(qt) == sorted(qj)
    for k in qj:
        np.testing.assert_allclose(qt[k], qj[k], rtol=1e-12, atol=1e-12)
    dj = jsp.dominant_frequencies(times, corr, (12,))
    dt = tsp.dominant_frequencies(times, corr, (12,))
    assert [d["k"] for d in dt] == [d["k"] for d in dj]
    for a, b in zip(dt, dj):
        assert a["q"] == b["q"]
        assert abs(a["omega"] - b["omega"]) <= 1e-12 * abs(b["omega"])
        assert abs(a["power"] - b["power"]) <= 1e-12 * abs(b["power"])


def test_spectroscopy_refusals_match_jax(tmp_path):
    """Short, non-uniform and non-finite-from-the-start inputs raise in
    both, and a 2-D torus whose shape does not match the sites."""
    times = np.arange(6) * 0.1
    for mod in (jsp, tsp):
        with pytest.raises(ValueError, match=">= 8"):
            mod.quench_spectrum(times, np.zeros((6, 4)))
        bad = np.r_[np.arange(10) * 0.1, 5.0, 7.0]
        with pytest.raises(ValueError, match="not uniform"):
            mod.quench_spectrum(bad, np.zeros((12, 4)))
        with pytest.raises(ValueError, match="does not match"):
            mod.structure_factor_qt(np.zeros((3, 12)), (3, 3))
    path = tmp_path / "nan.csv"
    path.write_text("t,c0,c1\n0.1,nan,0.1\n0.2,0.25,0.1\n")
    for mod in (jsp, tsp):
        with pytest.raises(ValueError, match="first row"):
            mod.read_corr_csv(str(path))


def test_analyze_functions_match_jax():
    for path in TRAIN_CSVS:
        cj, ct = jan.read_csv(path), tan.read_csv(path)
        assert sorted(ct) == sorted(cj)
        for k in cj:
            np.testing.assert_array_equal(ct[k], cj[k])
        np.testing.assert_array_equal(tan._excursion_mask(ct["energy_re"]),
                                      jan._excursion_mask(cj["energy_re"]))
        for robust in (False, True):
            for n_sites in (None, 100):
                rj = jan.analyze(cj, tail=0.5, n_sites=n_sites, robust=robust)
                rt = tan.analyze(ct, tail=0.5, n_sites=n_sites, robust=robust)
                assert sorted(rt) == sorted(rj)
                for k in rj:
                    assert abs(rt[k] - rj[k]) <= 1e-12 * max(abs(rj[k]), 1)
    res_j = [jan.analyze(jan.read_csv(p), robust=True) for p in TRAIN_CSVS[:3]]
    res_t = [tan.analyze(tan.read_csv(p), robust=True) for p in TRAIN_CSVS[:3]]
    for n in (2, 3):  # the exactly determined line, then the fit
        xj = jan.extrapolate_zero_variance(res_j[:n])
        xt = tan.extrapolate_zero_variance(res_t[:n])
        assert sorted(xt) == sorted(xj)
        for k in xj:
            assert abs(xt[k] - xj[k]) <= 1e-12 * max(abs(xj[k]), 1)
    with pytest.raises(ValueError, match=">= 2 CSVs"):
        tan.extrapolate_zero_variance(res_t[:1])


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ret = main(argv)
    return ret, buf.getvalue()


@pytest.mark.parametrize("argv", [
    [CHAIN12_CORR, "--quench-spectrum", "--shape", "12"],
    [CHAIN12_CORR, "--quench-spectrum", "--pad", "4", "--top", "3"],
    TRAIN_CSVS[:3] + ["--extrapolate", "--n-sites", "100"],
    TRAIN_CSVS[:2] + ["--extrapolate", "--no-robust-tail"],
    [TRAIN_CSVS[3], "--tail", "0.5", "--n-sites", "16"],
])
def test_analyze_cli_matches_jax(argv):
    """The CLI prints the same text and returns the same tables."""
    rj, oj = _cli(jan.main, argv)
    rt, ot = _cli(tan.main, argv)
    assert ot == oj and ot
    assert repr(rt) == repr(rj)


@pytest.mark.parametrize("kind, sampling, integrator, chunk", [
    ("tfim", "fullsum", "heun", "null"), ("tfim", "fullsum", "heun", "16"),
    ("tfim", "fullsum", "euler", "16"), ("heisenberg", "fullsum", "heun", "5"),
    ("tfim", "mc", "heun", "8"), ("tfim", "mc", "euler", "null"),
    ("heisenberg", "mc", "heun", "null")])
def test_dynamics_expected_counts_every_forward(kind, sampling, integrator,
                                                chunk, monkeypatch):
    """``chip_smoke.dynamics_expected``, which holds the dynamics legs'
    kernel launches exactly on the card, equals the evaluation forwards
    evolve() calls on the CPU (one call per launch there; the torch sweep
    calls one per proposal): full sum (the S^z = 0 sector for the
    Heisenberg chain) and MC, Heun and Euler, unchunked and in E_loc
    chunks."""
    import chip_smoke
    from qmcnn_tpu_torch.builder import build_lattice

    calls = []
    real = tev.evaluation_forward

    def counting(cfg, lattice, device, log_psi_fn):
        fn = real(cfg, lattice, device, log_psi_fn)

        def forward(params, s):
            calls.append(s.shape[0])
            return fn(params, s)

        return forward

    monkeypatch.setattr(tev, "evaluation_forward", counting)
    _, cfg = configs(rbm_yaml(False, 2), (
        f"hamiltonian.kind={kind}", f"run.chunk_size={chunk}",
        "sampler.move=" + ("flip" if kind == "tfim" else "exchange")))
    quiet(tev.evolve, cfg, mode="imag", dt=0.02, n_steps=2, solver="minsr",
          integrator=integrator, sampling=sampling, device="cpu")
    want = chip_smoke.dynamics_expected(
        cfg, build_lattice(cfg), sampling, integrator, 2, fused_sweep=False,
        sector_sz0=kind == "heisenberg")
    assert len(calls) == want
    if chunk != "null":
        assert int(chunk) * 6 in calls  # an E_loc chunk's batch
