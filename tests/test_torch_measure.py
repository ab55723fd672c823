"""PyTorch port, slice 11: the measurement estimators
(``qmcnn_tpu_torch/ops/observables.py``) and the entry point
(``qmcnn_tpu_torch/measure.py``) against the JAX package.

Each estimator takes the same walkers, thermalized by JAX, and the same
params in both packages (rtol 1e-5, atol 1e-6 near 0; a complex estimate
within rtol of its modulus): a 4x4 J1-J2
square lattice (the ``runs/j1j2_4x4_ground`` snapshot, Marshall on and
off), a 10-site Heisenberg chain, a 2x2-cell kagome lattice (12 sites,
the basis path) and a 3x3 triangular lattice with complex weights (the
chirality). The host functions and the report assembly are copies: equal
to 1e-12 on identical inputs. The whole entry point runs once per package
on the 4x4 snapshot and must agree within the run's statistics.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.ops import observables as jobs
from qmcnn_tpu.ops.cplx import C as JC
from qmcnn_tpu.utils.metrics import binned_stderr as j_binned_stderr
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import measure as tmeasure
from qmcnn_tpu_torch.lattice import Lattice as TLattice
from qmcnn_tpu_torch.ops import observables as tobs
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                            params_from_jax)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
GROUND = os.path.join(RUNS, "j1j2_4x4_ground.csv.params.npz")
KAGOME_EXT = os.path.join(RUNS, "kagome3x3_r3_phasenet_ext.csv")
RTOL, ATOL = 1e-5, 1e-6
M = 32


def meta_yaml(stem: str) -> str:
    with open(os.path.join(RUNS, stem + ".csv.meta.json")) as f:
        return json.load(f)["config"]


#: name -> (config YAML, overrides, snapshot or None)
CASES = {
    "square": (meta_yaml("j1j2_4x4_ground"), (), GROUND),
    "chain": ("""
lattice: {shape: [10]}
model: {channels: [4, 4], complex_params: true, param_scale: 0.2}
hamiltonian: {kind: heisenberg}
sampler: {move: exchange}
""", (), None),
    "kagome": (open(os.path.join(ROOT, "configs", "kagome2x3_heis.yaml")
                    ).read(), ("lattice.shape=[2,2]", "model.channels=[4,4]",
                               "model.param_scale=0.3"), None),
    "triangular": (open(os.path.join(ROOT, "configs", "tri6x6_heis.yaml")
                        ).read(), ("lattice.shape=[3,3]",
                                   "model.channels=[4,4]",
                                   "model.param_scale=0.3"), None),
}


def t(x):
    return torch.from_numpy(np.array(x))


class Case:
    """One lattice in both packages: the JAX vmc, params, walkers and log
    psi after 20 JAX sweeps, and the port's log psi function and params."""

    def __init__(self, name):
        text, over, snapshot = CASES[name]
        over = over + (f"sampler.n_walkers={M}", "run.heartbeat_path=null")
        self.jcfg = jcfg.apply_overrides(jcfg.from_yaml(text), over)
        self.tcfg = tcfg.apply_overrides(tcfg.from_yaml(text), over)
        vmc_j, params_j, self.jlat = jb.build(self.jcfg)
        if snapshot is not None:
            from qmcnn_tpu.utils.transfer import warm_start

            params_j = warm_start(params_j, snapshot)
        state = vmc_j.init_state(jax.random.key(3), M, params_j)
        state = vmc_j.thermalize(state, jax.random.key(4), jnp.arange(M),
                                 n_sweeps=20)
        self.jfn, self.jparams = vmc_j.log_psi_fn, params_j
        self.js, self.jlp = state.walkers.s, state.walkers.log_psi
        vmc_t, _, self.tlat = tb.build(self.tcfg, device="cpu")
        self.tfn = vmc_t.log_psi_fn
        self.tparams = params_from_jax(
            {k: np.asarray(v) for k, v in _flatten(params_j).items()})
        self.ts = t(self.js)
        self.tlp = C(t(self.jlp.re), t(self.jlp.im))


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Case(name)
        return made[name]

    return get


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def close_c(got, want, what="", scale=0.0):
    """A complex estimate within rtol of its modulus (atol near 0): its
    near-zero part (Im of a Hermitian observable) is a cancellation of
    terms as large as the modulus. ``scale``: the size of parts the
    estimate cancels (rtol applies to it too)."""
    g = complex(float(got.re), float(got.im))
    w = complex(float(want.re), float(want.im))
    assert abs(g - w) <= RTOL * (abs(w) + scale) + ATOL, f"{what}: {g} vs {w}"


def test_same_log_psi_on_the_walkers(cases):
    """The fixtures' premise: both packages' models agree on the walkers."""
    for name in CASES:
        c = cases(name)
        with torch.no_grad():
            lp = c.tfn(c.tparams, c.ts)
        close(lp.re, c.jlp.re, f"{name} re")


@pytest.mark.parametrize("name", list(CASES))
def test_diagonal_estimators_match_jax(cases, name):
    """magnetization, magnetization_sq, the staggered moments and
    staggered_magnetization_sq, and szsz_correlation (site grid) or
    szsz_correlation_basis (every lattice; C_00 is the grid's C(r))."""
    c = cases(name)
    s, js = c.ts, c.js
    close(tobs.magnetization(s), jobs.magnetization(js), "m")
    close(tobs.magnetization_sq(s), jobs.magnetization_sq(js), "m2")
    close(tobs.staggered_magnetization_sq(s, c.tlat),
          jobs.staggered_magnetization_sq(js, c.jlat), "mst2")
    for got, want in zip(tobs.staggered_moments(s, c.tlat),
                         jobs.staggered_moments(js, c.jlat)):
        close(got, want, "moments")
    basis = tobs.szsz_correlation_basis(s, c.tlat)
    close(basis, jobs.szsz_correlation_basis(js, c.jlat), "C_ab")
    if c.tlat.basis == 1:
        grid = tobs.szsz_correlation(s, c.tlat)
        close(grid, jobs.szsz_correlation(js, c.jlat), "C(r)")
        close(basis[0, 0], grid, "C_00")
        assert float(grid[0]) == 0.25
    else:
        with pytest.raises(ValueError, match="basis"):
            tobs.szsz_correlation(s, c.tlat)


@pytest.mark.parametrize("direction", [0, 1])
def test_dimer_correlation_matches_jax(cases, direction):
    c = cases("square")
    got = tobs.dimer_correlation(c.ts, c.tlat, direction=direction)
    want = jobs.dimer_correlation(c.js, c.jlat, direction=direction)
    close(got[0], want[0], "C_D")
    close(got[1], want[1], "<d>")


SPIN_SPIN = [("square", True, 1), ("square", True, 5), ("square", False, 1),
             ("square", False, 10), ("chain", True, 1), ("chain", False, 3)]


@pytest.mark.parametrize("name,marshall,disp", SPIN_SPIN)
def test_spin_spin_correlation_matches_jax(cases, name, marshall, disp):
    """The full S_i.S_{i+r} (diagonal + N forwards per walker), with and
    without the Marshall sign, unchunked and in walker chunks of 8."""
    c = cases(name)
    want = jobs.spin_spin_correlation(c.jfn, c.jparams, c.js, c.jlp, c.jlat,
                                      disp, marshall=marshall)
    for chunk in (None, 8):
        got = tobs.spin_spin_correlation(c.tfn, c.tparams, c.ts, c.tlp,
                                         c.tlat, disp, marshall=marshall,
                                         chunk_size=chunk)
        close_c(got, want, f"chunk {chunk}")
    zero = tobs.spin_spin_correlation(c.tfn, c.tparams, c.ts, c.tlp, c.tlat,
                                      0)
    assert float(zero.re) == 0.75 and float(zero.im) == 0.0


@pytest.mark.parametrize("name,connected", [
    ("square", "spin_spin"), ("chain", "spin_spin"),
    ("triangular", "chirality"), ("kagome", "chirality")])
def test_offdiag_chunks_equal_unchunked(cases, name, connected):
    """offdiag_observable in walker chunks (one forward per chunk) equals
    the unchunked pass and JAX's lax.map over the same chunks."""
    c = cases(name)
    if connected == "spin_spin":
        t_fn = tobs.spin_spin_connected(c.tlat, 1, marshall=True)
        j_fn = jobs.spin_spin_connected(c.jlat, 1, marshall=True)
    else:
        t_fn, j_fn = (tobs.chirality_connected(c.tlat),
                      jobs.chirality_connected(c.jlat))
    whole = tobs.offdiag_observable(c.tfn, c.tparams, c.ts, c.tlp, t_fn)
    for chunk in (4, 16):
        got = tobs.offdiag_observable(c.tfn, c.tparams, c.ts, c.tlp, t_fn,
                                      chunk_size=chunk)
        want = jobs.offdiag_observable(c.jfn, c.jparams, c.js, c.jlp, j_fn,
                                       chunk_size=chunk)
        for part in ("re", "im"):
            np.testing.assert_allclose(float(getattr(got, part)),
                                       float(getattr(whole, part)),
                                       rtol=1e-6, atol=1e-7)
        close_c(got, want, f"chunk {chunk}")
    with pytest.raises(ValueError, match="divide"):
        tobs.offdiag_observable(c.tfn, c.tparams, c.ts, c.tlp, t_fn,
                                chunk_size=5)


@pytest.mark.parametrize("name,marshall", [
    ("square", True), ("square", False), ("chain", True), ("kagome", False)])
def test_total_spin_sq_matches_jax(cases, name, marshall):
    """<S^2> over all N(N-1)/2 pairs, in pair chunks that do not divide the
    pair count. Near a singlet <S^2> ~ 0 is M_z^2 + N/2 cancelled by the
    pair sum, so rtol applies to N/2 as well."""
    c = cases(name)
    want = jobs.total_spin_sq(c.jfn, c.jparams, c.js, c.jlp, c.jlat,
                              marshall=marshall, pair_chunk=50)
    got = tobs.total_spin_sq(c.tfn, c.tparams, c.ts, c.tlp, c.tlat,
                             marshall=marshall, pair_chunk=50)
    close_c(got, want, "<S^2>", scale=c.tlat.n_sites / 2)


@pytest.mark.parametrize("name", ["triangular", "kagome"])
def test_scalar_chirality_matches_jax(cases, name):
    """chi = i z over the CCW triangles; the complex triangular model gives
    a chi away from 0."""
    c = cases(name)
    want = jobs.scalar_chirality(c.jfn, c.jparams, c.js, c.jlp, c.jlat)
    got = tobs.scalar_chirality(c.tfn, c.tparams, c.ts, c.tlp, c.tlat,
                                chunk_size=8)
    close_c(got, want, "chi")
    if name == "triangular":
        assert abs(float(want.re)) > 1e-3


def test_estimators_refuse_unsupported_lattices(cases):
    sq, kag = cases("square"), cases("kagome")
    with pytest.raises(ValueError, match="triangles"):
        tobs.chirality_connected(sq.tlat)
    with pytest.raises(ValueError, match="basis"):
        tobs.spin_spin_connected(kag.tlat, 1)
    with pytest.raises(ValueError, match="basis"):
        tobs.dimer_correlation(kag.ts, kag.tlat)
    with pytest.raises(ValueError, match="2D"):
        tobs.dimer_correlation(cases("chain").ts, cases("chain").tlat)


def _lattices(kind):
    from qmcnn_tpu.lattice import Lattice as JLattice

    shape, geometry = {"square": ((4, 6), "hypercubic"),
                       "kagome": ((2, 3), "kagome"),
                       "honeycomb": ((3, 3), "honeycomb")}[kind]
    return (JLattice(shape, geometry=geometry),
            TLattice(shape, geometry=geometry))


@pytest.mark.parametrize("fn", ["structure_factor", "structure_factor_basis",
                                "correlation_length", "binder_cumulant",
                                "dimer_structure_factor",
                                "sector_energy_from_samples"])
def test_host_functions_match_jax(fn):
    """The host-side numpy functions on identical random inputs."""
    rng = np.random.default_rng(11)
    jl, tl = _lattices("square")
    corr = rng.normal(size=tl.n_sites) * 0.1
    corr[0] = 0.25
    if fn == "structure_factor":
        np.testing.assert_allclose(tobs.structure_factor(corr, tl),
                                   jobs.structure_factor(corr, jl),
                                   rtol=1e-12, atol=0)
    elif fn == "structure_factor_basis":
        for kind, phases in (("kagome", None), ("honeycomb", (1.0, -1.0))):
            jlb, tlb = _lattices(kind)
            cb = rng.normal(size=tlb.basis ** 2 * int(np.prod(tlb.shape)))
            np.testing.assert_allclose(
                tobs.structure_factor_basis(cb, tlb, phases=phases),
                jobs.structure_factor_basis(cb, jlb, phases=phases),
                rtol=1e-12, atol=0)
    elif fn == "correlation_length":
        stag = (-1.0) ** tl.coords.sum(-1) * np.exp(-tl.coords.sum(-1) / 3)
        for c in (corr, stag, np.full(tl.n_sites, 0.01)):
            for q in (None, (2, 3)):
                assert (tobs.correlation_length(c, tl, q_peak=q)
                        == pytest.approx(jobs.correlation_length(
                            c, jl, q_peak=q), rel=1e-12))
    elif fn == "binder_cumulant":
        for m2, m4 in ((0.05, 0.004), (0.0, 0.0), (0.3, 0.2)):
            got = tobs.binder_cumulant(m2, m4)
            want = jobs.binder_cumulant(m2, m4)
            assert got == want or (np.isnan(got) and np.isnan(want))
    elif fn == "dimer_structure_factor":
        np.testing.assert_allclose(
            tobs.dimer_structure_factor(corr, -0.1, tl),
            jobs.dimer_structure_factor(corr, -0.1, jl), rtol=1e-12, atol=0)
    else:
        for m in (3, 64):
            num = rng.normal(size=(2, m)).astype(np.float32)
            den = (1.0 + 0.3 * rng.normal(size=(2, m))).astype(np.float32)
            got = tobs.sector_energy_from_samples(C(*num), C(*den))
            want = jobs.sector_energy_from_samples(JC(*num), JC(*den))
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def jax_report(traces, jl):
    """JAX ``measure``'s report arithmetic (qmcnn_tpu/measure.py, the
    accumulators and the report block) through its host functions."""
    n = jl.n_sites
    e_trace = list(traces["energy"])
    k = len(e_trace)
    corr_acc = np.zeros(len(traces["corr"][0]))
    dimer_acc = np.zeros(n)
    for i in range(k):
        corr_acc += np.asarray(traces["corr"][i])
        dimer_acc += np.asarray(traces["dimer_corr"][i])
    corr = corr_acc / k
    rep = {"step": 7, "ema": True, "energy": float(np.mean(e_trace)),
           "energy_err": j_binned_stderr(np.asarray(e_trace)),
           "energy_per_site": float(np.mean(e_trace)) / n,
           "magnetization": float(np.mean(traces["magnetization"])),
           "staggered_m2": float(np.mean(traces["mst2"])),
           "staggered_m4": float(np.mean(traces["mst4"])),
           "binder_cumulant": jobs.binder_cumulant(
               float(np.mean(traces["mst2"])), float(np.mean(traces["mst4"]))),
           "szsz_corr": corr.tolist()}
    if jl.basis == 1:
        sq = jobs.structure_factor(corr, jl)
        rep.update(spin_spin_nn=float(np.mean(traces["ss_nn"])),
                   structure_factor_peak=float(sq.max()),
                   structure_factor_peak_q_index=int(sq.argmax()),
                   correlation_length=jobs.correlation_length(corr, jl))
        d_mean = float(np.mean(traces["dimer_mean"]))
        sd = jobs.dimer_structure_factor(dimer_acc / k, d_mean, jl)
        rep.update(dimer_mean=d_mean,
                   dimer_sf_pi0=float(sd[jl.shape[0] // 2, 0]),
                   dimer_sf_peak=float(sd.max()),
                   dimer_sf_peak_q_index=int(sd.argmax()))
        num = np.concatenate(traces["sector_num"])
        den = np.concatenate(traces["sector_den"])
        e_q, e_err, w_q = jobs.sector_energy_from_samples(
            JC(num.real, num.imag), JC(den.real, den.imag))
        rep.update(sector_momentum=[2, 3], sector_energy=e_q,
                   sector_energy_err=e_err, sector_weight=w_q,
                   sector_gap=e_q - float(np.mean(e_trace)),
                   total_spin_sq=traces["total_spin_sq"])
    else:
        sq = jobs.structure_factor_basis(corr, jl)
        rep.update(structure_factor_peak=float(sq.max()),
                   structure_factor_peak_q_index=int(sq.argmax()))
        if jl.is_bipartite_compatible:
            sq_st = jobs.structure_factor_basis(
                corr, jl, phases=(-1.0) ** np.arange(jl.basis))
            rep["neel_sf_q0"] = float(sq_st.reshape(-1)[0])
        rep.update(scalar_chirality=float(np.mean(traces["chirality"])),
                   scalar_chirality_err=j_binned_stderr(
                       np.asarray(traces["chirality"])))
    return rep


@pytest.mark.parametrize("kind", ["square", "kagome", "honeycomb"])
def test_report_assembly_matches_jax(kind):
    """assemble_report on identical float32 traces equals JAX's report
    arithmetic: every key, values to 1e-12 (square: dimer, sector, <S^2>;
    the basis lattices: chirality, and honeycomb's neel_sf_q0)."""
    rng = np.random.default_rng(5)
    jl, tl = _lattices(kind)
    k, n = 40, tl.n_sites
    width = n if tl.basis == 1 else tl.basis * n

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    traces = {"energy": [float(-10 + x) for x in f32(k)],
              "magnetization": [0.0] * k,
              "mst2": [float(abs(x)) for x in f32(k)],
              "mst4": [float(x * x) for x in f32(k)],
              "corr": [0.1 * f32(width) for _ in range(k)],
              "ss_nn": [float(x) for x in f32(k)],
              "dimer_corr": [0.1 * f32(n) for _ in range(k)],
              "dimer_mean": [float(x) for x in f32(k)]}
    if tl.basis == 1:
        traces.update(dimer=True, sector_momentum=[2, 3],
                      sector_num=[f32(8) + 1j * f32(8) for _ in range(k)],
                      sector_den=[1 + f32(8) + 1j * f32(8) for _ in range(k)],
                      total_spin_sq=0.123)
    else:
        traces["chirality"] = [float(x) for x in f32(k)]
    got = tmeasure.assemble_report(traces, tl, step=7, ema=True)
    want = jax_report(traces, jl)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(w, np.float64), rtol=1e-12,
                                   atol=0, err_msg=key)


def _cfg_pair(stem, *over):
    text = meta_yaml(stem)
    over = ("run.heartbeat_path=null",) + over
    return (jcfg.apply_overrides(jcfg.from_yaml(text), over),
            tcfg.apply_overrides(tcfg.from_yaml(text), over))


def test_measure_matches_jax(capsys):
    """The whole entry point, one run per package, on the 4x4 J1-J2 ground
    snapshot (M = 256, 4 samples, --total-spin --dimer): the same keys;
    the energy within max(5 sigma, 2e-3 N); both magnetizations exactly 0;
    the S(q) peak at (pi, pi), index 10, in both; staggered_m2 within 10%,
    spin_spin_nn within 0.05 and <S^2> within 0.2."""
    from qmcnn_tpu.measure import measure as jmeasure

    cfg_j, cfg_t = _cfg_pair("j1j2_4x4_ground", "sampler.n_walkers=256")
    kw = dict(n_samples=4, total_spin=True, dimer=True)
    want = jmeasure(cfg_j, GROUND, **kw)
    got = tmeasure.measure(cfg_t, GROUND, device="cpu", **kw)
    capsys.readouterr()
    assert sorted(got) == sorted(want)
    sigma = np.hypot(got["energy_err"], want["energy_err"])
    assert abs(got["energy"] - want["energy"]) <= max(5 * sigma, 2e-3 * 16)
    assert got["magnetization"] == want["magnetization"] == 0.0
    assert (got["structure_factor_peak_q_index"]
            == want["structure_factor_peak_q_index"] == 10)
    assert got["staggered_m2"] == pytest.approx(want["staggered_m2"],
                                                rel=0.1)
    assert abs(got["spin_spin_nn"] - want["spin_spin_nn"]) < 0.05
    assert abs(got["total_spin_sq"] - want["total_spin_sq"]) < 0.2
    assert got["step"] == want["step"] == 0
    assert got["ema"] is want["ema"] is False
    assert len(got["szsz_corr"]) == 16


def test_measure_ema_reads_the_average(capsys):
    """--ema on <csv>.params.npz measures <csv>.ema.npz: the report equals
    the plain measurement of the .ema.npz path key for key (but "ema"), and
    differs from the plain measurement of the .params.npz."""
    _, cfg = _cfg_pair("kagome3x3_r3_phasenet_ext", "sampler.n_walkers=64")
    kw = dict(n_samples=2, device="cpu")
    ema = tmeasure.measure(cfg, KAGOME_EXT + ".params.npz", use_ema=True,
                           **kw)
    assert "(ema)" in capsys.readouterr().out
    ema_path = tmeasure.measure(cfg, KAGOME_EXT + ".ema.npz", **kw)
    last = tmeasure.measure(cfg, KAGOME_EXT + ".params.npz", **kw)
    assert ema["ema"] is True and ema_path["ema"] is last["ema"] is False
    assert sorted(ema) == sorted(ema_path)
    for key in ema:
        if key != "ema":
            assert ema[key] == ema_path[key], key
    assert ema["energy"] != last["energy"]
    assert ema["szsz_corr"] != last["szsz_corr"]


def _small_cfg(*over):
    return tcfg.apply_overrides(tcfg.from_yaml("""
lattice: {shape: [4, 4]}
model: {channels: [3, 3]}
hamiltonian: {kind: heisenberg}
sampler: {n_walkers: 16, move: exchange, n_therm_sweeps: 2}
optimizer: {kind: sgd, lr: 0.05}
run: {n_steps: 2, log_every: 1, ckpt_every: 1}
"""), over)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step run of the port with a checkpoint every step and the EMA
    on, and one without the EMA."""
    from qmcnn_tpu_torch.train import train
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

    base = tmp_path_factory.mktemp("measure_ckpt")
    out = {}
    for name, over in (("ema", ("optimizer.ema_decay=0.8",)), ("plain", ())):
        d = str(base / name)
        cfg = _small_cfg(*over, f"run.csv_path={base / name}.csv")
        train(cfg, device="cpu", ckpt_manager=CheckpointManager(d))
        out[name] = (cfg, d)
    return out


def test_restore_full_state_and_fallback(trained, capsys):
    """A port checkpoint restores the whole state (its step in the
    report); at another walker count it falls back to the params with
    JAX's line, reporting the checkpoint's latest step; with --ema the
    checkpoint's EMA is measured."""
    cfg, d = trained["ema"]
    kw = dict(n_samples=2, sweeps_between=1, therm_sweeps=2, device="cpu")
    full = tmeasure.measure(cfg, d, **kw)
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    assert full["step"] == 2 and full["ema"] is False
    assert full["magnetization"] == 0.0
    other = tcfg.apply_overrides(cfg, ("sampler.n_walkers=32",))
    fell = tmeasure.measure(other, d, **kw)
    out = capsys.readouterr().out
    assert ("full-state restore failed (ValueError); restoring params only "
            "and re-thermalizing fresh walkers") in out
    assert fell["step"] == 2 and np.isfinite(fell["energy"])
    ema = tmeasure.measure(cfg, d, use_ema=True, **kw)
    assert "measuring the EMA (Polyak-averaged) parameters" in (
        capsys.readouterr().out)
    assert ema["ema"] is True and ema["energy"] != full["energy"]
    ema_fell = tmeasure.measure(other, d, use_ema=True, **kw)
    assert "(ema)" in capsys.readouterr().out and ema_fell["ema"] is True


@pytest.mark.parametrize("where", ["npz", "checkpoint", "fallback"])
def test_ema_without_average_raises(trained, where, capsys):
    """--ema with nothing averaged to read raises ValueError: a snapshot
    with no sibling .ema.npz, a checkpoint without EMA state (restored
    whole, or through the params-only fallback)."""
    cfg, d = trained["plain"]
    kw = dict(n_samples=1, therm_sweeps=1, device="cpu", use_ema=True)
    if where == "npz":
        assert not os.path.exists(GROUND.replace(".params.", ".ema."))
        _, cfg = _cfg_pair("j1j2_4x4_ground", "sampler.n_walkers=16")
        with pytest.raises(ValueError, match="EMA"):
            tmeasure.measure(cfg, GROUND, **kw)
    elif where == "checkpoint":
        with pytest.raises(ValueError, match="ema_decay"):
            tmeasure.measure(_small_cfg("optimizer.ema_decay=0.8"), d, **kw)
    else:
        with pytest.raises(ValueError, match="EMA"):
            tmeasure.measure(tmeasure.cfglib.apply_overrides(
                cfg, ("sampler.n_walkers=32",)), d, **kw)
    with pytest.raises(ValueError, match="EMA"):
        load_checkpoint_params(d, field="ema")


#: the report's keys for a square lattice without flags
BASE_KEYS = {"energy", "energy_err", "energy_per_site", "magnetization",
             "staggered_m2", "staggered_m4", "binder_cumulant", "szsz_corr",
             "spin_spin_nn", "structure_factor_peak",
             "structure_factor_peak_q_index", "correlation_length", "step",
             "ema"}
#: the keys each once-refused option adds (JAX measure's)
FLAG_KEYS = {
    "fidelity_ckpt": {"fidelity_vs_ckpt"},
    "lanczos": {"lanczos_valid", "lanczos_alpha", "lanczos_energy",
                "lanczos_energy_per_site", "lanczos_gain_per_site",
                "lanczos_energy_err", "lanczos_energy_per_site_err"},
    "renyi2_region": {"renyi2_swap_mean", "renyi2_swap_err",
                      "renyi2_entropy", "renyi2_region_size"},
    "sma": {"sma_transverse_corr", "sma_first_moment", "sma_omega",
            "sma_gap_bound", "sma_gap_q_index"},
    "world": set(),
}


@pytest.mark.parametrize("flag", list(FLAG_KEYS))
def test_once_refused_options_report_their_keys(flag, trained, tmp_path,
                                                capsys):
    """Each option that once raised NotImplementedError measures the 2-step
    checkpoint and reports JAX's keys for it, finite: the fidelity with
    the EMA run's checkpoint, the Lanczos step over 4 samples (its
    jackknife keys), two Renyi-2 regions (lists of 2), the SMA (C_t at
    the two NN displacements, 16 omegas); and ``world``: the CLI in 2
    gloo ranks under torchrun (run.distributed=true), whose rank 0 alone
    prints the one report."""
    cfg, d = trained["plain"]
    if flag == "world":
        yaml_path = tmp_path / "small.yaml"
        yaml_path.write_text(tmeasure.cfglib.to_yaml(cfg))
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "qmcnn_tpu_torch.measure",
             "--device", "cpu", "--config", str(yaml_path), "--ckpt-dir", d,
             "--n-samples", "2", "--override", "run.distributed=true"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert run.returncode == 0, run.stdout + run.stderr
        out = run.stdout
        assert out.count("szsz_corr:") == 1
        assert out.count("restored checkpoint at step 2") == 1
        report = json.loads(out[out.index("{"):out.index("szsz_corr:")])
        report["szsz_corr"] = None
    else:
        kw = {"fidelity_ckpt": dict(fidelity_ckpt=trained["ema"][1]),
              "lanczos": dict(lanczos=True),
              "renyi2_region": dict(renyi2_region=["half", "0:3"]),
              "sma": dict(sma=True)}[flag]
        report = tmeasure.measure(cfg, d, n_samples=4, sweeps_between=1,
                                  therm_sweeps=2, device="cpu", **kw)
        capsys.readouterr()
    assert set(report) == BASE_KEYS | FLAG_KEYS[flag]
    for key in FLAG_KEYS[flag]:
        values = report[key]
        if isinstance(values, dict):
            values = list(values.values())
        values = [v for v in np.atleast_1d(values) if v is not None]
        assert values and np.isfinite(np.asarray(values, np.float64)).all()
    if flag == "renyi2_region":
        assert report["renyi2_region_size"] == [8, 3]
    if flag == "sma":
        assert sorted(report["sma_transverse_corr"]) == ["1", "4"]
        assert len(report["sma_omega"]) == 16


def test_cli_prints_the_report(tmp_path, capsys):
    """main --device cpu prints the JSON report (every key of JAX's
    default report for a square lattice) and the correlation line."""
    yaml_path = tmp_path / "g4.yaml"
    yaml_path.write_text(meta_yaml("j1j2_4x4_ground"))
    tmeasure.main(["--config", str(yaml_path), "--ckpt-dir", GROUND,
                   "--device", "cpu", "--n-samples", "2",
                   "--override", "sampler.n_walkers=32",
                   "--override", "run.heartbeat_path=null"])
    out = capsys.readouterr().out
    body = out[out.index("{"):out.index("szsz_corr:")]
    report = json.loads(body)
    assert {"energy", "energy_err", "energy_per_site", "magnetization",
            "staggered_m2", "staggered_m4", "binder_cumulant",
            "spin_spin_nn", "structure_factor_peak",
            "structure_factor_peak_q_index", "correlation_length", "step",
            "ema"} == set(report)
    assert "szsz_corr: [" in out


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    """Without --device the CLI runs on CUDA, and raises with no card
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yaml_path = tmp_path / "g4.yaml"
    yaml_path.write_text(meta_yaml("j1j2_4x4_ground"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmeasure.main(["--config", str(yaml_path), "--ckpt-dir", GROUND])
