"""PyTorch port, slice 12: the rest of measurement's flags against the JAX
package: the Renyi-2 swap estimators and ``parse_region`` (``--renyi2``),
``ops/sma.py`` (``--sma``), ``ops/fidelity.py`` (``--fidelity-ckpt``) and
the Lanczos moments of ``ops/lanczos.py`` (``--lanczos-step``).

Device estimators take the same walkers (thermalized by JAX), log psi and
params in both packages: rtol 1e-5 (atol 1e-6 near 0). Host functions
and the report blocks take identical inputs: exact, or 1e-12. The whole
entry point runs once per package with every new flag on the 4x4 J1-J2
ground snapshot, and with the Lanczos step on a fresh 10-site chain
(where the step is not noise-dominated), and must agree within the runs'
statistics.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.measure import measure as jmeasure
from qmcnn_tpu.measure import parse_region as j_parse_region
from qmcnn_tpu.ops import lanczos as jlz
from qmcnn_tpu.ops import observables as jobs
from qmcnn_tpu.ops import sma as jsma
from qmcnn_tpu.ops.cplx import C as JC
from qmcnn_tpu.ops.fidelity import fidelity as j_fidelity
from qmcnn_tpu.utils.metrics import binned_stderr as j_binned_stderr
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.utils.transfer import warm_start as j_warm_start
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import measure as tmeasure
from qmcnn_tpu_torch.ops import lanczos as tlz
from qmcnn_tpu_torch.ops import observables as tobs
from qmcnn_tpu_torch.ops import sma as tsma
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.fidelity import fidelity as t_fidelity
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
GROUND = os.path.join(RUNS, "j1j2_4x4_ground.csv.params.npz")
EXCITED = os.path.join(RUNS, "j1j2_4x4_excited_defl.csv.params.npz")
RTOL, ATOL = 1e-5, 1e-6
M = 32
CHAIN = """
lattice: {shape: [10]}
model: {channels: [4, 4], complex_params: true, param_scale: 0.2}
hamiltonian: {kind: heisenberg}
sampler: {move: exchange}
"""


def meta_yaml(stem: str) -> str:
    with open(os.path.join(RUNS, stem + ".csv.meta.json")) as f:
        return json.load(f)["config"]


#: name -> (config YAML, overrides, snapshot or None): the 4x4 complex CNN
#: snapshot, a real 4x4 CNN and a complex 10-site chain
CASES = {
    "square": (meta_yaml("j1j2_4x4_ground"), (), GROUND),
    "real4": (open(os.path.join(ROOT, "configs", "heis10x10_sr.yaml")).read(),
              ("lattice.shape=[4,4]", "model.channels=[4,4]",
               "model.param_scale=0.3"), None),
    "chain": (CHAIN, (), None),
}


def t(x):
    return torch.from_numpy(np.array(x))


def flat_np(params) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(params).items()}


class Case:
    """One model in both packages: JAX's vmc and params, M walkers after 20
    JAX sweeps under ``params`` (a snapshot, else the seeded init), and
    the port's log psi function, Hamiltonian and params."""

    def __init__(self, name, snapshot=None, seed=3):
        text, over, default = CASES[name]
        over = over + (f"sampler.n_walkers={M}", "run.heartbeat_path=null")
        self.jcfg = jcfg.apply_overrides(jcfg.from_yaml(text), over)
        self.tcfg = tcfg.apply_overrides(tcfg.from_yaml(text), over)
        self.vmc_j, params_j, self.jlat = jb.build(self.jcfg)
        snapshot = snapshot or default
        if snapshot is not None:
            params_j = j_warm_start(params_j, snapshot)
        self.jparams = params_j
        self.jfn = self.vmc_j.log_psi_fn
        state = self.vmc_j.init_state(jax.random.key(seed), M, params_j)
        state = self.vmc_j.thermalize(state, jax.random.key(seed + 1),
                                      jnp.arange(M), n_sweeps=20)
        self.js, self.jlp = state.walkers.s, state.walkers.log_psi
        vmc_t, _, self.tlat = tb.build(self.tcfg, device="cpu")
        self.tfn, self.tham = vmc_t.log_psi_fn, vmc_t.ham
        self.tparams = params_from_jax(flat_np(params_j))
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


REGIONS = {"square": ["half", "0:5", "1,6,11"], "real4": ["half", "4:12"],
           "chain": ["half", "2:4"]}


def swap_tolerance(c, jpairs, region) -> np.ndarray:
    """Each pair's relative tolerance: rtol, plus the f32 resolution of the
    exponent lp(t1) + lp(t2) - lp(s1) - lp(s2), 4 eps sum |lp| (the swapped
    configurations' |log psi| reaches ~100 on the trained 4x4 models,
    whose half-ulp alone is 4e-6)."""
    s1, s2, lp1, lp2 = jpairs
    r = jnp.asarray(region)
    t1 = s1 * (1.0 - r) + s2 * r
    t2 = s2 * (1.0 - r) + s1 * r
    size = sum(np.abs(np.asarray(x, np.float64)) for x in (
        c.jfn(c.jparams, t1).re, c.jfn(c.jparams, t2).re, lp1.re, lp2.re))
    return RTOL + 4 * np.finfo(np.float32).eps * size


@pytest.mark.parametrize("sector_mask", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_renyi2_matches_jax(cases, name, sector_mask):
    """renyi2_swap_local per even/odd pair, renyi2_swap's mean and
    renyi2_entropy of it, for each region, within rtol 1e-5 plus the f32
    resolution of each pair's exponent (``swap_tolerance``); with
    sector_mask the pairs of unequal region magnetization are exactly 0
    in both."""
    c = cases(name)
    n = c.tlat.n_sites
    pairs = (c.ts[0::2], c.ts[1::2], c.tlp[0::2], c.tlp[1::2])
    jpairs = (c.js[0::2], c.js[1::2], JC(c.jlp.re[0::2], c.jlp.im[0::2]),
              JC(c.jlp.re[1::2], c.jlp.im[1::2]))
    for spec in REGIONS[name]:
        region = tmeasure.parse_region(spec, n)
        got = tobs.renyi2_swap_local(c.tfn, c.tparams, *pairs, region,
                                     sector_mask=sector_mask)
        want = jobs.renyi2_swap_local(c.jfn, c.jparams, *jpairs,
                                      jnp.asarray(region),
                                      sector_mask=sector_mask)
        tol = swap_tolerance(c, jpairs, region)
        w_abs = np.hypot(np.asarray(want.re, np.float64),
                         np.asarray(want.im, np.float64))
        for part in ("re", "im"):
            diff = np.abs(getattr(got, part).numpy().astype(np.float64)
                          - np.asarray(getattr(want, part), np.float64))
            assert (diff <= tol * w_abs + ATOL).all(), (spec, part)
        if sector_mask:
            m_a = (c.ts * t(region)).sum(-1)
            off = (m_a[0::2] != m_a[1::2]).numpy()
            assert off.any() and (got.re.numpy()[off] == 0).all()
            assert (np.asarray(want.re)[off] == 0).all()
        mean = tobs.renyi2_swap(c.tfn, c.tparams, *pairs, region,
                                sector_mask=sector_mask)
        jmean = jobs.renyi2_swap(c.jfn, c.jparams, *jpairs,
                                 jnp.asarray(region), sector_mask=sector_mask)
        mean_tol = float((tol * w_abs).mean()) + ATOL
        assert abs(float(mean.re) - float(jmean.re)) <= mean_tol, spec
        s_got = tobs.renyi2_entropy(float(mean.re))
        s_want = jobs.renyi2_entropy(float(jmean.re))
        assert abs(s_got - s_want) <= mean_tol / float(jmean.re), spec
    for v in (0.25, 1.0, 0.0, -0.1):
        got, want = tobs.renyi2_entropy(v), jobs.renyi2_entropy(v)
        assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("spec,n", [("half", 16), ("half", 9), ("3:9", 16),
                                    (":5", 16), ("4:", 16), ("0,2,5", 16),
                                    ("7", 10), ("0:16", 16), ("5:5", 16),
                                    ("0,1", 2)])
def test_parse_region_matches_jax(spec, n):
    """Each spec form, and the specs that are not a proper subset (the
    whole lattice, the empty slice), which raise ValueError in both."""
    try:
        want = j_parse_region(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match="proper subset"):
            tmeasure.parse_region(spec, n)
        assert "proper subset" in str(e)
        return
    got = tmeasure.parse_region(spec, n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


SMA_CASES = {
    "square": ("heisenberg", (4, 4), "hypercubic", {}),
    "j1j2": ("heisenberg", (6, 6), "hypercubic", {"j2": 0.5}),
    "chain": ("heisenberg", (10,), "hypercubic", {}),
    "xxz_2x4": ("heisenberg", (2, 4), "hypercubic", {"delta": 0.5}),
}


def _hams(kind, shape, geometry, kw, pbc=True):
    """(JAX Hamiltonian and lattice, the port's), Marshall off."""
    from qmcnn_tpu.lattice import Lattice as JLattice
    from qmcnn_tpu.ops import hamiltonians as jh
    from qmcnn_tpu_torch.lattice import Lattice as TLattice
    from qmcnn_tpu_torch.ops import hamiltonians as th

    out = []
    for mod, Lat in ((jh, JLattice), (th, TLattice)):
        lat = Lat(shape, pbc=pbc, geometry=geometry)
        ham = (mod.TFIM(lat, h=1.0) if kind == "tfim"
               else mod.Heisenberg(lat, marshall=False, **kw))
        out.append((ham, lat))
    return out


@pytest.mark.parametrize("name", list(SMA_CASES))
def test_sma_matches_jax(name):
    """exchange_shells equal (the L = 2 axis's self-inverse shell at half
    weight included), and sma_dispersion's f, S and omega within 1e-12 on
    identical random C_t and correlations (NaN where S(q) ~ 0)."""
    (jham, jl), (tham, tl) = _hams(*SMA_CASES[name])
    got, want = tsma.exchange_shells(tham, tl), jsma.exchange_shells(jham, jl)
    assert got == want
    rng = np.random.default_rng(7)
    ct = {d: float(rng.normal()) for _, d in got}
    corr = 0.1 * rng.normal(size=tl.n_sites)
    corr[0] = 0.25
    for a, b in zip(tsma.sma_dispersion(got, ct, corr, tl),
                    jsma.sma_dispersion(want, ct, corr, jl)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    corr0 = np.zeros(tl.n_sites)  # S(q) = 0 everywhere: omega all NaN
    assert np.isnan(tsma.sma_dispersion(got, ct, corr0, tl)[2]).all()


@pytest.mark.parametrize("guard", ["tfim", "basis", "open"])
def test_sma_guards_raise_as_jax(guard):
    """A transverse field, a multi-site basis and open boundaries raise
    ValueError in both packages, with JAX's message."""
    args = {"tfim": ("tfim", (4, 4), "hypercubic", {}),
            "basis": ("heisenberg", (2, 3), "kagome", {}),
            "open": ("heisenberg", (4, 4), "hypercubic", {})}[guard]
    (jham, jl), (tham, tl) = _hams(*args, pbc=guard != "open")
    with pytest.raises(ValueError) as want:
        jsma.exchange_shells(jham, jl)
    with pytest.raises(ValueError) as got:
        tsma.exchange_shells(tham, tl)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def two_states(cases):
    """The 4x4 ground and excited snapshots: params in both packages and M
    walkers of each |psi|^2, thermalized by JAX."""
    ground = cases("square")
    excited = Case("square", snapshot=EXCITED, seed=5)
    return ground, excited


def test_fidelity_matches_jax(two_states):
    """fidelity of the ground and excited snapshots on each one's walkers
    (rtol 1e-5 of the JAX estimate), in either order; the fidelity of a
    state with itself is exactly 1."""
    g, e = two_states
    got = t_fidelity(g.tfn, g.tparams, e.tfn, e.tparams, g.ts, e.ts)
    want = j_fidelity(g.jfn, g.jparams, e.jfn, e.jparams, g.js, e.js)
    close(got, want, "F(ground, excited)")
    assert 0.0 < float(got) < 0.5
    back = t_fidelity(e.tfn, e.tparams, g.tfn, g.tparams, e.ts, g.ts)
    close(back, j_fidelity(e.jfn, e.jparams, g.jfn, g.jparams, e.js, g.js),
          "F(excited, ground)")
    for c in (g, e):
        assert float(t_fidelity(c.tfn, c.tparams, c.tfn, c.tparams, c.ts,
                                e.ts)) == 1.0


@pytest.mark.parametrize("name", ["square", "chain"])
def test_h_moment_samples_matches_jax(cases, name):
    """Per-walker (E_loc, G) unchunked and in walker chunks of 8 against
    JAX's (rtol 1e-5 of each array's scale: G is a sum of K terms of
    E_loc's size); the chunks equal the whole pass within 1e-6."""
    c = cases(name)
    want = jlz.h_moment_samples(c.jfn, c.jparams, c.vmc_j.ham, c.js, c.jlp,
                                chunk_size=8)
    whole = tlz.h_moment_samples(c.tfn, c.tparams, c.tham, c.ts, c.tlp)
    chunked = tlz.h_moment_samples(c.tfn, c.tparams, c.tham, c.ts, c.tlp,
                                   chunk_size=8)
    for got in (whole, chunked):
        for z, w, what in ((got[0], want[0], "E_loc"), (got[1], want[1], "G")):
            scale = float(np.abs(np.asarray(w.re)).max())
            for part in ("re", "im"):
                np.testing.assert_allclose(
                    getattr(z, part).numpy(), np.asarray(getattr(w, part)),
                    rtol=RTOL, atol=RTOL * scale, err_msg=f"{what} {part}")
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.re.numpy(), b.re.numpy(), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        tlz.h_moment_samples(c.tfn, c.tparams, c.tham, c.ts, c.tlp,
                             chunk_size=5)


def test_moments_and_lanczos_step_match_jax():
    """moments_from_samples (uniform and weighted) and lanczos_step on
    identical host inputs, to 1e-12; k2 <= 0 returns alpha 0 in both."""
    rng = np.random.default_rng(11)
    for m in (7, 64):
        e = rng.normal(size=(2, m)) + np.array([[-8.0], [0.0]])
        g = rng.normal(size=(2, m)) * 3 + np.array([[64.0], [0.0]])
        w = rng.random(m)
        for weights in (None, w):
            got = tlz.moments_from_samples(C(*e), C(*g), weights)
            want = jlz.moments_from_samples(JC(*e), JC(*g), weights)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            np.testing.assert_allclose(tlz.lanczos_step(*got),
                                       jlz.lanczos_step(*want), rtol=1e-12,
                                       atol=0)
    for h in ((-1.0, 1.0, -1.0), (-2.0, 3.9, -8.0), (0.5, 0.2, 0.1)):
        assert tlz.lanczos_step(*h) == jlz.lanczos_step(*h)


def jax_blocks(tr, jl, jham, energy):
    """JAX measure's report blocks for --renyi2, --sma, --fidelity-ckpt and
    --lanczos-step (qmcnn_tpu/measure.py, the accumulators and the report
    code) through its host functions, on the same traces."""
    n = jl.n_sites
    rep = {}
    traces = np.stack(tr["renyi2_swap"])
    means = traces.mean(axis=0)
    rep["renyi2_swap_mean"] = [float(x) for x in means]
    rep["renyi2_swap_err"] = [j_binned_stderr(traces[:, r])
                              for r in range(traces.shape[1])]
    rep["renyi2_entropy"] = [jobs.renyi2_entropy(float(x)) for x in means]
    rep["renyi2_region_size"] = list(tr["renyi2_region_size"])
    if len(means) == 1:
        for k in ("renyi2_swap_mean", "renyi2_swap_err", "renyi2_entropy",
                  "renyi2_region_size"):
            rep[k] = rep[k][0]
    shells = jsma.exchange_shells(jham, jl)
    disps = sorted({d for _, d in shells})
    acc = np.zeros(len(disps))
    for x in tr["sma_ct"]:
        acc += np.asarray(x)
    n_samples = len(tr["sma_ct"])
    ct = {d: float(v / n_samples) for d, v in zip(disps, acc)}
    corr_acc = np.zeros(n)
    for x in tr["corr"]:
        corr_acc += np.asarray(x)
    f_q, _, omega = jsma.sma_dispersion(shells, ct, corr_acc / n_samples, jl)
    finite = np.isfinite(omega) & (np.arange(n).reshape(omega.shape) > 0)
    rep["sma_transverse_corr"] = {str(d): ct[d] for d in disps}
    rep["sma_first_moment"] = [round(float(x), 8) for x in f_q.reshape(-1)]
    rep["sma_omega"] = [float(x) if np.isfinite(x) else None
                        for x in omega.reshape(-1)]
    if finite.any():
        k = int(np.nanargmin(np.where(finite, omega, np.nan)))
        rep["sma_gap_bound"] = float(omega.reshape(-1)[k])
        rep["sma_gap_q_index"] = k
    rep["fidelity_vs_ckpt"] = tr["fidelity"]
    lz_e1, lz_g = tr["lanczos_e1"], tr["lanczos_g"]

    def step(e1, g):
        h = jlz.moments_from_samples(
            JC(e1.real.astype(np.float64), e1.imag.astype(np.float64)),
            JC(g.real.astype(np.float64), g.imag.astype(np.float64)))
        return h, jlz.lanczos_step(*h)

    (h1, h2, _), (alpha, e_lz, _) = step(np.concatenate(lz_e1),
                                         np.concatenate(lz_g))
    k2 = h2 - h1 * h1
    rep["lanczos_valid"] = bool(h1 - e_lz <= 1.05 * np.sqrt(max(k2, 0.0))
                                + 1e-12)
    rep["lanczos_alpha"] = alpha
    rep["lanczos_energy"] = e_lz
    rep["lanczos_energy_per_site"] = e_lz / n
    rep["lanczos_gain_per_site"] = (e_lz - energy) / n
    blocks = len(lz_e1)
    if blocks >= 4:
        e_js = np.asarray([step(
            np.concatenate([x for i, x in enumerate(lz_e1) if i != j]),
            np.concatenate([x for i, x in enumerate(lz_g) if i != j]))[1][1]
            for j in range(blocks)], np.float64)
        err = np.sqrt((blocks - 1) / blocks
                      * ((e_js - e_js.mean()) ** 2).sum())
        rep["lanczos_energy_err"] = float(err)
        rep["lanczos_energy_per_site_err"] = float(err) / n
    return rep


@pytest.mark.parametrize("n_regions,blocks,spread", [
    (3, 5, 0.01), (1, 3, 0.01), (2, 6, 3.0)])
def test_report_blocks_match_jax(n_regions, blocks, spread, capsys):
    """assemble_report's --renyi2 (lists, or scalars for one region), --sma,
    --fidelity-ckpt and --lanczos-step blocks (the jackknife from 4
    blocks; a noise-dominated step at the large spread, with its printed
    line) on identical traces equal JAX's arithmetic to 1e-12."""
    (jham, jl), (tham, tl) = _hams("heisenberg", (4, 4), "hypercubic",
                                   {"j2": 0.5})
    rng = np.random.default_rng(blocks)
    n, m = tl.n_sites, 16

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def cplx32(loc, scale):
        return (loc + scale * f32(m)) + 1j * scale * f32(m)

    shells = tsma.exchange_shells(tham, tl)
    traces = {
        "energy": [float(-8 + 0.01 * x) for x in f32(blocks)],
        "magnetization": [0.0] * blocks, "mst2": [0.1] * blocks,
        "mst4": [0.02] * blocks, "ss_nn": [-0.4] * blocks,
        "corr": [np.concatenate([[0.25], 0.05 * f32(n - 1)])
                 for _ in range(blocks)],
        "renyi2_swap": [0.5 + 0.05 * f32(n_regions) for _ in range(blocks)],
        "renyi2_region_size": list(range(2, 2 + n_regions)),
        "sma_shells": shells,
        "sma_ct": [-0.2 + 0.01 * f32(len({d for _, d in shells}))
                   for _ in range(blocks)],
        "fidelity": 0.75,
        "lanczos_e1": [cplx32(-8.0, spread) for _ in range(blocks)],
        "lanczos_g": [cplx32(64.5, 8 * spread) for _ in range(blocks)],
    }
    got = tmeasure.assemble_report(traces, tl)
    want = jax_blocks(traces, jl, jham, got["energy"])
    assert set(want) <= set(got)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            g, w = [g[k] for k in sorted(g)], [w[k] for k in sorted(w)]
        if isinstance(w, bool):
            assert g is w, key
            continue
        np.testing.assert_allclose(
            np.asarray(g, dtype=object).astype(np.float64),
            np.asarray(w, dtype=object).astype(np.float64), rtol=1e-12,
            atol=0, equal_nan=True, err_msg=key)
    noisy = "NOISE-DOMINATED" in capsys.readouterr().out
    assert noisy is (not got["lanczos_valid"])
    assert ("lanczos_energy_err" in got) is (blocks >= 4)


def _cfg_pair(text, *over):
    over = ("run.heartbeat_path=null",) + over
    return (jcfg.apply_overrides(jcfg.from_yaml(text), over),
            tcfg.apply_overrides(tcfg.from_yaml(text), over))


def exact_purity(cfg, spec: str) -> float:
    """Tr(rho_A^2) of the 4x4 ground snapshot restricted to S^z = 0 (as the
    masked swap estimator measures it), by enumerating its 12,870
    configurations through the port's model."""
    vmc, params, lattice = tb.build(cfg, device="cpu")
    params = tmeasure.warm_start(params, GROUND)
    n = lattice.n_sites
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)[::-1]) & 1
    s = (2 * bits - 1).astype(np.float32)  # site 0 the leading bit
    sector = s.sum(1) == 0
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, torch.from_numpy(s[sector]))
    re, im = lp.re.double().numpy(), lp.im.double().numpy()
    psi = np.zeros(2 ** n, complex)
    psi[sector] = np.exp(re - re.max() + 1j * im)
    psi /= np.linalg.norm(psi)
    a = [int(i) for i in np.flatnonzero(tmeasure.parse_region(spec, n))]
    rest = [i for i in range(n) if i not in a]
    p = psi.reshape([2] * n).transpose(a + rest).reshape(2 ** len(a), -1)
    rho = p @ p.conj().T
    return float(np.real(np.trace(rho @ rho)))


def test_measure_flags_match_jax(capsys):
    """The whole entry point, one run per package, on the 4x4 J1-J2 ground
    snapshot (M = 128, 4 samples) with --renyi2 half --renyi2 0:4 --sma
    --fidelity-ckpt <the 4x4 excited snapshot>: the same keys; the energy
    within max(5 sigma, 2e-3 N); each region's Tr(rho_A^2) within 5 sigma
    + 0.01 of JAX's and within 5 sigma + 0.02 of its value by enumeration
    (the swap estimator's binned error over 4 samples is itself rough);
    the SMA's softest mode at (pi, pi), index 10, in both, the NN and NNN
    shells' mean C_t within 0.02 and the bound within 15% (the (pi, pi)
    structure factor's sampling noise at this M); the fidelity within
    0.05. The Lanczos step is left to the chain's run below: this state
    is within 1e-3 of its ground energy, where the step's moments are
    noise-dominated in both packages (alpha -> -1/h1, gains of tens per
    site) and the energy is no comparison."""
    cfg_j, cfg_t = _cfg_pair(meta_yaml("j1j2_4x4_ground"),
                             "sampler.n_walkers=128")
    kw = dict(n_samples=4, renyi2_region=["half", "0:4"], sma=True,
              fidelity_ckpt=EXCITED)
    want = jmeasure(cfg_j, GROUND, **kw)
    got = tmeasure.measure(cfg_t, GROUND, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    bound = max(5 * np.hypot(got["energy_err"], want["energy_err"]),
                2e-3 * 16)
    assert abs(got["energy"] - want["energy"]) <= bound
    for r, spec in enumerate(["half", "0:4"]):
        g, w = got["renyi2_swap_mean"][r], want["renyi2_swap_mean"][r]
        sig = np.hypot(got["renyi2_swap_err"][r], want["renyi2_swap_err"][r])
        assert abs(g - w) <= 5 * sig + 0.01, spec
        exact = exact_purity(cfg_t, spec)
        assert abs(g - exact) <= 5 * got["renyi2_swap_err"][r] + 0.02, spec
    assert got["renyi2_region_size"] == want["renyi2_region_size"] == [8, 4]
    assert got["sma_gap_q_index"] == want["sma_gap_q_index"] == 10
    for shell in (("1", "4"), ("5", "7")):
        g, w = (np.mean([rep["sma_transverse_corr"][d] for d in shell])
                for rep in (got, want))
        assert abs(g - w) < 0.02, shell
    assert got["sma_gap_bound"] == pytest.approx(want["sma_gap_bound"],
                                                 rel=0.15)
    assert abs(got["fidelity_vs_ckpt"] - want["fidelity_vs_ckpt"]) < 0.05
    capsys.readouterr()


def test_measure_lanczos_matches_jax(tmp_path, capsys):
    """--lanczos-step --renyi2 half --sma, one run per package, on a fresh
    10-site Heisenberg chain (complex CNN, M = 64, 4 samples), where the
    step is valid in both: the energy and the Lanczos energy within
    max(5 sigma, 2e-3 N) of JAX's, each with its own error (the
    jackknife's for the Lanczos energy), alpha within 20%."""
    cfg_j, cfg_t = _cfg_pair(CHAIN, "sampler.n_walkers=64")
    _, params_j, _ = jb.build(cfg_j)
    snap = str(tmp_path / "chain.params.npz")
    np.savez(snap, **flat_np(params_j))
    kw = dict(n_samples=4, lanczos=True, renyi2_region="half", sma=True)
    want = jmeasure(cfg_j, snap, **kw)
    got = tmeasure.measure(cfg_t, snap, device="cpu", **kw)
    capsys.readouterr()
    assert sorted(got) == sorted(want)
    assert got["lanczos_valid"] is want["lanczos_valid"] is True
    for key, err in (("energy", "energy_err"),
                     ("lanczos_energy", "lanczos_energy_err")):
        sigma = np.hypot(got[err], want[err])
        assert abs(got[key] - want[key]) <= max(5 * sigma, 2e-3 * 10), key
    assert got["lanczos_energy"] < got["energy"]
    assert got["lanczos_alpha"] == pytest.approx(want["lanczos_alpha"],
                                                 rel=0.2)
    assert isinstance(got["renyi2_entropy"], float)


@pytest.mark.parametrize("chunk", ["null", "8"])
def test_measure_expected_counts_every_forward(chunk, tmp_path, monkeypatch,
                                               capsys):
    """``chip_smoke.measure_expected``, which holds every measurement leg's
    kernel launches exactly on the card, equals the evaluation forwards
    measure() calls on the CPU (one call per launch there) with every flag
    of a square lattice, the fidelity's second chain included, unchunked
    and in E_loc chunks of 8 walkers (the Lanczos, sector and pair chunks
    follow)."""
    import chip_smoke
    from qmcnn_tpu_torch import builder
    from tests import torch_dist_ranks as R

    calls = []
    real = builder.evaluation_forward

    def counting(cfg, lattice, device, log_psi_fn):
        fn = real(cfg, lattice, device, log_psi_fn)

        def forward(params, s):
            calls.append(s.shape[0])
            return fn(params, s)

        return forward

    monkeypatch.setattr(builder, "evaluation_forward", counting)
    spec = R.measure_spec(str(tmp_path))
    cfg = tcfg.load(R.HEIS, R.MEASURE_SMALL + (f"run.chunk_size={chunk}",))
    vmc, _, lattice = builder.build(cfg, device="cpu")
    flags = dict(R.MEASURE_FLAGS, n_samples=2)
    want = chip_smoke.measure_expected(
        cfg, vmc, lattice, 2, 50, total_spin=True, sector=True, lanczos=True,
        regions=len(flags["renyi2_region"]), sma_disps=2, fidelity=True,
        sweeps_between=flags["sweeps_between"])
    calls.clear()
    tmeasure.measure(cfg, spec["psi"], device="cpu",
                     fidelity_ckpt=spec["psi2"], **flags)
    capsys.readouterr()
    assert len(calls) == want
    lz_chunk = tmeasure.chunk_sizes(vmc, 32, lattice)[3]
    assert lz_chunk == (16 if chunk == "null" else 4)  # half the budget
    assert lz_chunk * vmc.ham.n_conn in calls  # the Lanczos chunk's batch
