"""PyTorch port, slice 10: momentum-sector optimization
(``vmc.sector_energy_and_grad``, ``ops/observables.py``) and the
(1 + alpha H) ansatz (``ops/lanczos.py``), against the JAX package and
dense enumeration.

Inputs: an untied complex RBM on the N = 6 TFIM chain (the sector tests of
tests/test_sector_opt.py) and the N = 8 Heisenberg chain CNN of
tests/test_lanczos.py, params made by JAX and copied, walkers from numpy.
Tolerances: values rtol 1e-5, gradients rtol 1e-4 (float32 in another
summation order); the dense oracles at the JAX tests' tolerances."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.lattice import chain as jchain
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.models.rbm import LogPsiRBM as JRBM
from qmcnn_tpu.ops.hamiltonians import TFIM as JTFIM
from qmcnn_tpu.ops.hamiltonians import Heisenberg as JHeis
from qmcnn_tpu.ops.lanczos import lanczos_wrap as j_wrap
from qmcnn_tpu.ops.local_energy import local_energy as j_local_energy
from qmcnn_tpu.sampler.metropolis import WalkerState as JW
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.vmc import sector_energy_and_grad as j_sector
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.lattice import chain as tchain
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.rbm import LogPsiRBM as TRBM
from qmcnn_tpu_torch.ops import exact as texact
from qmcnn_tpu_torch.ops.hamiltonians import TFIM as TTFIM
from qmcnn_tpu_torch.ops.hamiltonians import Heisenberg as THeis
from qmcnn_tpu_torch.ops.lanczos import ALPHA_KEY, lanczos_wrap
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.ops.observables import sector_energy_ratio
from qmcnn_tpu_torch.sampler.metropolis import WalkerState
from qmcnn_tpu_torch.utils import transfer as ttransfer
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from qmcnn_tpu_torch.vmc import sector_energy_and_grad as t_sector
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x))


def flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _close(got, want, what, rtol=1e-4):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=rtol,
                                   atol=rtol * scale, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def sector_case():
    """The untied complex RBM on the N = 6 TFIM chain (h = 0.8)."""
    n = 6
    kw = dict(lattice_shape=(n,), alpha=2, complex_params=True,
              param_scale=0.35, tie_translations=False)
    jm, tm = JRBM(**kw), TRBM(**kw)
    v = jm.init(jax.random.key(5), jnp.ones((1, n), jnp.float32))
    return dict(n=n, jfn=lambda p, s: j_apply(jm, p, s),
                tfn=lambda p, s: t_apply(tm, p, s), v=v,
                p=params_from_jax(flat_np(v)),
                jham=JTFIM(jchain(n), h=0.8), tham=TTFIM(tchain(n), h=0.8))


@pytest.mark.parametrize("m_q,kappa,chunk", [(1, 0.4, None), (3, 0.0, 13),
                                             (3, 0.5, 120)])
def test_sector_energy_and_grad_matches_jax(sector_case, m_q, kappa, chunk):
    """e_q, the residual variance, the gradient, e_eff and the sector weight
    on numpy walkers; ``chunk`` covers the chunk // T rule (13 // 6 = 2,
    a divisor of 40; 120 // 6 = 20) and no chunk."""
    c = sector_case
    m = 40
    rng = np.random.default_rng(m_q)
    s = (2.0 * rng.integers(0, 2, size=(m, c["n"])) - 1.0).astype(np.float32)
    lp_j = c["jfn"](c["v"], jnp.asarray(s))
    zeros = jnp.zeros(m, jnp.int32)
    out_j = j_sector(c["jfn"], c["jham"], c["v"],
                     JW(jnp.asarray(s), lp_j, zeros, zeros), (c["n"],),
                     (m_q,), kappa=kappa, chunk_size=chunk)
    lp_t = c["tfn"](c["p"], t(s))
    zt = torch.zeros(m, dtype=torch.int32)
    out_t = t_sector(c["tfn"], c["tham"], c["p"],
                     WalkerState(t(s), lp_t, zt, zt), (c["n"],), (m_q,),
                     kappa=kappa, chunk_size=chunk)
    e_j, var_j, g_j, eff_j, w_j = out_j
    e_t, var_t, g_t, eff_t, w_t = out_t
    assert float(e_t.re) == pytest.approx(float(e_j.re), rel=1e-5)
    assert float(e_t.im) == pytest.approx(float(e_j.im), rel=1e-4,
                                          abs=1e-5)
    assert float(var_t) == pytest.approx(float(var_j), rel=1e-4)
    assert float(w_t) == pytest.approx(float(w_j), rel=1e-5)
    assert float(w_t) > 1e-3
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(eff_t, part).numpy(),
                                   np.asarray(getattr(eff_j, part)),
                                   rtol=1e-4, atol=1e-4)
    _close(g_t, flat_np(g_j), "sector grad")


def test_sector_spring_steps_match_jax():
    """Two sector steps (kappa 0.5, SPRING-minSR with momentum 0.9, the
    clipped SGD update) of the untied complex RBM on the N = 6 TFIM chain,
    from JAX's thermalized walkers with JAX's sweep draws injected, against
    ``qmcnn_tpu.vmc.VMC.step``: the walkers bitwise, E_q and the sector
    weight at rtol 1e-5, then the updated params and SPRING's carry at
    rtol 1e-4 of each leaf's largest entry, and the second step's E_q,
    computed at the updated params, at rtol 1e-4."""
    from qmcnn_tpu.kernels.metropolis_pallas import sweep_noise
    from qmcnn_tpu_torch.ops.cplx import C
    from qmcnn_tpu_torch.sr import ravel
    from qmcnn_tpu_torch.vmc import TrainState

    path = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
    over = ("model.kind=rbm", "model.complex_params=true",
            "model.rbm_tie_translations=false", "model.param_scale=0.35",
            "lattice.shape=[6]", "hamiltonian.h=0.8", "sampler.n_walkers=32",
            "optimizer.sector_momentum=[1]", "optimizer.sector_kappa=0.5",
            "optimizer.lr=0.05", "sr.enabled=true", "sr.solver=minsr",
            "sr.momentum=0.9", "sr.diag_shift0=0.02")
    vmc_j, params_j, _ = jb.build(jcfg.load(path, over))
    vmc_t, _, _ = tb.build(tcfg.load(path, over), device="cpu")
    m, ids = 32, jnp.arange(32)
    state_j = vmc_j.init_state(jax.random.key(3), m, params_j)
    state_j = vmc_j.thermalize(state_j, jax.random.key(4), ids, n_sweeps=4)
    p_t = params_from_jax(flat_np(params_j))
    w = state_j.walkers
    state_t = TrainState(
        params=p_t, opt_state=vmc_t.optimizer.init(p_t),
        walkers=WalkerState(t(w.s), C(t(w.log_psi.re), t(w.log_psi.im)),
                            torch.zeros(m, dtype=torch.int32),
                            torch.zeros(m, dtype=torch.int32)),
        step=0, sr_aux=torch.zeros(ravel(p_t)[0].numel()))
    n_props = 6 * vmc_j.n_sweeps
    for step in range(2):
        key = jax.random.key(11 + step)
        state_j, m_j = vmc_j.step(state_j, key, ids)
        ch, lu = sweep_noise(key, ids, n_props, 6)
        state_t, m_t = vmc_t.step(state_t, 0, torch.arange(m),
                                  noise=(t(ch), t(lu)))
        np.testing.assert_array_equal(state_t.walkers.s.numpy(),
                                      np.asarray(state_j.walkers.s))
        rel = 1e-5 if step == 0 else 1e-4
        assert float(m_t.energy_re) == pytest.approx(float(m_j.energy_re),
                                                     rel=rel)
        assert float(m_t.overlap) == pytest.approx(float(m_j.overlap),
                                                   rel=rel)
        _close(state_t.params, flat_np(state_j.params), f"step {step} params")
        carry_j = np.asarray(state_j.sr_aux)
        np.testing.assert_allclose(state_t.sr_aux.numpy(), carry_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(carry_j).max())
    assert state_t.step == 2 and float(m_t.overlap) > 1e-3


def test_sector_snapshot_step_matches_jax():
    """One step of the committed (pi, pi) sector run at full width (8 x 8
    J1-J2, the untied complex RBM with alpha 4, kappa 0.5, SPRING-minSR,
    lr 0.002, clip 1) from its snapshot on 8 numpy walkers at S^z = 0, in
    both packages: E_q, the sector weight and the residual variance at
    rtol 1e-4, e_eff and the updated params and SPRING's carry at rtol 1e-4
    of their largest entries (float32 sums of amplitude ratios that span
    many orders of magnitude at these configurations)."""
    import json

    import optax

    from qmcnn_tpu.utils.transfer import warm_start as j_warm_start

    meta = json.load(open(os.path.join(
        ROOT, "runs", "j1j2_8x8_sector_pipi.csv.meta.json")))
    snap = os.path.join(ROOT, "runs", "j1j2_8x8_sector_pipi.csv.params.npz")
    over = ("optimizer.schedule=constant", "optimizer.lr=0.002")
    vmc_j, params_j, _ = jb.build(jcfg.apply_overrides(
        jcfg.from_yaml(meta["config"]), over))
    vmc_t, params_t, _ = tb.build(tcfg.apply_overrides(
        tcfg.from_yaml(meta["config"]), over), device="cpu")
    params_j = j_warm_start(params_j, snap)
    params_t = ttransfer.warm_start(params_t, snap)
    m = 8
    rng = np.random.default_rng(9)
    base = np.array([1.0] * 32 + [-1.0] * 32, np.float32)
    s = np.stack([rng.permutation(base) for _ in range(m)])
    zeros = jnp.zeros(m, jnp.int32)
    lp_j = vmc_j.log_psi_fn(params_j, jnp.asarray(s))
    e_j, var_j, g_j, eff_j, w_j = j_sector(
        vmc_j.log_psi_fn, vmc_j.ham, params_j,
        JW(jnp.asarray(s), lp_j, zeros, zeros), (8, 8), (4, 4), kappa=0.5,
        chunk_size=vmc_j.chunk_size)
    carry_j = jnp.zeros_like(jax.flatten_util.ravel_pytree(params_j)[0])
    nat_j, _, _, carry_j = vmc_j.sr.solve_spring(
        vmc_j.log_psi_fn, params_j, jnp.asarray(s), g_j, jnp.asarray(0),
        carry_j, e_loc=eff_j)
    upd, _ = vmc_j.optimizer.update(nat_j, vmc_j.optimizer.init(params_j),
                                    params_j)
    new_j = optax.apply_updates(params_j, upd)

    with torch.no_grad():
        lp_t = vmc_t.log_psi_fn(params_t, t(s))
    zt = torch.zeros(m, dtype=torch.int32)
    e_t, var_t, g_t, eff_t, w_t = t_sector(
        vmc_t.log_psi_fn, vmc_t.ham, params_t,
        WalkerState(t(s), lp_t, zt, zt), (8, 8), (4, 4), kappa=0.5,
        chunk_size=vmc_t.chunk_size)
    nat_t, _, _, carry_t = vmc_t.sr.solve_spring(
        vmc_t.log_psi_fn, params_t, t(s), g_t, 0,
        torch.zeros(carry_j.size), e_loc=eff_t)
    upd_t, _ = vmc_t.optimizer.update(nat_t, vmc_t.optimizer.init(params_t))
    new_t = {k: params_t[k] + upd_t[k] for k in params_t}

    assert vmc_t.sr.momentum == vmc_j.sr.momentum == 0.9
    assert float(e_t.re) == pytest.approx(float(e_j.re), rel=1e-4)
    assert float(var_t) == pytest.approx(float(var_j), rel=1e-4)
    assert float(w_t) == pytest.approx(float(w_j), rel=1e-4)
    for part in ("re", "im"):
        want = np.asarray(getattr(eff_j, part))
        np.testing.assert_allclose(getattr(eff_t, part).numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())
    _close(new_t, flat_np(new_j), "updated params")
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(carry_j)).max())


def test_sector_ratio_matches_dense_projection(sector_case):
    """Under exact |psi|^2 weights the ratio estimator's E_q is the dense
    Rayleigh quotient of the explicitly projected vector (the JAX test's
    oracle, tests/test_sector_opt.py)."""
    c = sector_case
    n, m_q = c["n"], 1
    s_all = texact.all_configs(n)
    lp = c["tfn"](c["p"], t(s_all))
    psi = np.exp(lp.re.double().numpy() - float(lp.re.max())
                 + 1j * lp.im.double().numpy())
    index = {tuple(row): i for i, row in enumerate(s_all)}
    p_psi = np.zeros_like(psi)
    for sh in range(n):
        for i, row in enumerate(s_all):
            p_psi[i] += (np.exp(2j * np.pi * m_q * sh / n)
                         * psi[index[tuple(np.roll(row, sh))]])
    p_psi /= n
    h = texact.dense_from_hamiltonian(c["tham"])
    e_dense = np.real(np.conj(psi) @ h @ p_psi) / np.real(
        np.conj(psi) @ p_psi)
    num, den = sector_energy_ratio(c["tfn"], c["p"], t(s_all), lp, c["tham"],
                                   (n,), (m_q,))
    w = np.abs(psi) ** 2
    w /= w.sum()
    nn = num.re.double().numpy() + 1j * num.im.double().numpy()
    dd = den.re.double().numpy() + 1j * den.im.double().numpy()
    e_est = np.real((w * nn).sum() / (w * dd).sum())
    assert abs(e_est - e_dense) < 1e-4 * max(1.0, abs(e_dense))


@pytest.fixture(scope="module")
def lanczos_case():
    """The N = 8 Heisenberg chain complex CNN (C = 3), alpha = 0.13 + 0.05i."""
    n = 8
    kw = dict(lattice_shape=(n,), channels=(3,), param_scale=0.3,
              complex_params=True)
    jm, tm = JCNN(**kw), TCNN(**kw)
    v = jm.init(jax.random.key(7), jnp.ones((1, n), jnp.float32))
    jham, tham = JHeis(jchain(n), marshall=True), THeis(tchain(n),
                                                       marshall=True)
    jfn = j_wrap(lambda p, s: j_apply(jm, p, s), jham)
    tfn = lanczos_wrap(lambda p, s: t_apply(tm, p, s), tham)
    vj = dict(v)
    vj["lanczos"] = {"alpha": jnp.asarray([0.13, 0.05], jnp.float32)}
    return dict(n=n, jfn=jfn, tfn=tfn, vj=vj, p=params_from_jax(flat_np(vj)),
                jham=jham, tham=tham, base=lambda p, s: t_apply(tm, p, s),
                v=v)


def test_lanczos_wrap_matches_jax(lanczos_case):
    """log phi, the local energy of phi (K^2 base forwards per sample) and
    the gradient of a surrogate Re-mean of log phi, alpha included."""
    c = lanczos_case
    assert ALPHA_KEY in c["p"] and c["p"][ALPHA_KEY].shape == (2,)
    rng = np.random.default_rng(2)
    base = np.array([1.0] * 4 + [-1.0] * 4, np.float32)
    s = np.stack([rng.permutation(base) for _ in range(24)])
    lp_j = c["jfn"](c["vj"], jnp.asarray(s))
    lp_t = c["tfn"](c["p"], t(s))
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(lp_t, part).numpy(),
                                   np.asarray(getattr(lp_j, part)),
                                   rtol=1e-5, atol=1e-5)
    el_j = j_local_energy(c["jfn"], c["vj"], c["jham"], jnp.asarray(s), lp_j,
                          chunk_size=8)
    el_t = local_energy(c["tfn"], c["p"], c["tham"], t(s), lp_t,
                        chunk_size=8)
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(el_t, part).numpy(),
                                   np.asarray(getattr(el_j, part)),
                                   rtol=1e-4, atol=1e-4)
    wts = rng.normal(size=(2, 24)).astype(np.float32)

    def j_loss(p):
        out = c["jfn"](p, jnp.asarray(s))
        return jnp.mean(wts[0] * out.re + wts[1] * out.im)

    def t_loss(p):
        out = c["tfn"](p, t(s))
        return torch.mean(t(wts[0]) * out.re + t(wts[1]) * out.im)

    g_t = torch.func.grad(t_loss)(c["p"])
    _close(g_t, flat_np(jax.grad(j_loss)(c["vj"])), "d log phi")
    assert float(g_t[ALPHA_KEY].abs().sum()) > 1e-6


def test_lanczos_wrap_matches_dense(lanczos_case):
    """exp(log phi) == (1 + alpha H) psi on all 2^8 configurations, and the
    energy of phi from the local energy of the wrapped function under exact
    |phi|^2 weights is phi's dense Rayleigh quotient (the JAX oracles)."""
    c = lanczos_case
    s_all = t(texact.all_configs(c["n"]))
    base = {k: v for k, v in c["p"].items() if k != ALPHA_KEY}
    lp = c["base"](base, s_all)
    psi = np.exp(lp.re.double().numpy() + 1j * lp.im.double().numpy())
    h = texact.dense_from_hamiltonian(c["tham"])
    alpha = 0.13 + 0.05j
    phi_want = psi + alpha * (h @ psi)
    lw = c["tfn"](c["p"], s_all)
    phi = np.exp(lw.re.double().numpy() + 1j * lw.im.double().numpy())
    np.testing.assert_allclose(phi, phi_want, rtol=2e-4, atol=1e-8)
    el = local_energy(c["tfn"], c["p"], c["tham"], s_all, lw, chunk_size=64)
    w = np.abs(phi) ** 2
    w /= w.sum()
    e_want = np.real(np.conj(phi_want) @ (h @ phi_want)) / np.real(
        np.conj(phi_want) @ phi_want)
    np.testing.assert_allclose((w * el.re.double().numpy()).sum(), e_want,
                               rtol=5e-5)


def test_lanczos_build_and_snapshot_round_trip(tmp_path):
    """The builder wraps a CNN with model.lanczos_alpha as JAX does (alpha
    at its configured value, the same log phi), one step moves alpha, the
    chunk is divided by K; lanczos/alpha round-trips through
    params_to_jax / params_from_jax and a snapshot, and a warm start from a
    plain snapshot keeps alpha at its configured value."""
    path = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
    over = ("model.lanczos_alpha=0.1", "lattice.shape=[8]",
            "model.channels=[3]", "sampler.n_walkers=32",
            "sampler.n_therm_sweeps=2", "run.n_steps=1", "run.csv_path=null")
    vmc_j, params_j, _ = jb.build(jcfg.load(path, over))
    vmc_t, params_t, _ = tb.build(tcfg.load(path, over), device="cpu")
    assert torch.equal(params_t[ALPHA_KEY], torch.tensor([0.1, 0.0]))
    np.testing.assert_array_equal(
        np.asarray(params_j["lanczos"]["alpha"]), params_t[ALPHA_KEY].numpy())
    p = params_from_jax(flat_np(params_j))
    s = (2.0 * np.random.default_rng(0).integers(0, 2, size=(16, 8)) - 1.0
         ).astype(np.float32)
    lp_j = vmc_j.log_psi_fn(params_j, jnp.asarray(s))
    lp_t = vmc_t.log_psi_fn(p, t(s))
    np.testing.assert_allclose(lp_t.re.numpy(), np.asarray(lp_j.re),
                               rtol=1e-5, atol=1e-5)
    assert vmc_t.eval_log_psi_fn is vmc_t.log_psi_fn
    assert not tb.cnn_forward_eligible(tcfg.load(path, over))
    # arg(1 + alpha E_loc) gives a real CNN's phi a phase: SR keeps the
    # score's imaginary block (the JAX rule calls this log phi real)
    assert jb.model_log_psi_is_real(jcfg.load(path, over))
    assert not tb.model_log_psi_is_real(tcfg.load(path, over))
    assert np.abs(lp_t.im.numpy()).max() > 0
    # one step on the CPU moves alpha
    state = vmc_t.init_state(3, 32, p)
    new, mt = vmc_t.step(state, 5, torch.arange(32))
    assert np.isfinite(float(mt.energy_re))
    assert not torch.equal(new.params[ALPHA_KEY], p[ALPHA_KEY])
    # the chunk rule: (auto chunk or M) // K, rounded to a divisor of M
    from qmcnn_tpu_torch.utils import memory

    big = tcfg.load(path, over + ("sampler.n_walkers=96",))
    assert memory.run_chunk_size(big, tb.build_lattice(big), vmc_t.ham,
                                 100, device="cpu") == 12
    # snapshots: lanczos/alpha in both directions
    flat = ttransfer.params_to_jax(new.params)
    assert ALPHA_KEY in flat
    back = ttransfer.params_from_jax(flat)
    assert torch.equal(back[ALPHA_KEY], new.params[ALPHA_KEY])
    snap = str(tmp_path / "phi.params.npz")
    np.savez(snap, **flat)
    from qmcnn_tpu.utils.transfer import warm_start as j_warm_start

    merged = j_warm_start(params_j, snap)
    np.testing.assert_array_equal(np.asarray(merged["lanczos"]["alpha"]),
                                  flat[ALPHA_KEY])
    plain = str(tmp_path / "plain.params.npz")
    np.savez(plain, **{k: v for k, v in flat.items() if k != ALPHA_KEY})
    warm = ttransfer.warm_start(params_t, plain)
    assert torch.equal(warm[ALPHA_KEY], torch.tensor([0.1, 0.0]))
    assert torch.equal(ttransfer.warm_start(params_t, snap)[ALPHA_KEY],
                       new.params[ALPHA_KEY])


def test_lanczos_real_model_minsr_matches_dense_oracle():
    """A real CNN wrapped in (1 + alpha H), alpha = 0.1 + 0.05i: log phi
    has a phase, so minSR keeps the score's imaginary block. The port's
    delta equals a float64 dense oracle (Jacobian of log phi, both blocks,
    solve (S + shift) delta = F) within rtol 1e-3 of its largest entry,
    while the solve that drops the imaginary block (the JAX rule for a
    real base model) is off by more than 10%. JAX cannot serve as the
    oracle here, since it drops that block."""
    from qmcnn_tpu_torch.sr import SR, ravel
    from qmcnn_tpu_torch.vmc import energy_and_grad

    path = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
    cfg = tcfg.load(path, ("model.lanczos_alpha=0.1", "lattice.shape=[8]",
                           "model.channels=[3]", "sampler.n_walkers=32"))
    vmc, params, _ = tb.build(cfg, device="cpu")
    assert not cfg.model.complex_params
    params = dict(params, **{ALPHA_KEY: torch.tensor([0.1, 0.05])})
    m, shift = 32, 0.01
    s = t((2.0 * np.random.default_rng(4).integers(0, 2, size=(m, 8))
           - 1.0).astype(np.float32))
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, s)
    _, _, grads, e_loc, _ = energy_and_grad(
        vmc.log_psi_fn, vmc.ham, params, WalkerState(s, lp, None, None))
    sr = SR(solver="minsr", diag_shift0=shift, diag_shift_min=shift,
            real_log_psi=tb.model_log_psi_is_real(cfg))
    assert not sr.real_log_psi
    delta, _, _ = sr.solve(vmc.log_psi_fn, params, s, grads, 0, e_loc=e_loc)
    got = ravel(delta)[0].double().numpy()

    flat, unravel = ravel(params)

    def parts(v):
        out = vmc.log_psi_fn(unravel(v), s)
        return torch.stack([out.re, out.im])

    jac = torch.func.jacrev(parts)(flat).double().numpy()   # [2, M, P]
    o = jac - jac.mean(axis=1, keepdims=True)
    eps = np.stack([e_loc.re.double().numpy(), e_loc.im.double().numpy()])
    eps = eps - eps.mean(axis=1, keepdims=True)

    def oracle(o_rows, eps_rows):
        o_rows = o_rows.reshape(-1, o_rows.shape[-1])
        s_mat = o_rows.T @ o_rows / m + shift * np.eye(o_rows.shape[1])
        return np.linalg.solve(s_mat, o_rows.T @ eps_rows.reshape(-1) / m)

    want = oracle(o, eps)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
    dropped = oracle(o[:1], eps[:1])
    assert np.abs(dropped - want).max() > 0.1 * scale


def test_sector_build_and_train():
    """Sector optimization builds (the chunk becomes M when E_loc fits
    unchunked), trains a step on an untied RBM and logs the sector weight;
    the JAX builder agrees on the chunk."""
    from qmcnn_tpu_torch.train import train

    path = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
    over = ("model.kind=rbm", "model.complex_params=true",
            "model.rbm_tie_translations=false", "lattice.shape=[6]",
            "hamiltonian.h=0.8", "sampler.n_walkers=32",
            "sampler.n_therm_sweeps=2", "run.n_steps=2", "run.log_every=1",
            "run.csv_path=null", "optimizer.sector_momentum=[1]",
            "optimizer.sector_kappa=0.5")
    vmc_j, _, _ = jb.build(jcfg.load(path, over))
    cfg = tcfg.load(path, over)
    vmc, _, _ = tb.build(cfg, device="cpu")
    assert vmc.chunk_size == vmc_j.chunk_size == 32
    assert vmc.sector_momentum == (1,) and vmc.sector_kappa == 0.5
    state, logger = train(cfg, device="cpu")
    assert state.step == 2
    w = logger.history["sector_weight"]
    assert len(w) == 2 and all(0.0 < x < 1.5 for x in w)
    assert "overlap" not in logger.history
    assert np.isfinite(logger.history["energy_re"]).all()
    # a momentum with more components than the lattice has dimensions
    # builds in both packages: the projector zips it with the lattice
    # shape and drops the excess (a reference quirk, ROADMAP.md)
    bad = over + ("optimizer.sector_momentum=[1,0]",)
    assert jb.build(jcfg.load(path, bad))[0].sector_momentum == (1, 0)
    assert tb.build(tcfg.load(path, bad), device="cpu")[0].sector_momentum \
        == (1, 0)
