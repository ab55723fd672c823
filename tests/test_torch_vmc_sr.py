"""PyTorch port, slice 1: covariance gradient, SR solvers, the optimizer and
one full VMC step, each against the JAX package on equal inputs.

Tolerances: gradients rtol 1e-4 (float32 forward/backward in another
summation order); SR deltas rtol 2e-3 (CG and Cholesky in float32 amplify
that rounding by the condition number of S + shift, ~1e2 here); optimizer
updates rtol 1e-5 (the same float32 formulas; schedule values are computed
in float64 here and float32 in optax)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.kernels.metropolis_pallas import sweep_noise
from qmcnn_tpu.sr import SR as JSR
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.vmc import energy_and_grad as j_energy_and_grad
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import WalkerState as TWalkers
from qmcnn_tpu_torch.sr import SR as TSR
from qmcnn_tpu_torch.sr import ravel
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from qmcnn_tpu_torch.vmc import TrainState
from qmcnn_tpu_torch.vmc import energy_and_grad as t_energy_and_grad
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
         "model.param_scale=0.1", "sampler.n_walkers=64", "sr.cg_tol=1.0e-6",
         "sr.cg_maxiter=60", "run.chunk_size=64")


def flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    """JAX and port builds of one small heis config, equal params and
    thermalized JAX walkers."""
    jc = jcfg.load(BASE, SMALL)
    vmc_j, params_j, _ = jb.build(jc)
    state_j = vmc_j.init_state(jax.random.key(3), 64, params_j)
    state_j = vmc_j.thermalize(state_j, jax.random.key(4), jnp.arange(64),
                               n_sweeps=4)
    vmc_t, _, _ = tb.build(tcfg.load(BASE, SMALL), device="cpu")
    params_t = params_from_jax(flat_np(params_j))
    walkers_t = TWalkers(
        s=t(state_j.walkers.s),
        log_psi=C(t(state_j.walkers.log_psi.re), t(state_j.walkers.log_psi.im)),
        n_accept=torch.zeros(64, dtype=torch.int32),
        n_prop=torch.zeros(64, dtype=torch.int32))
    return dict(vmc_j=vmc_j, params_j=params_j, state_j=state_j,
                vmc_t=vmc_t, params_t=params_t, walkers_t=walkers_t)


def test_energy_and_grad_matches(pair):
    e_j, v_j, g_j, eloc_j, _ = j_energy_and_grad(
        pair["vmc_j"].log_psi_fn, pair["vmc_j"].ham, pair["params_j"],
        pair["state_j"].walkers)
    e_t, v_t, g_t, eloc_t, _ = t_energy_and_grad(
        pair["vmc_t"].log_psi_fn, pair["vmc_t"].ham, pair["params_t"],
        pair["walkers_t"])
    assert float(e_t.re) == pytest.approx(float(e_j.re), rel=1e-5)
    assert float(v_t) == pytest.approx(float(v_j), rel=1e-4)
    np.testing.assert_allclose(eloc_t.re.numpy(), np.asarray(eloc_j.re),
                               rtol=2e-5, atol=1e-4)
    want = flat_np(g_j)
    assert sorted(want) == sorted(g_t)
    for k, v in want.items():
        np.testing.assert_allclose(g_t[k].numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_sr_delta_matches(pair, solver):
    _, _, g_j, _, _ = j_energy_and_grad(
        pair["vmc_j"].log_psi_fn, pair["vmc_j"].ham, pair["params_j"],
        pair["state_j"].walkers)
    kw = dict(solver=solver, cg_tol=1e-6, cg_maxiter=60, real_log_psi=True,
              diag_shift0=0.5)
    d_j, it_j, res_j = JSR(**kw).solve(
        pair["vmc_j"].log_psi_fn, pair["params_j"],
        pair["state_j"].walkers.s, g_j, jnp.asarray(3))
    d_t, it_t, res_t = TSR(**kw).solve(
        pair["vmc_t"].log_psi_fn, pair["params_t"], pair["walkers_t"].s,
        params_from_jax(flat_np(g_j)), 3)
    want = flat_np(d_j)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(d_t[k].numpy(), v, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=k)
    assert float(res_t) < 1e-3 and float(res_j) < 1e-3
    if solver == "pcg":
        assert abs(int(it_t) - int(it_j)) <= 2


def test_full_step_matches(pair):
    """One VMC.step from equal params and walkers with JAX's noise."""
    vmc_j, state_j = pair["vmc_j"], pair["state_j"]
    key = jax.random.key(11)
    new_j, m_j = vmc_j.step(state_j, key, jnp.arange(64))
    n_choices = len(vmc_j.sampler.bonds)
    ch, lu = sweep_noise(key, jnp.arange(64), 16, n_choices)
    vmc_t = pair["vmc_t"]
    state_t = TrainState(params=pair["params_t"],
                         opt_state=vmc_t.optimizer.init(pair["params_t"]),
                         walkers=pair["walkers_t"], step=0)
    new_t, m_t = vmc_t.step(state_t, 0, torch.arange(64), noise=(t(ch), t(lu)))
    np.testing.assert_array_equal(new_t.walkers.s.numpy(),
                                  np.asarray(new_j.walkers.s))
    assert float(m_t.energy_re) == pytest.approx(float(m_j.energy_re),
                                                 rel=1e-5)
    assert float(m_t.accept_rate) == pytest.approx(float(m_j.accept_rate))
    assert m_t.sr_iters > 0
    for k, v in flat_np(new_j.params).items():
        np.testing.assert_allclose(new_t.params[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert new_t.step == 1


OPTS = [("sgd", None), ("sgd", 0.9), ("adam", None)]
SCHEDULES = ["constant", "cosine", "warmup_cosine", "linear"]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("kind,momentum", OPTS)
def test_optimizer_matches_optax(kind, momentum, clip, schedule):
    over = (f"optimizer.kind={kind}", f"optimizer.clip_norm={clip or 'null'}",
            f"optimizer.momentum={momentum or 'null'}",
            f"optimizer.schedule={schedule}", "optimizer.warmup_steps=2",
            "optimizer.decay_steps=6", "optimizer.lr=0.1",
            "optimizer.lr_min_ratio=0.2")
    j_opt = jb.build_optimizer(jcfg.load(BASE, over))
    t_opt = tb.build_optimizer(tcfg.load(BASE, over))
    rng = np.random.default_rng(0)
    p_j = {"params/a/kernel": rng.normal(size=(3, 4)).astype(np.float32),
           "params/a/bias": rng.normal(size=(4,)).astype(np.float32)}
    p_t = {k: t(v) for k, v in p_j.items()}
    s_j, s_t = j_opt.init(p_j), t_opt.init(p_t)
    for step in range(8):
        scale = 2.0 if step % 2 else 0.2  # clip triggers on odd steps
        g = {k: (scale * rng.normal(size=v.shape) / 3).astype(np.float32)
             for k, v in p_j.items()}
        u_j, s_j = j_opt.update(g, s_j, p_j)
        u_t, s_t = t_opt.update({k: t(v) for k, v in g.items()}, s_t)
        for k in p_j:
            np.testing.assert_allclose(u_t[k].numpy(), np.asarray(u_j[k]),
                                       rtol=1e-5, atol=1e-8)
        p_j = optax.apply_updates(p_j, u_j)
        p_t = {k: p_t[k] + u_t[k] for k in p_t}


def test_diag_shift_and_flat_order():
    kw = dict(diag_shift0=1.0, diag_shift_decay=0.9, diag_shift_min=0.05)
    for step in (0, 1, 7, 40):
        assert TSR(**kw).diag_shift(step) == pytest.approx(
            float(JSR(**kw).diag_shift(jnp.asarray(step))), rel=1e-6)
    rng = np.random.default_rng(1)
    nested = {"params": {f"RealConv_{i}": {
        "kernel": rng.normal(size=(2, 1, 2)).astype(np.float32),
        "bias": rng.normal(size=(2,)).astype(np.float32)} for i in range(12)}}
    want, _ = jax.flatten_util.ravel_pytree(nested)
    got, unravel = ravel(params_from_jax(flat_np(nested)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got)
    for k, v in flat_np(nested).items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_resolve_and_real_flags():
    from qmcnn_tpu.sr import resolve_solver as j_resolve
    from qmcnn_tpu_torch.sr import resolve_solver as t_resolve

    for args in (("auto", 64, 30, True), ("auto", 64, 300, False),
                 ("auto", 4096, 4800, True), ("pcg", 1, 1, True)):
        assert t_resolve(*args) == j_resolve(*args)
    for ov in ((), ("model.complex_params=true",),
               ("model.spin_flip_sector=-1",), ("model.phase_bias=marshall",)):
        c_j, c_t = jcfg.load(BASE, ov), tcfg.load(BASE, ov)
        assert tb.model_log_psi_is_real(c_t) == jb.model_log_psi_is_real(c_j)
    with pytest.raises(ValueError):
        TSR(solver="lsq")
    with pytest.raises(ValueError):
        TSR(solver="minsr", minsr_assembly="tree")
    assert TSR(solver="cg").solver == "cg"
    assert TSR(solver="minsr").solver == "minsr"
    cfg = dataclasses.replace(tcfg.load(BASE), sr=dataclasses.replace(
        tcfg.load(BASE).sr, enabled=False))
    assert tb.build_sr(cfg) is None


# -- the GCNN path: minSR and one full step with exchange_anti moves -----------

GCNN = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn.yaml")
GCNN_SMALL = ("lattice.shape=[4,4]", "model.channels=[2,2]",
              "sampler.n_walkers=32", "run.chunk_size=16")


def _anti_noise(step_key, m, n_props):
    """The JAX sampler's exchange_anti draws (u_move, log_u) per proposal:
    key fold_in(fold_in(step_key, t), w), split into (move, accept)."""
    u, lu = [], []
    for i in range(n_props):
        k_t = jax.random.fold_in(step_key, i)
        keys = jax.vmap(lambda w: jax.random.fold_in(k_t, w))(jnp.arange(m))
        k_move, k_acc = jax.vmap(lambda k: tuple(jax.random.split(k, 2)))(
            keys)
        u.append(np.asarray(jax.vmap(jax.random.uniform)(k_move)))
        lu.append(np.asarray(jnp.log(jax.vmap(jax.random.uniform)(k_acc))))
    return t(np.stack(u)), t(np.stack(lu))


@pytest.fixture(scope="module")
def gcnn_pair():
    """A complex, spin-flip projected 4x4 j1j2 GCNN (exchange_anti, minSR)
    built by both packages, with equal params and thermalized JAX walkers."""
    jc = jcfg.load(GCNN, GCNN_SMALL)
    vmc_j, params_j, _ = jb.build(jc)
    state_j = vmc_j.init_state(jax.random.key(3), 32, params_j)
    state_j = vmc_j.thermalize(state_j, jax.random.key(4), jnp.arange(32),
                               n_sweeps=3)
    vmc_t, _, _ = tb.build(tcfg.load(GCNN, GCNN_SMALL), device="cpu")
    params_t = params_from_jax(flat_np(params_j))
    w = state_j.walkers
    walkers_t = TWalkers(s=t(w.s), log_psi=C(t(w.log_psi.re),
                                             t(w.log_psi.im)),
                         n_accept=torch.zeros(32, dtype=torch.int32),
                         n_prop=torch.zeros(32, dtype=torch.int32))
    return dict(vmc_j=vmc_j, params_j=params_j, state_j=state_j,
                vmc_t=vmc_t, params_t=params_t, walkers_t=walkers_t)


@pytest.mark.parametrize("proportional", [False, True])
def test_minsr_matches_jax(gcnn_pair, proportional):
    """minSR delta for the complex GCNN (the J_im block is kept): rtol 1e-4
    (float32 Jacobian, Gram and Cholesky)."""
    p = gcnn_pair
    _, _, g_j, eloc_j, _ = j_energy_and_grad(
        p["vmc_j"].log_psi_fn, p["vmc_j"].ham, p["params_j"],
        p["state_j"].walkers)
    kw = dict(solver="minsr", real_log_psi=False, diag_shift0=0.5,
              proportional_shift=proportional)
    d_j, it_j, res_j = JSR(**kw).solve(
        p["vmc_j"].log_psi_fn, p["params_j"], p["state_j"].walkers.s, g_j,
        jnp.asarray(2), e_loc=eloc_j)
    d_t, it_t, res_t = TSR(**kw).solve(
        p["vmc_t"].log_psi_fn, p["params_t"], p["walkers_t"].s,
        params_from_jax(flat_np(g_j)), 2,
        e_loc=C(t(eloc_j.re), t(eloc_j.im)))
    want = flat_np(d_j)
    assert sorted(want) == sorted(d_t)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(d_t[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    assert it_t == int(it_j) == 0
    # the residual of an exact solve is float32 rounding in both packages
    assert float(res_t) < 1e-3 and float(res_j) < 1e-3
    with pytest.raises(ValueError, match="e_loc"):
        TSR(**kw).solve(p["vmc_t"].log_psi_fn, p["params_t"],
                        p["walkers_t"].s, params_from_jax(flat_np(g_j)), 2)


def test_gcnn_full_step_matches(gcnn_pair):
    """One VMC.step of the 4x4 j1j2 GCNN config (exchange_anti, minSR, SGD
    with clip and a cosine schedule) from equal params and walkers, with
    JAX's draws injected: equal walkers, energy and params."""
    p = gcnn_pair
    vmc_j, state_j = p["vmc_j"], p["state_j"]
    key = jax.random.key(11)
    new_j, m_j = vmc_j.step(state_j, key, jnp.arange(32))
    vmc_t = p["vmc_t"]
    assert vmc_t.sampler.move == "exchange_anti"
    assert vmc_t.sr.solver == "minsr" and not vmc_t.sr.real_log_psi
    state_t = TrainState(params=p["params_t"],
                         opt_state=vmc_t.optimizer.init(p["params_t"]),
                         walkers=p["walkers_t"], step=0)
    new_t, m_t = vmc_t.step(state_t, 0, torch.arange(32),
                            noise=_anti_noise(key, 32, 16))
    np.testing.assert_array_equal(new_t.walkers.s.numpy(),
                                  np.asarray(new_j.walkers.s))
    assert float(m_t.energy_re) == pytest.approx(float(m_j.energy_re),
                                                 rel=1e-5)
    assert float(m_t.energy_im) == pytest.approx(float(m_j.energy_im),
                                                 abs=1e-4)
    assert float(m_t.accept_rate) == pytest.approx(float(m_j.accept_rate))
    assert m_t.sr_iters == 0 and np.isfinite(float(m_t.sr_residual))
    for k, v in flat_np(new_j.params).items():
        np.testing.assert_allclose(new_t.params[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_gcnn_eval_forward_feeds_sampler_and_e_loc(gcnn_pair):
    """``fused_gcnn_log_psi`` (here its plain version on the CPU) gives
    the model's log psi, so E_loc through it equals E_loc through the
    model; the gradient keeps the differentiable model."""
    p = gcnn_pair
    cfg = tcfg.load(GCNN, GCNN_SMALL)
    fused = tb.fused_gcnn_log_psi(cfg, tb.build_lattice(cfg))
    s = p["walkers_t"].s
    a = fused(p["params_t"], s)
    b = p["vmc_t"].log_psi_fn(p["params_t"], s)
    np.testing.assert_allclose(a.re.numpy(), b.re.numpy(), rtol=1e-5,
                               atol=1e-5)
    w = p["walkers_t"]._replace(log_psi=a)
    kw = dict(chunk_size=16)
    e1, _, g1, _, _ = t_energy_and_grad(p["vmc_t"].log_psi_fn, p["vmc_t"].ham,
                                     p["params_t"], w, eval_log_psi_fn=fused,
                                     **kw)
    e2, _, g2, _, _ = t_energy_and_grad(p["vmc_t"].log_psi_fn, p["vmc_t"].ham,
                                     p["params_t"], w, **kw)
    assert float(e1.re) == pytest.approx(float(e2.re), rel=1e-5)
    for k in g2:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-3,
                                   atol=1e-6)


def test_cnn_eval_forward_feeds_sampler_and_e_loc(pair, monkeypatch):
    """Where ``uses_fused_cnn_forward`` holds (an eligible CNN on CUDA;
    forced here), the builder hands ``FusedCNNLogPsi`` (the sweep kernel's
    recompute mode, its plain version on CPU tensors) to the sampler and
    E_loc: the refresh, every proposal of the torch loop and the E_loc
    batch (its rows that carry an element) go through it, the gradient
    keeps the model, and the step equals the plain model's."""
    import dataclasses

    from qmcnn_tpu_torch.kernels.metropolis_sweep import FusedCNNLogPsi

    monkeypatch.setattr(tb, "uses_fused_cnn_forward", lambda cfg, dev: True)
    vmc_f, _, _ = tb.build(tcfg.load(BASE, SMALL), device="cpu")
    fused = vmc_f.eval_log_psi_fn
    assert isinstance(fused, FusedCNNLogPsi)
    assert vmc_f.sampler.log_psi_fn is fused
    assert vmc_f.log_psi_fn is not fused
    p = pair
    s = p["walkers_t"].s
    a, b = fused(p["params_t"], s), p["vmc_t"].log_psi_fn(p["params_t"], s)
    np.testing.assert_allclose(a.re.numpy(), b.re.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not bool(a.im.any())

    calls = []

    def counted(params, x):
        calls.append(x.shape[0])
        return fused(params, x)

    vmc_c = dataclasses.replace(
        vmc_f, eval_log_psi_fn=counted,
        sampler=dataclasses.replace(vmc_f.sampler, log_psi_fn=counted))
    state = TrainState(params=p["params_t"],
                       opt_state=vmc_c.optimizer.init(p["params_t"]),
                       walkers=p["walkers_t"], step=0)
    new_c, m_c = vmc_c.step(state, 5, torch.arange(64))
    new_t, m_t = p["vmc_t"].step(state, 5, torch.arange(64))
    n_props = vmc_c.sampler.n_sites
    # E_loc forwards the connected rows that carry an element, of the
    # walkers the step sampled
    mask = vmc_c.ham.connected_batch(new_c.walkers.s)[2]
    assert 0 < int(mask.sum()) < mask.numel()
    assert calls == [64] * (1 + n_props) + [int(mask.sum())]
    assert torch.equal(new_c.walkers.s, new_t.walkers.s)
    assert float(m_c.energy_re) == pytest.approx(float(m_t.energy_re),
                                                 rel=1e-5)
    for k, v in new_t.params.items():
        np.testing.assert_allclose(new_c.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
