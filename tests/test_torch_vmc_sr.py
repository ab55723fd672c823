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
    e_t, v_t, g_t, eloc_t = t_energy_and_grad(
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
    with pytest.raises(NotImplementedError):
        TSR(solver="minsr")
    cfg = dataclasses.replace(tcfg.load(BASE), sr=dataclasses.replace(
        tcfg.load(BASE).sr, enabled=False))
    assert tb.build_sr(cfg) is None
