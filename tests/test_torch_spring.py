"""PyTorch port, slice 8: SPRING (``SR.solve_spring``, momentum minSR;
Goldshlager, Abrahamsen & Lin, arXiv:2401.10190) against the JAX package,
its carry ``TrainState.sr_aux`` through VMC steps, checkpoints and the NaN
rollback.

The JAX cases follow tests/test_sr.py's SPRING tests on equal inputs. The
flat order of the port's ``ravel`` need not be ``ravel_pytree``'s, so every
delta is compared unravelled, key by key. Tolerances: deltas and the
parameters rtol 2e-3 (a Cholesky solve in float32 amplifies the rounding
of the scores by the condition number of the shifted Gram); the mu = 0
case against the port's own minSR rtol 1e-5. The residual of a direct
solve is f32 rounding in both packages: the relative residuals agree
within 2e-3 (and within rtol 2e-3 where they are larger, on the GCNN)."""
import os

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.ops.cplx import C as JC
from qmcnn_tpu.sampler.metropolis import WalkerState as JW
from qmcnn_tpu.sr import SR as JSR
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.vmc import energy_and_grad as j_energy_and_grad
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import train as ttrain
from qmcnn_tpu_torch import vmc as tvmc
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import WalkerState, prng_key
from qmcnn_tpu_torch.sr import SR as TSR
from qmcnn_tpu_torch.sr import ravel
from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCNN = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn.yaml")
#: the complex, spin-flip projected GCNN at a CPU size, with SPRING
GCNN_SPRING = ("lattice.shape=[4,4]", "model.channels=[2,2]",
               "sampler.n_walkers=32", "sampler.n_therm_sweeps=2",
               "run.chunk_size=16", "sr.momentum=0.9", "sr.diag_shift0=0.01",
               "sr.diag_shift_decay=1.0", "sr.diag_shift_min=0.01",
               "run.log_every=1", "run.steps_per_dispatch=1",
               "run.csv_path=null")
N, M = 6, 40


def flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def t(x):
    return torch.from_numpy(np.array(x))


def assert_tree_close(got, want, rtol, what=""):
    """Port params dict against a flat JAX dict, key by key, with an atol
    of rtol x the largest entry."""
    assert sorted(got) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=rtol,
                                   atol=rtol * scale, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def case():
    """tests/test_sr.py's SPRING fixture: the complex chain CNN, M = 40
    configurations, numpy-seeded local energies and the exact gradient."""
    model = JCNN(lattice_shape=(N,), channels=(3,), param_scale=0.3,
                 complex_params=True)
    v = model.init(jax.random.key(3), jnp.ones((1, N), jnp.float32))
    s = np.asarray(2.0 * jax.random.bernoulli(jax.random.key(0), 0.5, (M, N))
                   - 1.0, np.float32)
    rng = np.random.default_rng(11)
    e_re = rng.normal(size=M).astype(np.float32)
    e_im = rng.normal(size=M).astype(np.float32)

    def log_psi_j(p, x):
        return j_apply(model, p, x)

    flatp, unravel = jax.flatten_util.ravel_pytree(v)

    def f(part):
        return lambda fp, si: getattr(log_psi_j(unravel(fp), si[None, :]),
                                      part)[0]

    j_re = np.asarray(jax.vmap(jax.grad(f("re")), (None, 0))(flatp, s))
    j_im = np.asarray(jax.vmap(jax.grad(f("im")), (None, 0))(flatp, s))
    f_vec = ((j_re - j_re.mean(0)).T @ (e_re - e_re.mean())
             + (j_im - j_im.mean(0)).T @ (e_im - e_im.mean())) / M
    grads = unravel(jnp.asarray(f_vec.astype(np.float32)))
    tm = TCNN(lattice_shape=(N,), channels=(3,), param_scale=0.3,
              complex_params=True)
    return dict(v=v, s=s, log_psi_j=log_psi_j, grads_j=grads,
                e_j=JC(jnp.asarray(e_re), jnp.asarray(e_im)),
                p=params_from_jax(flat_np(v)), grads=params_from_jax(
                    flat_np(grads)), e=C(t(e_re), t(e_im)),
                log_psi=lambda p, x: t_apply(tm, p, x), n_params=flatp.size)


def _kw(shift):
    return dict(solver="minsr", diag_shift0=shift, diag_shift_decay=1.0,
                diag_shift_min=shift)


def test_spring_mu0_equals_plain_minsr(case):
    want, _, _ = TSR(**_kw(0.1)).solve(case["log_psi"], case["p"],
                                       t(case["s"]), case["grads"], 0,
                                       e_loc=case["e"])
    d0 = torch.zeros(case["n_params"])
    got, iters, res, carry = TSR(momentum=0.0, **_kw(0.1)).solve_spring(
        case["log_psi"], case["p"], t(case["s"]), case["grads"], 0, d0,
        e_loc=case["e"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    np.testing.assert_array_equal(carry.numpy(), ravel(got)[0].numpy())
    assert iters == 0 and float(res) < 1e-3


@pytest.mark.parametrize("mu,shift", [(0.7, 0.05), (0.9, 0.01)])
def test_spring_matches_jax(case, mu, shift):
    """delta (unravelled) and the residual against F + shift mu delta_prev,
    from the same delta_prev (numpy-seeded, given to each package in its
    own flat order)."""
    d_prev_j = (np.random.default_rng(13).normal(size=case["n_params"])
                * 0.05).astype(np.float32)
    _, unravel_j = jax.flatten_util.ravel_pytree(case["v"])
    d_prev_t = ravel(params_from_jax(flat_np(unravel_j(
        jnp.asarray(d_prev_j)))))[0]
    dj, _, res_j, carry_j = JSR(momentum=mu, **_kw(shift)).solve_spring(
        case["log_psi_j"], case["v"], case["s"], case["grads_j"],
        jnp.asarray(0), jnp.asarray(d_prev_j), e_loc=case["e_j"])
    dt, _, res_t, carry_t = TSR(momentum=mu, **_kw(shift)).solve_spring(
        case["log_psi"], case["p"], t(case["s"]), case["grads"], 0,
        d_prev_t, e_loc=case["e"])
    assert_tree_close(dt, flat_np(dj), 2e-3, "delta")
    np.testing.assert_array_equal(carry_t.numpy(), ravel(dt)[0].numpy())
    np.testing.assert_allclose(carry_j, jax.flatten_util.ravel_pytree(dj)[0])
    # the residual ||(S + shift) delta - F - shift mu delta_prev|| / ||rhs||
    # of a direct solve is f32 rounding (1e-5 here) in both packages: the
    # two relative residuals agree within 2e-3
    assert abs(float(res_t) - float(res_j)) < 2e-3
    assert float(res_t) < 1e-3 and float(res_j) < 1e-3


def test_spring_refusals(case):
    d0 = torch.zeros(case["n_params"])
    with pytest.raises(ValueError, match="minsr"):
        TSR(solver="pcg", momentum=0.9).solve_spring(
            case["log_psi"], case["p"], t(case["s"]), case["grads"], 0, d0,
            e_loc=case["e"])
    with pytest.raises(ValueError, match="e_loc"):
        TSR(momentum=0.9, **_kw(0.1)).solve_spring(
            case["log_psi"], case["p"], t(case["s"]), case["grads"], 0, d0)
    cfg = tcfg.load(GCNN, GCNN_SPRING + ("sr.solver=pcg",))
    with pytest.raises(ValueError, match="requires solver='minsr'"):
        tb.build(cfg, device="cpu")


def test_three_spring_steps_match_jax():
    """3 SPRING steps of the complex spin-flip GCNN from shared parameters,
    the walkers injected (numpy-seeded configurations in place of each
    package's sampler): E_loc, the covariance gradient, solve_spring with
    delta carried from step to step, and the SGD update, in both packages.
    delta and the parameters after every step agree within rtol 2e-3."""
    vmc_j, params_j, _ = jb.build(jcfg.load(GCNN, GCNN_SPRING))
    vmc_t, _, _ = tb.build(tcfg.load(GCNN, GCNN_SPRING), device="cpu")
    assert vmc_j.sr.momentum == vmc_t.sr.momentum == 0.9
    p_t = params_from_jax(flat_np(params_j))
    opt_j, opt_t = vmc_j.optimizer.init(params_j), vmc_t.optimizer.init(p_t)
    carry_j = jnp.zeros_like(jax.flatten_util.ravel_pytree(params_j)[0])
    carry_t = torch.zeros(carry_j.size)
    rng = np.random.default_rng(21)
    for step in range(3):
        s = (2.0 * rng.integers(0, 2, (32, 16)) - 1.0).astype(np.float32)
        walkers_j = JW(s=jnp.asarray(s),
                       log_psi=vmc_j.log_psi_fn(params_j, jnp.asarray(s)),
                       n_accept=jnp.zeros(32, jnp.int32),
                       n_prop=jnp.zeros(32, jnp.int32))
        _, _, g_j, e_j, _ = j_energy_and_grad(
            vmc_j.log_psi_fn, vmc_j.ham, params_j, walkers_j, chunk_size=16)
        d_j, _, res_j, carry_j = vmc_j.sr.solve_spring(
            vmc_j.log_psi_fn, params_j, jnp.asarray(s), g_j,
            jnp.asarray(step), carry_j, e_loc=e_j)
        upd, opt_j = vmc_j.optimizer.update(d_j, opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)

        s_t = t(s)
        walkers_t = WalkerState(
            s=s_t, log_psi=vmc_t.log_psi_fn(p_t, s_t),
            n_accept=torch.zeros(32, dtype=torch.int32),
            n_prop=torch.zeros(32, dtype=torch.int32))
        _, _, g_t, e_t, _ = tvmc.energy_and_grad(
            vmc_t.log_psi_fn, vmc_t.ham, p_t, walkers_t, chunk_size=16)
        d_t, _, res_t, carry_t = vmc_t.sr.solve_spring(
            vmc_t.log_psi_fn, p_t, s_t, g_t, step, carry_t, e_loc=e_t)
        upd_t, opt_t = vmc_t.optimizer.update(d_t, opt_t)
        p_t = {k: p_t[k] + upd_t[k] for k in p_t}

        assert_tree_close(d_t, flat_np(d_j), 2e-3, f"step {step} delta")
        assert_tree_close(p_t, flat_np(params_j), 2e-3, f"step {step}")
        assert float(res_t) == pytest.approx(float(res_j), rel=2e-3,
                                             abs=1e-6)
        np.testing.assert_array_equal(carry_t.numpy(),
                                      ravel(d_t)[0].numpy())


def test_vmc_step_carries_delta():
    """VMC.step with sr.momentum > 0: the carry starts at zeros, is the
    step's delta after it, and moves with every step; with momentum 0 the
    state carries none."""
    vmc, params, _ = tb.build(tcfg.load(GCNN, GCNN_SPRING), device="cpu")
    state = vmc.init_state(prng_key(0), 32, params)
    assert state.sr_aux is not None and not state.sr_aux.any()
    assert state.sr_aux.shape == (sum(v.numel() for v in params.values()),)
    ids = torch.arange(32)
    s1, m1 = vmc.step(state, prng_key(1), ids)
    assert s1.sr_aux.any() and torch.isfinite(s1.sr_aux).all()
    assert float(m1.sr_residual) < 1e-2 and m1.sr_iters == 0
    s2, _ = vmc.step(s1, prng_key(2), ids)
    assert not torch.equal(s2.sr_aux, s1.sr_aux)
    plain, params, _ = tb.build(tcfg.load(GCNN, GCNN_SPRING + (
        "sr.momentum=0.0",)), device="cpu")
    st = plain.init_state(prng_key(0), 32, params)
    assert st.sr_aux is None
    assert plain.step(st, prng_key(1), ids)[0].sr_aux is None


def _assert_states_equal(a, b):
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.sr_aux, b.sr_aux)
    for x, y in ((a.walkers.s, b.walkers.s),
                 (a.walkers.log_psi.re, b.walkers.log_psi.re),
                 (a.walkers.log_psi.im, b.walkers.log_psi.im)):
        assert torch.equal(x, y)


def test_checkpoint_round_trips_delta_and_resume_is_bitwise(tmp_path,
                                                            capsys):
    """4 SPRING steps checkpointed every 2: the saved carry restores
    bitwise, a run resumed from step 2 at the same n_steps ends in the
    uninterrupted run's state bit for bit, and a warm start from the
    snapshot begins at delta = 0."""
    cfg = tcfg.load(GCNN, GCNN_SPRING + ("run.n_steps=4",
                                         "run.ckpt_every=2"))
    full = tmp_path / "full"
    state, logger = ttrain.train(cfg, device="cpu", ckpt_manager=(
        CheckpointManager(str(full), keep=3)))
    mgr = CheckpointManager(str(full), keep=3)
    back = mgr.restore(state)
    _assert_states_equal(back, state)
    assert back.sr_aux is not state.sr_aux and back.sr_aux.any()
    part = tmp_path / "part"
    part_mgr = CheckpointManager(str(part), keep=3)
    part_mgr.save(2, mgr.restore(state, step=2))
    capsys.readouterr()
    resumed, logger2 = ttrain.train(cfg, device="cpu", ckpt_manager=part_mgr)
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    _assert_states_equal(resumed, state)
    assert logger2.history["energy_re"] == logger.history["energy_re"][2:]
    # a checkpoint without a carry (saved by a run without SPRING) restores
    # into a SPRING state at delta = 0
    no_aux = CheckpointManager(str(tmp_path / "plain"), keep=1)
    no_aux.save(4, state._replace(sr_aux=None))
    assert not no_aux.restore(state).sr_aux.any()
    # a warm start begins at delta = 0
    vmc, params, _ = tb.build(cfg, device="cpu")
    warm = vmc.init_state(prng_key(0), 32, state.params)
    assert not warm.sr_aux.any()


def test_rollback_restores_delta(tmp_path, monkeypatch, capsys):
    """A NaN energy at step 3 rolls back to the step-2 checkpoint: the
    retried step starts from the checkpoint's carry, bit for bit the one
    step 3 first started from."""
    cfg = tcfg.load(GCNN, GCNN_SPRING + ("run.n_steps=4", "run.ckpt_every=1",
                                         "run.nan_max_retries=1"))
    real = tvmc.VMC.run_steps
    seen = []
    left = {2}

    def run_steps(self, state, base_key, walker_ids, n_steps):
        seen.append((state.step, state.sr_aux.clone()))
        new, metrics = real(self, state, base_key, walker_ids, n_steps)
        if state.step in left:
            left.discard(state.step)
            metrics = [metrics[0]._replace(
                energy_re=torch.tensor(float("nan")))] + metrics[1:]
        return new, metrics

    monkeypatch.setattr(tvmc.VMC, "run_steps", run_steps)
    state, _ = ttrain.train(cfg, device="cpu", ckpt_manager=(
        CheckpointManager(str(tmp_path / "r"), keep=2)))
    assert "rolled back to checkpoint step 2" in capsys.readouterr().out
    assert [s for s, _ in seen] == [0, 1, 2, 2, 3]
    assert not seen[0][1].any() and seen[2][1].any()
    assert torch.equal(seen[2][1], seen[3][1])
    assert state.step == 4 and state.sr_aux.any()
