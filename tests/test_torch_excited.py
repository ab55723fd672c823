"""PyTorch port, slice 10: excited states (``ops/penalty.py``: the
two-chain overlap, the additive penalty, the exact deflation) and the
parameter EMA, against the JAX package on equal inputs.

Inputs: an N = 8 chain complex RBM (the model of tests/test_penalty.py),
its params made by JAX and copied; live walkers and frozen batches drawn
by numpy from a seed or by exact inverse-CDF over the 2^8 enumeration.
Tolerances: values and gradients rtol 1e-4 (float32 in another summation
order); the enumeration oracles at tests/test_penalty.py's rtol 0.03 (the
frozen chain's Monte Carlo error)."""
import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.models.rbm import LogPsiRBM as JRBM
from qmcnn_tpu.ops import penalty as jpen
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu.vmc import energy_and_grad as j_energy_and_grad
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.rbm import LogPsiRBM as TRBM
from qmcnn_tpu_torch.ops import penalty as tpen
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler.metropolis import WalkerState, fold_in, prng_key
from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from qmcnn_tpu_torch.vmc import TrainState
from qmcnn_tpu_torch.vmc import energy_and_grad as t_energy_and_grad
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
         "model.param_scale=0.1", "sampler.n_walkers=32",
         "sampler.n_therm_sweeps=2", "run.n_steps=2", "run.log_every=1",
         "sr.cg_tol=1.0e-6", "sr.cg_maxiter=60")


def t(x):
    return torch.from_numpy(np.array(x))


def flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def all_configs(n):
    return np.array(list(itertools.product([-1.0, 1.0], repeat=n)),
                    np.float32)


@pytest.fixture(scope="module")
def rbm():
    """Two complex chain RBMs (the live and the frozen params), both
    packages' log psi functions."""
    kw = dict(lattice_shape=(N,), alpha=2, complex_params=True,
              param_scale=0.3)
    jm, tm = JRBM(**kw), TRBM(**kw)
    v_f = jm.init(jax.random.key(1), jnp.ones((1, N), jnp.float32))
    v = jm.init(jax.random.key(2), jnp.ones((1, N), jnp.float32))
    return dict(jfn=lambda p, s: j_apply(jm, p, s),
                tfn=lambda p, s: t_apply(tm, p, s), v_f=v_f, v=v,
                p_f=params_from_jax(flat_np(v_f)),
                p=params_from_jax(flat_np(v)))


def exact_batch(fn, params, m0, seed, to_torch=False):
    """An exact |psi|^2 sample of ``m0`` configurations (numpy inverse-CDF
    over the enumeration)."""
    s_all = all_configs(N)
    lp = fn(params, t(s_all) if to_torch else jnp.asarray(s_all))
    re = np.asarray(lp.re, np.float64)
    p = np.exp(2.0 * (re - re.max()))
    idx = np.random.default_rng(seed).choice(len(p), size=m0, p=p / p.sum())
    return s_all[idx]


def _close(got, want, what, rtol=1e-4):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=rtol,
                                   atol=rtol * scale, err_msg=f"{what} {k}")


def test_penalty_matches_jax(rbm):
    """overlap_sq through penalty_value_and_grad: the value and the clipped
    beta-scaled gradient, live walkers and frozen batch from numpy."""
    rng = np.random.default_rng(0)
    live = (2.0 * rng.integers(0, 2, size=(256, N)) - 1.0).astype(np.float32)
    s0 = exact_batch(rbm["jfn"], rbm["v_f"], 512, seed=1)
    jfz = jpen.make_frozen_state(rbm["jfn"], rbm["v_f"], jnp.asarray(s0))
    tfz = tpen.make_frozen_state(rbm["tfn"], rbm["p_f"], t(s0))
    np.testing.assert_allclose(tfz.lp_frozen.re.numpy(),
                               np.asarray(jfz.lp_frozen.re), rtol=1e-5,
                               atol=1e-5)
    for beta, clip in ((2.0, 1.0), (0.5, 100.0)):
        f_j, g_j = jpen.penalty_value_and_grad(
            rbm["jfn"], rbm["v"], jnp.asarray(live), [jfz], beta,
            clip_norm=clip)
        f_t, g_t = tpen.penalty_value_and_grad(
            rbm["tfn"], rbm["p"], t(live), [tfz], beta, clip_norm=clip)
        assert float(f_t) == pytest.approx(float(f_j), rel=1e-4)
        _close(g_t, flat_np(g_j), f"penalty grad beta={beta}")
    # overlap_sq alone on the four log psi arrays
    lp = rbm["tfn"](rbm["p"], t(live))
    lpk = rbm["tfn"](rbm["p_f"], t(live))
    lpf = rbm["tfn"](rbm["p"], t(s0))
    jl = rbm["jfn"](rbm["v"], jnp.asarray(live))
    jk = rbm["jfn"](rbm["v_f"], jnp.asarray(live))
    jf = rbm["jfn"](rbm["v"], jnp.asarray(s0))
    assert float(tpen.overlap_sq(lp, lpk, lpf, tfz.lp_frozen)) == \
        pytest.approx(float(jpen.overlap_sq(jl, jk, jf, jfz.lp_frozen)),
                      rel=1e-4)


def test_penalty_matches_enumeration_and_collapse(rbm):
    """The two-chain F against the enumerated overlap with an exact live
    chain (uniform psi), F(psi, psi) = 1, and F < 1 with a non-zero
    gradient when the live walkers collapse onto one configuration."""
    s_all = all_configs(N)
    zero = {k: torch.zeros_like(v) for k, v in rbm["p"].items()}
    tfz = tpen.make_frozen_state(rbm["tfn"], rbm["p_f"], t(exact_batch(
        rbm["tfn"], rbm["p_f"], 200_000, 0, to_torch=True)))
    f_mc, _ = tpen.penalty_value_and_grad(rbm["tfn"], zero, t(s_all), [tfz],
                                          beta=1.0)
    lp = rbm["tfn"](rbm["p_f"], t(s_all))
    psi = np.exp(lp.re.double().numpy() - float(lp.re.max())
                 + 1j * lp.im.double().numpy())
    psi /= np.linalg.norm(psi)
    f_exact = abs(psi.sum()) ** 2 / len(s_all)
    np.testing.assert_allclose(float(f_mc), f_exact, rtol=0.03)
    # deflation's expectation identity on the same chains
    d_loc, overlap = tpen.deflation_e_loc(rbm["tfn"], zero, t(s_all),
                                          rbm["tfn"](zero, t(s_all)), [tfz])
    np.testing.assert_allclose(float(d_loc.re.mean()), f_exact, rtol=0.03)
    np.testing.assert_allclose(float(overlap), f_exact, rtol=0.03)
    assert abs(float(d_loc.im.mean())) < 0.03 * f_exact + 1e-5

    live = t(exact_batch(rbm["tfn"], rbm["p"], 4096, 1, to_torch=True))
    own = tpen.make_frozen_state(rbm["tfn"], rbm["p"], t(exact_batch(
        rbm["tfn"], rbm["p"], 4096, 2, to_torch=True)))
    f, g = tpen.penalty_value_and_grad(rbm["tfn"], rbm["p"], live, [own],
                                       beta=2.0)
    np.testing.assert_allclose(float(f), 1.0, rtol=0.05)
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    collapsed = t(np.tile(s_all[3][None, :], (256, 1)))
    f, g = tpen.penalty_value_and_grad(rbm["tfn"], rbm["p"], collapsed,
                                       [tfz], beta=1.0)
    assert not np.isclose(float(f), 1.0, atol=1e-4)
    assert sum(float(v.abs().sum()) for v in g.values()) > 1e-6


@pytest.mark.parametrize("chunk", [None, 64])
def test_deflation_e_loc_matches_jax(rbm, chunk):
    """deflation_e_loc (d_loc C[M] and the overlap), unchunked and in
    chunks of 64 (``over_walker_chunks``), with one and with two frozen
    states."""
    rng = np.random.default_rng(4)
    live = (2.0 * rng.integers(0, 2, size=(256, N)) - 1.0).astype(np.float32)
    s0 = exact_batch(rbm["jfn"], rbm["v_f"], 384, seed=5)
    s1 = exact_batch(rbm["jfn"], rbm["v"], 256, seed=6)
    jfz = [jpen.make_frozen_state(rbm["jfn"], rbm["v_f"], jnp.asarray(s0)),
           jpen.make_frozen_state(rbm["jfn"], rbm["v"], jnp.asarray(s1))]
    tfz = [tpen.make_frozen_state(rbm["tfn"], rbm["p_f"], t(s0)),
           tpen.make_frozen_state(rbm["tfn"], rbm["p"], t(s1))]
    for k in (1, 2):
        lp_j = rbm["jfn"](rbm["v"], jnp.asarray(live))
        d_j, o_j = jpen.deflation_e_loc(rbm["jfn"], rbm["v"],
                                        jnp.asarray(live), lp_j, jfz[:k],
                                        chunk_size=chunk)
        lp_t = rbm["tfn"](rbm["p"], t(live))
        d_t, o_t = tpen.deflation_e_loc(rbm["tfn"], rbm["p"], t(live), lp_t,
                                        tfz[:k], chunk_size=chunk)
        for part in ("re", "im"):
            np.testing.assert_allclose(getattr(d_t, part).numpy(),
                                       np.asarray(getattr(d_j, part)),
                                       rtol=1e-4, atol=1e-5)
        assert float(o_t) == pytest.approx(float(o_j), rel=1e-4)


@pytest.fixture(scope="module")
def heis_pair(tmp_path_factory):
    """The 4x4 Heisenberg CNN built by both packages with deflate_c = 2 and
    EMA 0.9, equal params, thermalized JAX walkers, and one frozen state
    (the params perturbed, its batch drawn by numpy) given to both."""
    jc = jcfg.load(HEIS, SMALL + ("optimizer.deflate_c=2.0",
                                  "optimizer.ema_decay=0.9"))
    vmc_j, params_j, _ = jb.build(jc)
    state_j = vmc_j.init_state(jax.random.key(3), 32, params_j)
    state_j = vmc_j.thermalize(state_j, jax.random.key(4), jnp.arange(32),
                               n_sweeps=4)
    rng = np.random.default_rng(7)
    pk_j = jax.tree_util.tree_map(
        lambda x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32),
        params_j)
    base = np.array([1.0] * 8 + [-1.0] * 8, np.float32)
    s0 = np.stack([rng.permutation(base) for _ in range(64)])
    fz_j = jpen.make_frozen_state(vmc_j.log_psi_fn, pk_j, jnp.asarray(s0))
    vmc_j = dataclasses.replace(vmc_j, penalty_states=(fz_j,))
    vmc_t, _, _ = tb.build(tcfg.load(HEIS, SMALL + (
        "optimizer.deflate_c=2.0", "optimizer.ema_decay=0.9")), device="cpu")
    fz_t = tpen.make_frozen_state(vmc_t.eval_log_psi_fn,
                                  params_from_jax(flat_np(pk_j)), t(s0))
    vmc_t = dataclasses.replace(vmc_t, penalty_states=(fz_t,))
    w = state_j.walkers
    walkers_t = WalkerState(s=t(w.s), log_psi=C(t(w.log_psi.re),
                                                t(w.log_psi.im)),
                            n_accept=torch.zeros(32, dtype=torch.int32),
                            n_prop=torch.zeros(32, dtype=torch.int32))
    return dict(vmc_j=vmc_j, state_j=state_j, params_j=params_j,
                vmc_t=vmc_t, walkers_t=walkers_t,
                params_t=params_from_jax(flat_np(params_j)))


def test_energy_and_grad_deflate_matches_jax(heis_pair):
    """energy_and_grad(deflate=(frozen, c)): the physical e_mean / e_var,
    the deflated e_loc, the overlap and the gradient (centred on the
    deflated mean)."""
    p = heis_pair
    defl = (p["vmc_j"].penalty_states, 2.0)
    e_j, v_j, g_j, el_j, o_j = j_energy_and_grad(
        p["vmc_j"].log_psi_fn, p["vmc_j"].ham, p["params_j"],
        p["state_j"].walkers, deflate=defl)
    e_t, v_t, g_t, el_t, o_t = t_energy_and_grad(
        p["vmc_t"].log_psi_fn, p["vmc_t"].ham, p["params_t"], p["walkers_t"],
        deflate=(p["vmc_t"].penalty_states, 2.0))
    assert float(e_t.re) == pytest.approx(float(e_j.re), rel=1e-5)
    assert float(v_t) == pytest.approx(float(v_j), rel=1e-4)
    assert float(o_t) == pytest.approx(float(o_j), rel=1e-4)
    assert np.isfinite(float(o_t)) and float(o_t) > 0.0
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(el_t, part).numpy(),
                                   np.asarray(getattr(el_j, part)),
                                   rtol=1e-4, atol=1e-4)
    _close(g_t, flat_np(g_j), "deflated gradient")
    # without deflation the overlap slot is 0 and e_loc is H's
    *_, el0, o0 = t_energy_and_grad(p["vmc_t"].log_psi_fn, p["vmc_t"].ham,
                                    p["params_t"], p["walkers_t"])
    assert float(o0) == 0.0 and not torch.allclose(el0.re, el_t.re)


def _jax_noise(step_key, m, n_props, n_choices):
    """The JAX sampler's (choices, log_u) for flip / exchange moves."""
    ch, lu = [], []
    for i in range(n_props):
        k_t = jax.random.fold_in(step_key, i)
        keys = jax.vmap(lambda w: jax.random.fold_in(k_t, w))(jnp.arange(m))
        k_move, k_acc = jax.vmap(lambda k: tuple(jax.random.split(k, 2)))(
            keys)
        ch.append(np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, n_choices))(k_move)))
        lu.append(np.asarray(jnp.log(jax.vmap(jax.random.uniform)(k_acc))))
    return t(np.stack(ch)), t(np.stack(lu))


def test_deflated_step_and_ema_match_jax(heis_pair):
    """One VMC.step with the deflation and the EMA (pcg SR, SGD with a
    cosine schedule), JAX's draws injected: equal walkers, energy and
    overlap, params and EMA within the SR tolerance of
    tests/test_torch_vmc_sr.py (rtol 2e-3), and the EMA exactly
    d ema + (1 - d) params of the port's own step."""
    p = heis_pair
    vmc_j, state_j = p["vmc_j"], p["state_j"]
    key = jax.random.key(11)
    new_j, m_j = vmc_j.step(state_j, key, jnp.arange(32))
    vmc_t = p["vmc_t"]
    params = p["params_t"]
    state_t = TrainState(params=params, opt_state=vmc_t.optimizer.init(params),
                         walkers=p["walkers_t"], step=0,
                         ema={k: v.clone() for k, v in params.items()})
    noise = _jax_noise(key, 32, 16, len(vmc_t.sampler.bonds))
    new_t, m_t = vmc_t.step(state_t, 0, torch.arange(32), noise=noise)
    np.testing.assert_array_equal(new_t.walkers.s.numpy(),
                                  np.asarray(new_j.walkers.s))
    assert float(m_t.energy_re) == pytest.approx(float(m_j.energy_re),
                                                 rel=1e-5)
    assert float(m_t.overlap) == pytest.approx(float(m_j.overlap), rel=1e-4)
    _close(new_t.params, flat_np(new_j.params), "params", rtol=2e-3)
    _close(new_t.ema, flat_np(new_j.ema), "ema", rtol=2e-3)
    for k, e in new_t.ema.items():
        assert torch.equal(e, 0.9 * params[k] + (1.0 - 0.9)
                           * new_t.params[k]), k


def test_ema_recurrence_and_noninterference():
    """EMA on or off, the params follow the same trajectory bitwise; the
    EMA is the recurrence seeded at the init params."""
    d = 0.75

    def run(over):
        vmc, params, _ = tb.build(tcfg.load(HEIS, SMALL + over), device="cpu")
        state = vmc.init_state(prng_key(0), 32, params)
        traj = []
        for i in range(3):
            state, _ = vmc.step(state, fold_in(prng_key(1), i),
                                torch.arange(32))
            traj.append(state.params)
        return params, state, traj

    _, off, traj_off = run(())
    params, on, traj_on = run((f"optimizer.ema_decay={d}",))
    assert off.ema is None
    for a, b in zip(traj_off, traj_on):
        assert all(torch.equal(a[k], b[k]) for k in a)
    manual = dict(params)
    for step in traj_on:
        manual = {k: d * manual[k] + (1 - d) * step[k] for k in manual}
    for k, v in manual.items():
        assert torch.equal(on.ema[k], v), k


def test_ema_checkpoint_roundtrip_and_snapshots(tmp_path):
    """train() with a checkpoint every step: the EMA is saved and restored
    bitwise, a resumed run carries it on, a checkpoint without EMA restores
    it as the params; '<csv>.ema.npz' has the params' keys and loads in the
    JAX package's warm_start."""
    from qmcnn_tpu.utils.transfer import warm_start as j_warm_start
    from qmcnn_tpu_torch.train import train

    csv = str(tmp_path / "run.csv")
    over = ("optimizer.ema_decay=0.9", f"run.csv_path={csv}",
            f"run.ckpt_dir={tmp_path / 'ckpt'}", "run.ckpt_every=1")
    cfg = tcfg.load(HEIS, SMALL + over)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state, _ = train(cfg, device="cpu", ckpt_manager=mgr)
    restored = mgr.restore(state)
    for k in state.ema:
        assert torch.equal(restored.ema[k], state.ema[k])
    assert any(not torch.equal(state.ema[k], state.params[k])
               for k in state.ema)
    state3, _ = train(tcfg.load(HEIS, SMALL + over + ("run.n_steps=3",)),
                      device="cpu", ckpt_manager=mgr)
    assert state3.step == 3 and not torch.equal(
        state3.ema["params/RealConv_0/kernel"],
        state.ema["params/RealConv_0/kernel"])
    plain = tb.build(tcfg.load(HEIS, SMALL), device="cpu")[0]
    CheckpointManager(str(tmp_path / "plain")).save(
        0, plain.init_state(prng_key(0), 32, state.params))
    again = CheckpointManager(str(tmp_path / "plain")).restore(state)
    for k in again.ema:
        assert torch.equal(again.ema[k], again.params[k])

    with np.load(csv + ".ema.npz") as z:
        ema = {k: z[k] for k in z.files}
    with np.load(csv + ".params.npz") as z:
        assert sorted(z.files) == sorted(ema)
    for k, v in state3.ema.items():
        np.testing.assert_array_equal(ema[k], v.numpy())
    _, j_params, _ = jb.build(jcfg.load(HEIS, SMALL))
    merged = j_warm_start(j_params, csv + ".ema.npz")
    for k, v in flat_np(merged).items():
        np.testing.assert_array_equal(v, ema[k])
