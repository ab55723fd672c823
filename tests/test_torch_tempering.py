"""PyTorch port, slice 10: parallel tempering (``MetropolisSampler(betas=)``,
the builder's tempering wiring, and tempering under walker sharding).

The JAX sampler's tempered draws are computed here with ``jax.random`` and
fed to the port's ``noise=(choices, log_u, swap_log_u)``: the proposal
streams fold ``split(step_key)[0]`` with the proposal index, then the row
id i * R + r; the exchange passes fold ``split(step_key)[1]`` with the
sweep, then the pair, then the physical walker id. Decisions (walkers,
counters) must be equal and log psi within rtol 1e-4 (float32, another
summation order: tests/test_torch_sweep.py's tolerance)."""
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
from qmcnn_tpu.lattice import chain as jchain
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.sampler.metropolis import MetropolisSampler as JSampler
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler import metropolis as tsm
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests import torch_dist_ranks as R
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
BETAS = (1.0, 0.6, 0.3)
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
SMALL = ("lattice.shape=[4,4]", "model.channels=[3,3]",
         "sampler.n_walkers=16", "sampler.n_therm_sweeps=2",
         "run.n_steps=1", "run.log_every=1", "run.csv_path=null",
         "sampler.tempering_betas=[1.0,0.6,0.3]")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def chain_pair():
    """The 8-site chain CNN of tests/test_tempering.py in both packages."""
    kw = dict(lattice_shape=(N,), channels=(4,), param_scale=0.3)
    jm = JCNN(**kw)
    v = jm.init(jax.random.key(7), jnp.ones((1, N), jnp.float32))
    p = params_from_jax({k: np.asarray(x) for k, x in _flatten(v).items()})
    return jm, v, TCNN(**kw), p


def jax_tempered_noise(step_key, m, r, n_sweeps, ss, n_choices):
    """The JAX tempered sampler's draws: (choices, log_u) per proposal and
    row [n_props, m * r] (the site or bond; u_move for exchange_anti, with
    ``n_choices=None``), and the exchange log-uniforms
    [n_sweeps, r - 1, m]."""
    prop_key, swap_key = jax.random.split(step_key)
    row_ids = (jnp.arange(m)[:, None] * r + jnp.arange(r)[None, :]
               ).reshape(-1)
    first, lu = [], []
    for i in range(n_sweeps * ss):
        k_t = jax.random.fold_in(prop_key, i)
        keys = jax.vmap(lambda w: jax.random.fold_in(k_t, w))(row_ids)
        k_move, k_acc = jax.vmap(lambda k: tuple(jax.random.split(k, 2)))(
            keys)
        if n_choices is not None:
            first.append(np.asarray(jax.vmap(
                lambda k: jax.random.randint(k, (), 0, n_choices))(k_move)))
        else:
            first.append(np.asarray(jax.vmap(jax.random.uniform)(k_move)))
        lu.append(np.asarray(jnp.log(jax.vmap(jax.random.uniform)(k_acc))))
    swaps = []
    for u in range(n_sweeps):
        k_u = jax.random.fold_in(swap_key, u)
        rows = []
        for j in range(r - 1):
            k_j = jax.random.fold_in(k_u, j)
            rows.append(np.asarray(jnp.log(jax.vmap(
                lambda w: jax.random.uniform(jax.random.fold_in(k_j, w)))(
                    jnp.arange(m)))))
        swaps.append(np.stack(rows))
    return t(np.stack(first)), t(np.stack(lu)), t(np.stack(swaps))


def _walkers(state):
    rows = state.s.shape[0]
    zeros = torch.zeros(rows, dtype=torch.int32)
    return tsm.WalkerState(s=t(state.s), log_psi=C(t(state.log_psi.re),
                                                   t(state.log_psi.im)),
                           n_accept=zeros, n_prop=zeros.clone())


@pytest.mark.parametrize("move", ["flip", "exchange_anti"])
def test_tempered_sweep_matches_jax(chain_pair, move):
    """Two tempered sweeps (proposals at |psi|^{2 b_r}, an exchange pass
    after each) walker for walker as the JAX sampler, from its init."""
    jm, v, tm, p = chain_pair
    m, n_sweeps = 12, 2
    bonds = jchain(N).nn_bonds if move != "flip" else None
    js = JSampler(lambda q, x: j_apply(jm, q, x), n_sites=N, move=move,
                  bonds=bonds, betas=BETAS)
    state = js.init_state(v, jax.random.key(0), m)
    key = jax.random.key(4)
    want = js.sample(v, state, key, jnp.arange(m), n_sweeps=n_sweeps)
    ts = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=N,
                               move=move, bonds=bonds, betas=BETAS)
    noise = jax_tempered_noise(key, m, len(BETAS), n_sweeps, N,
                               N if move == "flip" else None)
    got = ts.sample(p, _walkers(state), 0, torch.arange(m), n_sweeps,
                    noise=noise)
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(got.n_accept.numpy(),
                                  np.asarray(want.n_accept))
    np.testing.assert_array_equal(got.n_prop.numpy(),
                                  np.asarray(want.n_prop))
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(got.log_psi, part).numpy(),
                                   np.asarray(getattr(want.log_psi, part)),
                                   rtol=1e-4, atol=1e-4)
    # the stored log psi travels with its configuration through the swaps
    np.testing.assert_allclose(got.log_psi.re.numpy(),
                               t_apply(tm, p, got.s).re.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert 0 < int(got.n_accept.sum()) < m * len(BETAS) * n_sweeps * N


def test_swap_pass_matches_jax(chain_pair):
    """One exchange pass alone on random stored log psi: swaps where JAX
    swaps (configurations and both log psi parts), counters untouched."""
    jm, v, tm, p = chain_pair
    m, r = 40, len(BETAS)
    rng = np.random.default_rng(3)
    s = (2.0 * rng.integers(0, 2, size=(m * r, N)) - 1.0).astype(np.float32)
    lp_re = rng.normal(size=m * r).astype(np.float32)
    lp_im = rng.normal(size=m * r).astype(np.float32)
    js = JSampler(lambda q, x: j_apply(jm, q, x), n_sites=N, betas=BETAS)
    from qmcnn_tpu.ops.cplx import C as JC
    from qmcnn_tpu.sampler.metropolis import WalkerState as JW

    counters = jnp.arange(m * r, dtype=jnp.int32)
    jstate = JW(s=jnp.asarray(s), log_psi=JC(jnp.asarray(lp_re),
                                             jnp.asarray(lp_im)),
                n_accept=counters, n_prop=counters)
    key = jax.random.key(8)
    want = js._swap_step(jstate, key, jnp.arange(m))
    log_u = np.stack([np.asarray(jnp.log(jax.vmap(
        lambda w: jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, j), w)))(jnp.arange(m))))
        for j in range(r - 1)])
    ts = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=N,
                               betas=BETAS)
    tstate = tsm.WalkerState(s=t(s), log_psi=C(t(lp_re), t(lp_im)),
                             n_accept=t(counters), n_prop=t(counters))
    got = ts._swap_step(tstate, t(log_u))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(got.log_psi.re.numpy(),
                                  np.asarray(want.log_psi.re))
    np.testing.assert_array_equal(got.log_psi.im.numpy(),
                                  np.asarray(want.log_psi.im))
    assert torch.equal(got.n_accept, t(counters))
    moved = (got.s != t(s)).any(1).reshape(m, r)
    assert 0 < int(moved.sum()) < m * r


def test_physical_and_layout(chain_pair):
    """Replica-fastest rows: the state holds M * R rows, physical() the b = 1
    rows [::R] (the identity without tempering, and for the direct
    sampler); a rank's init_state keeps whole ladders."""
    _, _, tm, p = chain_pair
    ts = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=N,
                               betas=BETAS)
    assert ts.n_replicas == 3
    state = ts.init_state(p, tsm.prng_key(0), 16)
    assert state.s.shape == (48, N)
    phys = ts.physical(state)
    assert phys.s.shape == (16, N)
    assert torch.equal(phys.s, state.s[::3])
    assert torch.equal(phys.log_psi.im, state.log_psi.im[::3])
    part = ts.init_state(p, tsm.prng_key(0), 16, rows=slice(8, 16))
    assert torch.equal(part.s, state.s[24:48])
    plain = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=N)
    assert plain.n_replicas == 1 and plain.physical(state) is state
    assert torch.equal(ts._row_betas(6, "cpu"),
                       torch.tensor([1.0, 0.6, 0.3] * 2))


def test_tempered_streams_independent_of_batching(chain_pair):
    """The port's own draws depend only on the global physical ids: 8
    walkers at once or as two batches of 4 give identical rows."""
    _, _, tm, p = chain_pair
    ts = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=N,
                               betas=BETAS)
    state = ts.init_state(p, tsm.prng_key(3), 8)
    full = ts.sample(p, state, tsm.prng_key(4), torch.arange(8), 3)
    r = len(BETAS)
    for lo, hi in ((0, 4), (4, 8)):
        part = tsm.WalkerState(*(x[lo * r:hi * r] if not isinstance(x, C)
                                 else C(x.re[lo * r:hi * r],
                                        x.im[lo * r:hi * r])
                                 for x in state))
        out = ts.sample(p, part, tsm.prng_key(4), torch.arange(lo, hi), 3)
        assert torch.equal(out.s, full.s[lo * r:hi * r])
    swap = tsm.swap_noise(tsm.prng_key(5), torch.arange(6), 4, 2)
    assert swap.shape == (4, 2, 6) and bool((swap < 0).all())


def test_beta_ladder_validation(chain_pair):
    _, _, tm, _ = chain_pair
    fn = lambda q, x: t_apply(tm, q, x)  # noqa: E731
    for bad, match in [((1.0,), ">= 2"), ((0.9, 0.5), "must be 1.0"),
                       ((1.0, 1.0), "decreasing"),
                       ((1.0, 0.5, 0.7), "decreasing"),
                       ((1.0, 0.0), r"\(0, 1\]"), ((1.0, -0.5), r"\(0, 1\]")]:
        with pytest.raises(ValueError, match=match):
            tsm.MetropolisSampler(fn, n_sites=N, betas=bad)
    with pytest.raises(ValueError, match="torch backend"):
        tsm.MetropolisSampler(fn, n_sites=N, betas=(1.0, 0.5),
                              backend="cuda", lattice_shape=(N,))


def test_tempered_step_matches_jax():
    """One VMC.step of a tempered 4x4 heis config (exchange moves, pcg SR)
    from equal params and walkers, JAX's draws injected: equal walkers (all
    rows), and the estimators see the physical rows only (equal energy)."""
    jc = jcfg.load(HEIS, SMALL + ("sr.cg_tol=1.0e-6",))
    vmc_j, params_j, _ = jb.build(jc)
    state_j = vmc_j.init_state(jax.random.key(3), 16, params_j)
    key = jax.random.key(11)
    new_j, m_j = vmc_j.step(state_j, key, jnp.arange(16))
    vmc_t, _, _ = tb.build(tcfg.load(HEIS, SMALL + ("sr.cg_tol=1.0e-6",)),
                           device="cpu")
    assert vmc_t.sampler.backend == "torch" and vmc_t.sampler.betas == BETAS
    params_t = params_from_jax(
        {k: np.asarray(x) for k, x in _flatten(params_j).items()})
    from qmcnn_tpu_torch.vmc import TrainState

    state_t = TrainState(params=params_t,
                         opt_state=vmc_t.optimizer.init(params_t),
                         walkers=_walkers(state_j.walkers), step=0)
    noise = jax_tempered_noise(key, 16, 3, 1, 16, len(vmc_t.sampler.bonds))
    new_t, m_t = vmc_t.step(state_t, 0, torch.arange(16), noise=noise)
    np.testing.assert_array_equal(new_t.walkers.s.numpy(),
                                  np.asarray(new_j.walkers.s))
    assert new_t.walkers.s.shape == (48, 16)
    assert float(m_t.energy_re) == pytest.approx(float(m_j.energy_re),
                                                 rel=1e-5)
    assert float(m_t.accept_rate) == pytest.approx(float(m_j.accept_rate),
                                                   rel=1e-6)
    for k, v in _flatten(new_j.params).items():
        np.testing.assert_allclose(new_t.params[k].numpy(), np.asarray(v),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


def test_builder_wiring_and_train():
    """The builder keeps the evaluation forward and gives the torch sweep;
    train() takes a step; the direct sampler refuses tempering."""
    cfg = tcfg.load(HEIS, SMALL + ("sampler.move=flip",))
    vmc, params, _ = tb.build(cfg, device="cpu")
    assert vmc.sampler.betas == BETAS and vmc.sampler.backend == "torch"
    assert tb.resolve_sampler_backend(cfg, "cpu") == "torch"
    from qmcnn_tpu_torch.train import train

    state, logger = train(cfg, device="cpu")
    assert state.step == 1 and state.walkers.s.shape == (48, 16)
    assert np.isfinite(logger.history["energy_re"]).all()


def test_frozen_batch_under_tempering(tmp_path):
    """The frozen batch of orthogonalize_to under tempering is M physical
    rows drawn at b = 1 with the physical ids (the JAX builder passes M * R
    row ids to its tempered sampler here, which expects M, and keeps the
    hot replicas; ROADMAP.md lists it among the reference faults)."""
    cfg = tcfg.load(HEIS, SMALL)
    vmc, params, _ = tb.build(cfg, device="cpu")
    snap = str(tmp_path / "psi0.params.npz")
    np.savez(snap, **{k: v.numpy() for k, v in params.items()})
    cfg_x = tcfg.load(HEIS, SMALL + (f"optimizer.orthogonalize_to=[{snap}]",
                                     "optimizer.deflate_c=2.0"))
    vmc_x, _, _ = tb.build(cfg_x, device="cpu")
    (frozen,) = vmc_x.penalty_states
    assert frozen.s_frozen.shape == (16, 16)
    # the same draw by hand: the tempered sampler, physical ids, b = 1 rows
    key = tsm.prng_key(cfg.run.seed + 7919)
    st = vmc.sampler.init_state(params, key, 16)
    st = vmc.sampler.sample(params, st, tsm.fold_in(key, 1), torch.arange(16),
                            n_sweeps=20)
    assert torch.equal(frozen.s_frozen, st.s[::3])
    np.testing.assert_allclose(frozen.lp_frozen.re.numpy(),
                               vmc.log_psi_fn(params, st.s[::3]).re.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_sharded_tempering_matches_one_rank(tmp_path):
    """2 gloo ranks against 1 (``tests/torch_dist_ranks.py``'s excited
    legs): tempered walkers bitwise the 1-rank run's, each rank holding
    whole ladders; params, EMA and SPRING's carry bitwise replicated over
    the ranks and within rtol 1e-4 of 1 rank; the 4x4 deflation and
    penalty legs' walkers bitwise and their overlap and energies within
    rtol 1e-5 of 1 rank."""
    spec = R.excited_spec(str(tmp_path))
    torch.save(spec, tmp_path / "spec.pt")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"),
         str(r), "2", str(tmp_path), "excited"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        ref = R.run_excited(spec, None)
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
    for leg in ("tempering", "deflation", "penalty"):
        want = ref[leg]
        got = [rk[leg] for rk in ranks]
        for i, w in enumerate(want):
            assert torch.equal(torch.cat([g[i]["s"] for g in got]), w["s"]), \
                f"{leg} record {i}: walkers differ from 1 rank"
            for key in ("params", "ema"):
                if key not in w:
                    continue
                for k, v in got[0][i][key].items():
                    assert torch.equal(v, got[1][i][key][k]), (leg, key, k)
                    np.testing.assert_allclose(v.numpy(), w[key][k].numpy(),
                                               rtol=1e-4, atol=1e-6)
            if "sr_aux" in w:
                assert torch.equal(got[0][i]["sr_aux"], got[1][i]["sr_aux"])
            for name in ("energy_re", "overlap"):
                if name in w:
                    assert got[0][i][name] == got[1][i][name]
                    assert got[0][i][name] == pytest.approx(w[name],
                                                            rel=1e-5,
                                                            abs=1e-6)
    assert ranks[0]["tempering"][0]["s"].shape == (8 * 3, 16)
