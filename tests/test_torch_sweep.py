"""PyTorch port, slice 1: the fused Metropolis sweep (plain version on the
CPU, the CUDA kernel on the card) and the Metropolis sampler.

The JAX Pallas kernel runs as tests/test_pallas_sweep.py runs it
(``interpret=True``), fed with the JAX ``sweep_noise`` draws; the port gets
the same draws. Decisions (s, n_accept) must be equal and log psi within
rtol 1e-4 (test_pallas_sweep.py's tolerance: float32, different forward
summation order)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.kernels.metropolis_pallas import pallas_sweep, sweep_noise
from qmcnn_tpu.lattice import Lattice as JLattice
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.sampler.metropolis import MetropolisSampler as JSampler
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import configs
from qmcnn_tpu_torch.builder import kernel_eligible, resolve_sampler_backend
from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler import metropolis as tsm
from qmcnn_tpu_torch.utils.transfer import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup(shape, move, m=32, seed=7):
    kw = dict(lattice_shape=shape, channels=(4,), param_scale=0.3)
    jm = JCNN(**kw)
    lat = JLattice(shape)
    n = lat.n_sites
    v = jm.init(jax.random.key(seed), jnp.ones((1, n), jnp.float32))
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    rng = np.random.default_rng(seed)
    if move == "exchange":
        base = np.array([1.0] * (n // 2) + [-1.0] * (n - n // 2), np.float32)
        s = np.stack([rng.permutation(base) for _ in range(m)])
    else:
        s = (2.0 * rng.integers(0, 2, size=(m, n)) - 1.0).astype(np.float32)
    bonds = lat.nn_bonds if move == "exchange" else None
    n_choices = n if move == "flip" else len(bonds)
    return dict(jm=jm, v=v, tm=TCNN(**kw), p=params_from_jax(flat), s=s,
                lp=np.asarray(j_apply(jm, v, s).re), bonds=bonds, n=n, m=m,
                n_choices=n_choices)


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


CASES = [("flip", (8,)), ("exchange", (8,)), ("flip", (4, 4)),
         ("exchange", (4, 4))]


@pytest.mark.parametrize("move,shape", CASES)
def test_reference_matches_jax_pallas(move, shape):
    c = setup(shape, move)
    n_props = 2 * c["n"]
    key = jax.random.key(4)
    choices, log_u = sweep_noise(key, jnp.arange(c["m"]), n_props,
                                 c["n_choices"])
    s_w, lp_w, acc_w = pallas_sweep(
        c["v"], c["s"], c["lp"], noise=(choices, log_u), lattice_shape=shape,
        n_props=n_props, move=move, bonds=c["bonds"], block=16,
        interpret=True)
    s_g, lp_g, acc_g = k1.sweep_reference(
        c["p"], t(c["s"]), t(c["lp"]), lattice_shape=shape, n_props=n_props,
        move=move, bonds=c["bonds"], noise=(t(choices), t(log_u)))
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(acc_g.numpy(),
                                  np.asarray(acc_w).astype(np.int32))
    np.testing.assert_allclose(lp_g.numpy(), np.asarray(lp_w), rtol=1e-4,
                               atol=1e-4)
    assert acc_g.sum() > 0
    # the wrapper on CPU tensors is the plain version, and is not counted
    before = k1.metropolis_sweep.launches
    s_k, _, acc_k = k1.metropolis_sweep(
        c["p"], t(c["s"]), t(c["lp"]), lattice_shape=shape, n_props=n_props,
        move=move, bonds=c["bonds"], noise=(t(choices), t(log_u)))
    assert torch.equal(s_k, s_g) and torch.equal(acc_k, acc_g)
    assert k1.metropolis_sweep.launches == before


@pytest.mark.parametrize("shape", [(8,), (4, 4)])
def test_recompute_mode_matches_jax(shape):
    c = setup(shape, "flip", m=16)
    _, lp_w, _ = pallas_sweep(c["v"], c["s"], jnp.zeros(16),
                              lattice_shape=shape, n_props=0, block=8,
                              interpret=True)
    s_g, lp_g, acc_g = k1.sweep_reference(c["p"], t(c["s"]), torch.zeros(16),
                                          lattice_shape=shape, n_props=0)
    np.testing.assert_allclose(lp_g.numpy(), np.asarray(lp_w), rtol=2e-4,
                               atol=1e-5)
    assert torch.equal(s_g, t(c["s"])) and int(acc_g.sum()) == 0


def test_exchange_conserves_sz_and_tracks_log_psi():
    c = setup((2, 4), "exchange")
    ch, lu = tsm.sweep_noise(tsm.prng_key(5), torch.arange(c["m"]), 20,
                             c["n_choices"])
    s_o, lp_o, acc = k1.sweep_reference(
        c["p"], t(c["s"]), t(c["lp"]), lattice_shape=(2, 4), n_props=20,
        move="exchange", bonds=c["bonds"], noise=(ch, lu))
    assert torch.all(s_o.sum(-1) == 0)
    np.testing.assert_allclose(lp_o.numpy(),
                               t_apply(c["tm"], c["p"], s_o).re.numpy(),
                               rtol=2e-4, atol=1e-4)
    assert acc.sum() > 0 and torch.all(acc <= 20)


def test_argument_errors():
    c = setup((8,), "flip", m=16)
    s, lp = t(c["s"]), t(c["lp"])
    ch, lu = tsm.sweep_noise(tsm.prng_key(0), torch.arange(16), 2, 8)
    kw = dict(lattice_shape=(8,), n_props=2)
    for bad in (dict(move="exchange", noise=(ch, lu)),        # no bonds
                dict(noise=None),                             # no noise
                dict(noise=(ch[:1], lu[:1])),                 # wrong shape
                dict(noise=(ch + 8, lu)),                     # out of range
                dict(noise=(ch, lu.double())),                # wrong dtype
                dict(move="exchange_anti", noise=(ch, lu))):
        with pytest.raises(ValueError):
            k1.metropolis_sweep(c["p"], s, lp, **{**kw, **bad})
    with pytest.raises(ValueError):  # not a plain real CNN
        k1.metropolis_sweep({**c["p"], "params/Jastrow_0/w": lp}, s, lp,
                            noise=(ch, lu), **kw)
    with pytest.raises(ValueError):  # wrong log psi shape
        k1.metropolis_sweep(c["p"], s, lp[:3], noise=(ch, lu), **kw)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        k1.metropolis_sweep(c["p"], s.to("meta"), lp.to("meta"),
                            noise=(ch, lu), **kw)


@pytest.mark.parametrize("move", ["flip", "exchange"])
def test_sampler_matches_jax_sampler(move):
    c = setup((4, 4), move)
    jf = lambda p, x: j_apply(c["jm"], p, x)  # noqa: E731
    js = JSampler(jf, n_sites=c["n"], move=move, bonds=c["bonds"])
    state = js.init_state(c["v"], jax.random.key(1), c["m"])
    key = jax.random.key(9)
    want = js.sample(c["v"], state, key, jnp.arange(c["m"]), n_sweeps=2)
    noise = sweep_noise(key, jnp.arange(c["m"]), 2 * c["n"], c["n_choices"])
    noise = (t(noise[0]), t(noise[1]))
    tf = lambda p, x: t_apply(c["tm"], p, x)  # noqa: E731
    zeros = torch.zeros(c["m"], dtype=torch.int32)
    tstate = tsm.WalkerState(
        s=t(state.s), log_psi=C(t(state.log_psi.re), t(state.log_psi.im)),
        n_accept=zeros, n_prop=zeros)
    ids = torch.arange(c["m"])
    for backend in ("torch", "cuda"):  # 'cuda' on CPU tensors: plain sweep
        ts = tsm.MetropolisSampler(tf, n_sites=c["n"], move=move,
                                   bonds=c["bonds"], backend=backend,
                                   lattice_shape=(4, 4))
        got = ts.sample(c["p"], tstate, 0, ids, 2, noise=noise)
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
        np.testing.assert_array_equal(got.n_accept.numpy(),
                                      np.asarray(want.n_accept))
        assert int(got.n_prop[0]) == 2 * c["n"]
        np.testing.assert_allclose(got.log_psi.re.numpy(),
                                   np.asarray(want.log_psi.re), rtol=1e-4,
                                   atol=1e-4)
        assert float(tsm.MetropolisSampler.acceptance_rate(got)) == \
            pytest.approx(float(JSampler.acceptance_rate(want)))


def test_noise_is_counter_based():
    ids = torch.arange(64)
    ch, lu = tsm.sweep_noise(tsm.prng_key(3), ids, 40, 10)
    ch2, lu2 = tsm.sweep_noise(tsm.prng_key(3), ids[17:40], 40, 10)
    assert torch.equal(ch[:, 17:40], ch2) and torch.equal(lu[:, 17:40], lu2)
    assert ch.dtype == torch.int32 and lu.dtype == torch.float32
    assert int(ch.min()) == 0 and int(ch.max()) == 9
    assert bool((lu < 0).all())
    u = torch.exp(lu.double())
    assert abs(float(u.mean()) - 0.5) < 0.02
    counts = torch.bincount(ch.reshape(-1).long(), minlength=10).double()
    assert float(counts.min() / counts.max()) > 0.85
    other = tsm.sweep_noise(tsm.fold_in(tsm.prng_key(3), 1), ids, 40, 10)
    assert not torch.equal(other[0], ch)


def test_init_walkers_sectors():
    s = tsm.init_walkers(tsm.prng_key(0), 16, 9, sector="sz0")
    assert torch.all(s.sum(-1) == 1.0)
    s = tsm.init_walkers(tsm.prng_key(0), 16, 10, sector="sz0")
    assert torch.all(s.sum(-1) == 0.0)
    free = tsm.init_walkers(tsm.prng_key(0), 16, 10)
    assert set(free.unique().tolist()) <= {-1.0, 1.0}
    with pytest.raises(ValueError):
        tsm.init_walkers(0, 4, 4, sector="sz1")


def _cfg(**model):
    cfg = configs.load(os.path.join(ROOT, "configs", "heis10x10_sr.yaml"))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


def test_eligibility():
    assert kernel_eligible(_cfg())
    assert resolve_sampler_backend(_cfg(), "cuda") == "cuda"
    assert resolve_sampler_backend(_cfg(), "cpu") == "torch"
    xla = configs.apply_overrides(_cfg(), ("sampler.backend=xla",))
    assert resolve_sampler_backend(xla, "cuda") == "torch"
    tfim = configs.load(os.path.join(ROOT, "configs", "tfim16_sgd.yaml"))
    assert resolve_sampler_backend(tfim, "cuda") == "cuda"  # flip moves too
    bad = [_cfg(complex_params=True), _cfg(activation="selu"),
           _cfg(residual=True), _cfg(compute_dtype="bfloat16"),
           _cfg(jastrow=True),
           configs.apply_overrides(_cfg(), ("lattice.pbc=false",))]
    for cfg in bad:
        assert not kernel_eligible(cfg)
        assert resolve_sampler_backend(cfg, "cuda") == "torch"
        forced = configs.apply_overrides(cfg, ("sampler.backend=pallas",))
        with pytest.raises(ValueError):
            resolve_sampler_backend(forced, "cuda")
    with pytest.raises(ValueError):  # the kernel needs a CUDA device
        resolve_sampler_backend(
            configs.apply_overrides(_cfg(), ("sampler.backend=pallas",)),
            "cpu")
