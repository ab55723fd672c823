"""PyTorch port, slice 1: the fused Metropolis sweep (plain version on the
CPU, the CUDA kernel on the card) and the Metropolis sampler.

The JAX Pallas kernel runs as tests/test_pallas_sweep.py runs it
(``interpret=True``), fed with the JAX ``sweep_noise`` draws; the port gets
the same draws. Decisions (s, n_accept) must be equal and log psi within
rtol 1e-4 (test_pallas_sweep.py's tolerance: float32, different forward
summation order)."""
import dataclasses
import glob
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
from qmcnn_tpu_torch.builder import (cnn_forward_eligible,
                                    gcnn_kernel_eligible, kernel_eligible,
                                    resolve_sampler_backend,
                                    uses_fused_cnn_forward)
from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.sampler import metropolis as tsm
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

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


# -- exchange_anti: anti-aligned bond proposals with the Hastings term -------

def _jax_anti_noise(step_key, m, n_props):
    """The JAX sampler's draws for exchange_anti: per proposal t and walker
    w, key = fold_in(fold_in(step_key, t), w) split into (k_move, k_accept);
    u_move = uniform(k_move), log_u = log(uniform(k_accept))."""
    def row(t):
        k_t = jax.random.fold_in(step_key, t)
        keys = jax.vmap(lambda w: jax.random.fold_in(k_t, w))(jnp.arange(m))
        k_move, k_acc = jax.vmap(lambda k: tuple(jax.random.split(k, 2)))(
            keys)
        return (jax.vmap(jax.random.uniform)(k_move),
                jnp.log(jax.vmap(jax.random.uniform)(k_acc)))

    u, lu = zip(*(row(t) for t in range(n_props)))
    return t(np.stack(u)), t(np.stack(lu))


def test_exchange_anti_proposal_matches_jax():
    from qmcnn_tpu.sampler.metropolis import _propose_exchange_anti as j_prop

    lat = JLattice((4, 4))
    rng = np.random.default_rng(3)
    base = np.array([1.0] * 8 + [-1.0] * 8, np.float32)
    s = np.stack([rng.permutation(base) for _ in range(20)])
    s[0] = 1.0   # no anti-aligned bond: the guarded identity proposal
    keys = jax.random.split(jax.random.key(2), 20)
    u = jax.vmap(jax.random.uniform)(keys)
    s_j, corr_j = j_prop(jnp.asarray(s), keys, lat.nn_bonds)
    bonds = torch.as_tensor(np.asarray(lat.nn_bonds, np.int64))
    s_t, corr_t = tsm._propose_exchange_anti(t(s), t(u), bonds)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(corr_t.numpy(), np.asarray(corr_j))
    assert torch.equal(s_t[0], t(s[0])) and float(corr_t[0]) == 0.0
    assert torch.equal(s_t.sum(1), t(s).sum(1))
    assert bool(((s_t != t(s)).sum(1)[1:] == 2).all())  # one real swap each


def test_exchange_anti_sampler_matches_jax():
    """A complex, spin-flip projected 4x4 GCNN sampled with exchange_anti:
    the port's sampler fed the JAX draws matches JAX walker for walker."""
    from qmcnn_tpu.models.gcnn import LogPsiGCNN as JG
    from qmcnn_tpu.models.gcnn import SpinFlipSymmetrized as JSF
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN as TG
    from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized as TSF

    kw = dict(lattice_shape=(4, 4), channels=(2, 2), complex_params=True,
              param_scale=0.3)
    jm, tm = JSF(inner=JG(**kw), sector=1), TSF(TG(**kw), 1)
    v = jm.init(jax.random.key(0), jnp.ones((1, 16), jnp.float32))
    p = params_from_jax({k: np.asarray(x) for k, x in _flatten(v).items()})
    lat = JLattice((4, 4))
    m, n_props = 16, 32
    js = JSampler(lambda q, x: j_apply(jm, q, x), n_sites=16,
                  move="exchange_anti", bonds=lat.nn_bonds)
    state = js.init_state(v, jax.random.key(1), m)
    key = jax.random.key(9)
    want = js.sample(v, state, key, jnp.arange(m), n_sweeps=2)
    ts = tsm.MetropolisSampler(lambda q, x: t_apply(tm, q, x), n_sites=16,
                               move="exchange_anti", bonds=lat.nn_bonds)
    zeros = torch.zeros(m, dtype=torch.int32)
    tstate = tsm.WalkerState(
        s=t(state.s), log_psi=C(t(state.log_psi.re), t(state.log_psi.im)),
        n_accept=zeros, n_prop=zeros)
    got = ts.sample(p, tstate, 0, torch.arange(m), 2,
                    noise=_jax_anti_noise(key, m, n_props))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(got.n_accept.numpy(),
                                  np.asarray(want.n_accept))
    np.testing.assert_allclose(got.log_psi.re.numpy(),
                               np.asarray(want.log_psi.re), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(got.s.sum(1), t(state.s).sum(1))  # S^z conserved
    assert 0 < int(got.n_accept.sum()) < m * n_props
    # the generated draws run too, and start in the S^z = 0 sector
    fresh = ts.init_state(p, tsm.prng_key(4), m)
    assert bool((fresh.s.sum(1) == 0).all())
    out = ts.sample(p, fresh, tsm.prng_key(5), torch.arange(m), 1)
    assert bool((out.s.sum(1) == 0).all())


def test_exchange_anti_noise_shares_the_hash():
    ids = torch.arange(48)
    u, lu = tsm.sweep_noise(tsm.prng_key(6), ids, 30, None)
    _, lu_int = tsm.sweep_noise(tsm.prng_key(6), ids, 30, 7)
    assert u.dtype == torch.float32 and tuple(u.shape) == (30, 48)
    assert torch.equal(lu, lu_int)
    assert bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.double().mean()) - 0.5) < 0.02
    u2, _ = tsm.sweep_noise(tsm.prng_key(6), ids[5:20], 30, None)
    assert torch.equal(u[:, 5:20], u2)


def test_sweep_kernel_rejects_exchange_anti():
    """The CUDA sweep serves flip and exchange only: with exchange_anti
    'auto' takes the plain torch sweep and 'pallas' raises, as in JAX."""
    anti = configs.apply_overrides(_cfg(), ("sampler.move=exchange_anti",))
    assert kernel_eligible(_cfg()) and not kernel_eligible(anti)
    assert resolve_sampler_backend(anti, "cuda") == "torch"
    with pytest.raises(ValueError):
        resolve_sampler_backend(
            configs.apply_overrides(anti, ("sampler.backend=pallas",)),
            "cuda")
    with pytest.raises(ValueError):
        tsm.MetropolisSampler(lambda q, x: x, n_sites=16,
                              move="exchange_anti", bonds=np.zeros((1, 2)),
                              backend="cuda", lattice_shape=(4, 4))


# -- the kernel's weight blob, its blocks and its eligibility -----------------

def _pad8(x):
    return (x + 7) // 8 * 8


def _r4(x):
    return (x + 3) // 4 * 4


def _unpack_blob(blob, taps, channels):
    """numpy inverse of ``pack_sweep_weights``: ([taps, Cin_p, Cout_p] kernel
    per layer, hi and lo parts summed for the tensor-core layers, and the
    hi parts alone), the padded biases per layer, and the words used."""
    cp = [_pad8(c) for c in channels]
    kernels, his = [blob[:taps * cp[1]].reshape(taps, 1, cp[1])], [None]
    off = _r4(taps * cp[1])
    biases = []
    for c in cp[1:]:
        biases.append(blob[off:off + c])
        off += c
    off = _r4(taps * cp[1]) + _r4(sum(cp[1:]))
    for cin, cout in zip(cp[1:-1], cp[2:]):
        size = 2 * taps * cin * cout
        f = blob[off:off + size].reshape(taps, cin // 8, cout // 8, 8, 4, 4)
        off += size
        # (t, ks, nt, g, tig, kh) -> w[t, 8 ks + 4 kh + tig, 8 nt + g]
        parts = [f[..., i:i + 2].transpose(0, 1, 5, 4, 2, 3).reshape(
            taps, cin, cout) for i in (0, 2)]
        kernels.append(parts[0].astype(np.float64) + parts[1])
        his.append(parts[0])
    return kernels, his, biases, off


@pytest.mark.parametrize("shape,channels,k", [
    ((10, 10), (16, 16, 16), 3),     # the flagship
    ((16,), (12, 12), 5),            # 1D, k = 5, Cout padded 12 -> 16
    ((4, 6), (5, 20, 3), 2),         # even k; Cin and Cout off the 8 tiles
    ((10, 10), (24, 24, 24), 3),     # the hero width
])
def test_packed_weights_rebuild_flax_kernels(shape, channels, k):
    """The packed blob, unpacked in numpy, gives back the Flax
    [taps, Cin, Cout] kernels and biases: the first layer and the biases
    exactly, the tensor-core layers as TF32 hi + lo within 2^-21 of each
    weight (hi with its low 13 mantissa bits zero), padding zero."""
    model = TCNN(shape, channels=channels, kernel_size=k, param_scale=0.3)
    params = model.init(3, device="cpu")
    layers = k1.conv_layers(params, shape)
    taps = int(np.prod(layers[0][0].shape[:-2]))
    chans = [1] + list(channels)
    blob = k1.pack_sweep_weights(layers, taps)
    assert blob.dtype == torch.float32 and blob.numel() % 4 == 0
    assert blob.numel() == k1.blob_words(taps, chans)
    assert k1.packed_weights(layers, taps) is k1.packed_weights(layers, taps)
    kernels, his, biases, used = _unpack_blob(blob.numpy(), taps, chans)
    assert used == blob.numel()
    for i, (kern, bias) in enumerate(layers):
        w = kern.reshape(taps, chans[i], chans[i + 1]).numpy()
        got = kernels[i]
        cin, cout = w.shape[1:]
        if i == 0:
            np.testing.assert_array_equal(got[:, :, :cout], w)
        else:
            np.testing.assert_allclose(got[:, :cin, :cout], w, rtol=2.0 ** -21,
                                       atol=0)
            bits = his[i].view(np.int32)
            assert not (bits & 0x1FFF).any()
            assert not got[:, cin:, :].any()
        assert not got[:, :, cout:].any()
        np.testing.assert_array_equal(biases[i][:cout], bias.numpy())
        assert not biases[i][cout:].any()


def _smem_formula(n, taps, channels, walkers):
    """Bytes of one block, written out from the layout the kernel source
    describes: the weight blob, two [rows, pad8(max hidden C) + 4] buffers
    (one for 2 layers, none for 1), the spins, one partial sum per row and
    column group (at most 3 column tiles per task), 7 words per slot and
    the [taps, N] table."""
    n_layers = len(channels) - 1
    rows = walkers * n
    blob = (_r4(taps * _pad8(channels[1])) + _r4(sum(map(_pad8, channels[1:])))
            + sum(2 * taps * _pad8(a) * _pad8(b)
                  for a, b in zip(channels[1:-1], channels[2:])))
    stride = max([8] + [_pad8(c) for c in channels[1:-1]]) + 4
    parts = 1 if n_layers == 1 else -(-(_pad8(channels[-1]) // 8) // 3)
    return 4 * (blob + min(n_layers - 1, 2) * rows * stride + _r4(rows)
                + _r4(rows * parts) + 7 * _r4(walkers) + taps * n)


def _config_paths():
    return sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def test_walkers_per_block_follows_shared_memory():
    """walkers_per_block takes as many slots as fit (up to MAX_WALKERS), by
    the byte formula; every CNN config that the kernel serves fits at
    least one walker."""
    from qmcnn_tpu_torch.kernels.nvcc import MAX_SMEM_BYTES

    shapes = [(100, 9, [1, 16, 16, 16]), (16, 5, [1, 12, 12]),
              (24, 4, [1, 5, 20]), (1600, 9, [1, 3]), (100, 9, [1, 24] * 2),
              (40, 7, [1] + [12] * 6), (4096, 9, [1, 16, 16]),
              (64, 9, [1, 40, 40])]
    for n, taps, ch in shapes:
        for w in range(1, k1.MAX_WALKERS + 1):
            assert k1.smem_bytes(n, taps, ch, w) == _smem_formula(n, taps, ch,
                                                                  w)
        fits = [w for w in range(1, k1.MAX_WALKERS + 1)
                if _smem_formula(n, taps, ch, w) <= MAX_SMEM_BYTES]
        assert k1.walkers_per_block(n, taps, ch) == max(fits, default=1)
    assert k1.walkers_per_block(100, 9, [1, 16, 16, 16]) == 8
    assert k1.walkers_per_block(100, 9, [1, 24, 24, 24]) == 6
    served = 0
    for path in _config_paths():
        cfg = configs.load(path)
        if not cnn_forward_eligible(cfg):
            continue
        served += 1
        shape = tuple(cfg.lattice.shape)
        k = cfg.model.kernel_size
        taps = int(np.prod([min(k, s) for s in shape]))
        ch = [1] + list(cfg.model.channels)
        n = int(np.prod(shape))
        w = k1.walkers_per_block(n, taps, ch)
        assert w >= 1 and k1.smem_bytes(n, taps, ch, w) <= MAX_SMEM_BYTES
        assert k1.launch_threads(n, ch, w) <= k1.MAX_THREADS
    assert served == 5


#: the configs whose sweep the kernel ran before the redesign (flip or
#: exchange moves), and those whose evaluation forward it now also serves
#: (exchange_anti, through the torch proposal loop)
SWEEP_CONFIGS = {"heis10x10_sr", "heis8x8_cnn", "tfim16_sgd"}
FORWARD_CONFIGS = SWEEP_CONFIGS | {"heis10x10_hero", "heis8x8_hero"}


#: the configs whose evaluation forward K2 serves (f32 and bf16 routes):
#: no ViT, ARNN or RBM among them, and not the 16x16 GCNN, whose
#: activations exceed a block's shared memory
GCNN_CONFIGS = {"j1j2_10x10_gcnn", "j1j2_10x10_gcnn_deep",
                "j1j2_12x12_gcnn_deep", "j1j2_8x8_gcnn",
                "j1j2_8x8_gcnn_deep", "j1j2_8x8_gcnn_r2",
                "j1j2_8x8_gcnn_res8"}


def test_every_config_keeps_its_eligibility():
    for path in _config_paths():
        cfg = configs.load(path)
        name = os.path.basename(path)[:-len(".yaml")]
        assert kernel_eligible(cfg) == (name in SWEEP_CONFIGS), name
        assert cnn_forward_eligible(cfg) == (name in FORWARD_CONFIGS), name
        assert gcnn_kernel_eligible(cfg) == (name in GCNN_CONFIGS), name
    for kind in ("vit", "arnn", "rbm"):
        other = configs.apply_overrides(_cfg(), (f"model.kind={kind}",))
        assert not (kernel_eligible(other) or cnn_forward_eligible(other)
                    or gcnn_kernel_eligible(other)), kind
    # a lattice whose one walker exceeds a block's shared memory keeps the
    # plain model instead of a kernel that would raise
    big = configs.apply_overrides(_cfg(), ("lattice.shape=[64,64]",))
    assert not cnn_forward_eligible(big) and not kernel_eligible(big)
    assert resolve_sampler_backend(big, "cuda") == "torch"


def test_uses_fused_cnn_forward():
    hero = configs.load(os.path.join(ROOT, "configs", "heis10x10_hero.yaml"))
    for cfg in (_cfg(), hero):
        assert uses_fused_cnn_forward(cfg, "cuda")
        assert not uses_fused_cnn_forward(cfg, "cpu")
        xla = configs.apply_overrides(cfg, ("sampler.backend=xla",))
        assert not uses_fused_cnn_forward(xla, "cuda")
    assert resolve_sampler_backend(hero, "cuda") == "torch"  # exchange_anti
    for cfg in (_cfg(complex_params=True), _cfg(activation="selu"),
                _cfg(residual=True),
                configs.apply_overrides(_cfg(), ("lattice.pbc=false",))):
        assert not uses_fused_cnn_forward(cfg, "cuda")
