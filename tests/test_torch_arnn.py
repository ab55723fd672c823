"""PyTorch port, slice 9: the autoregressive ARNN (models/arnn.py) and its
direct sampler (sampler/direct.py), each against the JAX package on equal
numpy-seeded inputs.

Tolerances: conditionals and log psi rtol/atol 1e-5; masks exactly equal;
Sum |psi|^2 = 1 within 1e-5 by enumeration; the direct sampler fed the JAX
sampler's own uniforms draws bitwise the same walkers (a draw within 1e-6
of its p_up could round either way: such draws are counted and there are
none at these seeds)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.models import arnn as ja
from qmcnn_tpu.sampler.direct import DirectSampler as JDirect
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch.models import arnn as ta
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.sampler.direct import DirectSampler, site_uniforms
from qmcnn_tpu_torch.sampler.metropolis import WalkerState
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.test_torch_priors import _spins, _unflatten

TOL = 1e-5


def _all_configs(n):
    return np.array(list(itertools.product([-1.0, 1.0], repeat=n)),
                    np.float32)


def _pair(seed=0, **kw):
    """JAX and port ARNNs with equal parameters: the JAX init plus
    numpy-seeded noise (the biases start at zero)."""
    jm, tm = ja.LogPsiARNN(**kw), ta.LogPsiARNN(**kw)
    v = jm.init(jax.random.key(seed), jnp.ones((1, kw["n_sites"])))
    rng = np.random.default_rng(seed + 1)
    flat = {k: (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(
        np.float32) for k, x in _flatten(v).items()}
    return jm, _unflatten(flat), tm, params_from_jax(flat)


CASES = {
    "made_real": dict(n_sites=12, hidden=(16, 16)),
    "made_complex_sz0": dict(n_sites=12, hidden=(16, 8), complex_params=True,
                             sz_zero=True),
    "made_lncosh_prior": dict(n_sites=10, hidden=(8,), activation="lncosh",
                              complex_params=True,
                              phase_half_angles=tuple(
                                  np.linspace(0, 2, 10).tolist())),
    "conv_real_sz0": dict(n_sites=16, hidden=(8, 8), conv_kernel=3,
                          lattice_shape=(4, 4), sz_zero=True),
    "conv_complex_prior": dict(n_sites=12, hidden=(6, 6), conv_kernel=3,
                               lattice_shape=(3, 4), complex_params=True,
                               phase_half_angles=tuple(
                                   np.linspace(-1, 1, 12).tolist())),
}


@pytest.mark.parametrize("n,widths", [(5, (7, 3)), (16, (16, 16, 8)),
                                      (2, (4,))])
def test_masks_equal_jax(n, widths):
    for a, b in zip(ta.made_masks(n, widths), ja.made_masks(n, widths)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ta.made_degrees(n, widths), ja.made_degrees(n, widths)):
        np.testing.assert_array_equal(a, b)
    for k in (3, 5):
        for center in (False, True):
            np.testing.assert_array_equal(ta.causal_conv_mask(k, center),
                                          ja.causal_conv_mask(k, center))


@pytest.mark.parametrize("name", sorted(CASES))
def test_conditionals_and_log_psi_match_jax(name):
    kw = CASES[name]
    jm, v, tm, p = _pair(**kw)
    s = _spins(3, 40, kw["n_sites"])
    want_up, want_dn = jm.apply(v, s, method="conditional_log_probs")
    got_up, got_dn = ta.conditional_fn(tm)(p, torch.from_numpy(s))
    for g, w in ((got_up, want_up), (got_dn, want_dn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    want = jm.apply(v, s)
    got = t_apply(tm, p, torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               rtol=TOL, atol=TOL)
    assert sorted(p) == sorted(tm.init(0))
    for k, x in tm.init(0).items():
        assert tuple(x.shape) == tuple(p[k].shape), k


@pytest.mark.parametrize("name", ["made_complex_sz0", "conv_complex_prior"])
def test_autoregressive_property(name):
    """Perturbing s_j for any j >= i leaves conditional i as it was."""
    kw = CASES[name]
    _, _, tm, p = _pair(**kw)
    n = kw["n_sites"]
    s = torch.from_numpy(_spins(4, 8, n))
    base_up, base_dn = ta.conditional_fn(tm)(p, s)
    for j in range(n):
        flipped = s.clone()
        flipped[:, j:] = torch.from_numpy(_spins(5 + j, 8, n - j))
        up, dn = ta.conditional_fn(tm)(p, flipped)
        torch.testing.assert_close(up[:, :j + 1], base_up[:, :j + 1],
                                   rtol=0, atol=0)
        torch.testing.assert_close(dn[:, :j + 1], base_dn[:, :j + 1],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    dict(n_sites=10, hidden=(16, 16), complex_params=True),
    dict(n_sites=10, hidden=(16, 16), sz_zero=True),
    dict(n_sites=10, hidden=(8, 8), conv_kernel=3, lattice_shape=(2, 5),
         sz_zero=True, complex_params=True),
], ids=["made_free", "made_sz0", "conv_sz0"])
def test_exact_normalization(kw):
    _, _, tm, p = _pair(**kw)
    s = _all_configs(10)
    if kw.get("sz_zero"):
        s = s[s.sum(-1) == 0]
    lp = t_apply(tm, p, torch.from_numpy(s))
    total = float(torch.exp(2.0 * lp.re.double()).sum())
    assert abs(total - 1.0) < TOL, total


def _jax_uniforms(step_key, walker_ids, n):
    """The JAX direct sampler's draws (sampler/direct.py), [N, M]."""
    out = []
    for i in range(n):
        k_i = jax.random.fold_in(step_key, i)
        out.append(jax.vmap(lambda w, k=k_i: jax.random.uniform(
            jax.random.fold_in(k, w)))(walker_ids))
    return np.array(jnp.stack(out))


@pytest.mark.parametrize("name", ["made_complex_sz0", "conv_real_sz0",
                                  "made_real"])
def test_direct_sampler_matches_jax_given_its_uniforms(name):
    kw = CASES[name]
    jm, v, tm, p = _pair(**kw)
    n, m = kw["n_sites"], 256
    jsamp = JDirect(lambda vv, s: jm.apply(vv, s), ja.conditional_fn(jm),
                    n_sites=n, sz_zero=kw.get("sz_zero", False))
    key, ids = jax.random.key(7), jnp.arange(m)
    jstate = jsamp.init_state(v, jax.random.key(3), m)
    want = np.asarray(jsamp.sample(v, jstate, key, ids).s)
    u = _jax_uniforms(key, ids, n)
    log_up, _ = jm.apply(v, want, method="conditional_log_probs")
    near = np.abs(u - np.exp(np.asarray(log_up)).T) < 1e-6
    assert near.sum() == 0
    tsamp = DirectSampler(lambda pp, s: t_apply(tm, pp, s),
                          ta.conditional_fn(tm), n_sites=n,
                          sz_zero=kw.get("sz_zero", False))
    state = tsamp.init_state(p, 3, m)
    out = tsamp.sample(p, state, 0, torch.arange(m),
                       noise=torch.from_numpy(u))
    np.testing.assert_array_equal(out.s.numpy(), want)
    if kw.get("sz_zero"):
        assert (out.s.sum(-1) == 0).all()
    lp = t_apply(tm, p, out.s)
    assert torch.equal(out.log_psi.re, lp.re)
    assert float(DirectSampler.acceptance_rate(out)) == 1.0
    assert out.n_prop.tolist() == [1] * m


@pytest.mark.parametrize("sz_zero", [False, True])
def test_direct_sampler_matches_exact_distribution(sz_zero):
    """The hashed draws sample |psi|^2: a chi-square over the states of
    non-negligible probability, as the JAX test does."""
    n, m = 8, 8192
    _, _, tm, p = _pair(n_sites=n, hidden=(16, 16), sz_zero=sz_zero)
    s_all = torch.from_numpy(_all_configs(n))
    prob = torch.exp(2.0 * t_apply(tm, p, s_all).re.double()).numpy()
    prob = prob / prob.sum()
    samp = DirectSampler(lambda pp, s: t_apply(tm, pp, s),
                         ta.conditional_fn(tm), n_sites=n, sz_zero=sz_zero)
    state = samp.sample(p, samp.init_state(p, 3, m), 11, torch.arange(m))
    s = state.s.numpy()
    if sz_zero:
        assert np.all(s.sum(-1) == 0)
    idx = ((s > 0).astype(np.int64) * (2 ** np.arange(n)[::-1])).sum(-1)
    counts = np.bincount(idx, minlength=2 ** n)
    keep = prob > 5.0 / m
    chi2 = float((((counts - m * prob) ** 2 / np.maximum(m * prob, 1e-12))
                  [keep]).sum())
    dof = int(keep.sum()) - 1
    assert chi2 < dof + 5.0 * np.sqrt(2.0 * dof), (chi2, dof)


def test_site_uniforms_follow_the_global_walker_id():
    """A walker's draws depend on its global id only, not on the batch it
    is drawn in (n ranks draw what 1 rank draws)."""
    full = site_uniforms(5, torch.arange(64), 12)
    part = site_uniforms(5, torch.arange(32, 64), 12)
    assert torch.equal(full[:, 32:], part)
    assert full.shape == (12, 64) and bool(((full > 0) & (full < 1)).all())
    state = WalkerState(s=torch.ones(4, 12), log_psi=None,
                        n_accept=torch.zeros(4, dtype=torch.int32),
                        n_prop=torch.zeros(4, dtype=torch.int32))
    samp = DirectSampler(None, None, n_sites=12)
    assert samp.refresh(None, state) is state
    assert samp.physical(state) is state
