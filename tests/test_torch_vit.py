"""PyTorch port, slice 9: the ViT ansatz (models/vit.py) against the JAX
package on equal numpy-seeded inputs, at a 4x4 lattice with 2 blocks of
width 8: factored and dot-product attention, real and complex heads,
spin-flip sectors +1 and -1, and the point-group average.

Tolerances: log psi rtol/atol 1e-4, the phase compared modulo 2 pi; the
geometry tables exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.models import gcnn as jg
from qmcnn_tpu.models import vit as jv
from qmcnn_tpu.models.cnn import PointGroupAveraged as JPointGroup
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch.models import vit as tv
from qmcnn_tpu_torch.models.cnn import PointGroupAveraged
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.test_torch_priors import _spins, _unflatten
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def assert_log_psi_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.re.detach().numpy(), np.asarray(want.re),
                               rtol=tol, atol=tol)
    dphi = got.im.detach().numpy() - np.asarray(want.im)
    dphi = (dphi + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dphi, 0.0, atol=tol)


@pytest.mark.parametrize("grid", [(2, 2), (4, 4), (2, 3), (4,), (2, 2, 2)])
def test_geometry_tables_equal_jax(grid):
    np.testing.assert_array_equal(tv._relpos_index(grid),
                                  jv._relpos_index(grid))
    shape = tuple(2 * g for g in grid)
    x = np.arange(3 * int(np.prod(shape)), dtype=np.float32).reshape(
        3, *shape)
    np.testing.assert_array_equal(
        tv._patchify(torch.from_numpy(x), shape, 2).numpy(),
        np.asarray(jv._patchify(jnp.asarray(x), shape, 2)))


CASES = {
    "factored_complex": dict(),
    "dot_complex": dict(factored=False),
    "factored_real": dict(complex_params=False),
    "dot_real_flip_minus": dict(factored=False, complex_params=False,
                                spin_flip=-1),
    "factored_complex_flip_plus": dict(spin_flip=1),
    "dot_complex_point_group": dict(factored=False, point_group=True,
                                    spin_flip=1),
}


def _pair(spin_flip=0, point_group=False, seed=0, **kw):
    """JAX and port ViTs (2 blocks of width 8, 2 heads, patch 2 on 4x4)
    with equal parameters: the JAX init plus numpy-seeded noise on every
    leaf (biases and layer-norm offsets start at zero)."""
    kw = dict(dict(lattice_shape=(4, 4), channels=(8, 8), patch=2,
                   n_heads=2, mlp_ratio=2, factored=True,
                   complex_params=True, param_scale=0.5), **kw)
    jm, tm = jv.LogPsiViT(**kw), tv.LogPsiViT(**kw)
    if point_group:
        jm = JPointGroup(inner=jm, lattice_shape=(4, 4))
        tm = PointGroupAveraged(tm, (4, 4))
    if spin_flip:
        jm = jg.SpinFlipSymmetrized(inner=jm, sector=spin_flip)
        tm = SpinFlipSymmetrized(tm, spin_flip)
    v = jm.init(jax.random.key(seed), jnp.ones((1, 16), jnp.float32))
    rng = np.random.default_rng(seed + 1)
    flat = {k: (np.asarray(x) + 0.2 * rng.normal(size=np.shape(x))).astype(
        np.float32) for k, x in _flatten(v).items()}
    return jm, _unflatten(flat), tm, params_from_jax(flat)


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_psi_matches_jax(name):
    jm, v, tm, p = _pair(**CASES[name])
    s = _spins(2, 48, 16)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)), jm.apply(v, s))
    init = tm.init(0)
    assert sorted(init) == sorted(p)
    for k, x in init.items():
        assert tuple(x.shape) == tuple(p[k].shape), k


def test_translation_invariance_and_gradient():
    """log psi is invariant under every lattice translation (relpos
    attention and the sub-patch projection), and its gradient matches
    JAX's."""
    jm, v, tm, p = _pair(factored=False)
    s = torch.from_numpy(_spins(3, 8, 16))
    base = t_apply(tm, p, s)
    for shift in ((1, 0), (0, 3), (3, 1)):
        rolled = torch.roll(s.reshape(8, 4, 4), shift, dims=(1, 2))
        out = t_apply(tm, p, rolled.reshape(8, 16))
        torch.testing.assert_close(out.re, base.re, rtol=1e-5, atol=1e-5)

    def t_loss(pp):
        lp = t_apply(tm, pp, s)
        return (lp.re * torch.linspace(-1, 1, 8)).sum() + lp.im.sum()

    def j_loss(vv):
        lp = jm.apply(vv, jnp.asarray(s.numpy()))
        return (lp.re * jnp.linspace(-1, 1, 8)).sum() + lp.im.sum()

    got = torch.func.grad(t_loss)(p)
    want = _flatten(jax.grad(j_loss)(v))
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_bf16_trunk_and_bad_shapes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tv.LogPsiViT((4, 4), channels=(8, 8), compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="does not divide"):
        tv.LogPsiViT((5, 4), channels=(8, 8))
    with pytest.raises(ValueError, match="constant-width"):
        tv.LogPsiViT((4, 4), channels=(8, 16))
    with pytest.raises(ValueError, match="not divisible by n_heads"):
        tv.LogPsiViT((4, 4), channels=(6, 6), n_heads=4)
