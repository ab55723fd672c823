"""PyTorch port, slice 1: the real LogPsiCNN and the parameter transfer.

The same parameters (a JAX init, or the committed flagship snapshot) and
the same spin configurations (numpy, seeded) go through
``qmcnn_tpu.models.cnn.log_psi_apply`` and its port. Tolerance rtol 2e-5,
atol 1e-4: both sides are float32 with a different summation order."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import kernel_std as j_kernel_std
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import kernel_std as t_kernel_std
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                            params_from_jax, params_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "runs", "ab_cnn_float32.csv.params.npz")
RTOL, ATOL = 2e-5, 1e-4


def spins(rng, b, n):
    return (2.0 * rng.integers(0, 2, size=(b, n)) - 1.0).astype(np.float32)


def both(kw, seed=0):
    """(JAX model, port model, flat params as numpy) for one config."""
    jm = JCNN(**kw)
    n = int(np.prod(kw["lattice_shape"])) * kw.get("basis", 1)
    v = jm.init(jax.random.key(seed), jnp.ones((1, n), jnp.float32))
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    return jm, TCNN(**kw), flat, n


CASES = {
    "chain_k5": dict(lattice_shape=(12,), channels=(4, 3), kernel_size=5,
                     param_scale=0.3),
    "square_even_k": dict(lattice_shape=(4, 4), channels=(3, 2),
                          kernel_size=2, param_scale=0.3),
    "open_boundaries": dict(lattice_shape=(3, 4), channels=(3, 3),
                            kernel_size=3, pbc=False, param_scale=0.3),
    "residual_selu_fan_in": dict(lattice_shape=(4, 4), channels=(4, 4, 4, 4),
                                 kernel_size=3, activation="selu",
                                 residual=True, init_mode="fan_in",
                                 param_scale=1.0),
    "kernel_wider_than_lattice": dict(lattice_shape=(3, 3), channels=(2,),
                                      kernel_size=5, param_scale=0.3),
    "honeycomb_basis": dict(lattice_shape=(2, 3), channels=(3, 2),
                            kernel_size=3, basis=2, param_scale=0.3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_psi_matches_jax(name):
    jm, tm, flat, n = both(CASES[name])
    s = spins(np.random.default_rng(1), 16, n)
    want = j_apply(jm, jax.tree_util.tree_map(jnp.asarray,
                                              _unflatten(flat)), s)
    got = t_apply(tm, params_from_jax(flat), torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=RTOL, atol=ATOL)
    assert np.all(got.im.numpy() == 0.0)


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def test_fixture_matches_jax():
    """The committed heis10x10_sr snapshot (C=16^3, 10x10, k=3)."""
    flat = load_checkpoint_params(FIXTURE)
    kw = dict(lattice_shape=(10, 10), channels=(16, 16, 16), kernel_size=3)
    s = spins(np.random.default_rng(2), 8, 100)
    want = j_apply(JCNN(**kw), _unflatten(flat), s)
    got = t_apply(TCNN(**kw), params_from_jax(flat), torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=RTOL, atol=ATOL)


def test_translation_invariance():
    _, tm, flat, _ = both(dict(lattice_shape=(4, 6), channels=(4, 3),
                               kernel_size=3, param_scale=0.3))
    p = params_from_jax(flat)
    s = torch.from_numpy(spins(np.random.default_rng(3), 8, 24))
    base = t_apply(tm, p, s).re
    grid = s.reshape(8, 4, 6)
    for shift in [(1, 0), (0, 1), (2, 5), (3, 3)]:
        moved = torch.roll(grid, shift, dims=(1, 2)).reshape(8, 24)
        np.testing.assert_allclose(t_apply(tm, p, moved).re.numpy(),
                                   base.numpy(), rtol=1e-6, atol=1e-6)


def test_npz_round_trip_bit_identical(tmp_path):
    flat = load_checkpoint_params(FIXTURE)
    back = params_to_jax(params_from_jax(flat))
    assert sorted(back) == sorted(flat)
    path = tmp_path / "x.params.npz"
    np.savez(path, **back)
    again = load_checkpoint_params(str(path))
    for k, v in flat.items():
        assert again[k].dtype == v.dtype
        np.testing.assert_array_equal(again[k], v)


def test_kernel_std_and_init_shapes():
    for mode, scale, fan in (("fixed", 0.05, 9), ("fan_in", 1.0, 144)):
        assert t_kernel_std(mode, scale, fan) == j_kernel_std(mode, scale,
                                                              fan)
    kw = dict(lattice_shape=(4, 4), channels=(5, 3), kernel_size=3)
    _, tm, flat, _ = both(kw)
    fresh = tm.init(0)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in flat.items()}


def test_later_slices_raise():
    with pytest.raises(NotImplementedError):
        TCNN(lattice_shape=(4,), channels=(2,), complex_params=True)
    with pytest.raises(NotImplementedError):
        TCNN(lattice_shape=(4,), channels=(2,), compute_dtype="bfloat16")
