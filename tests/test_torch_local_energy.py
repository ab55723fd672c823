"""PyTorch port, slice 1: Hamiltonians and local energies.

``connected_batch`` / ``diag_batch`` must be array-equal to the JAX
package's (the couplings are dyadic, so every partial sum of the diagonal
is exact in float32 whatever the summation order); E_loc must match JAX on the same parameters and walkers (rtol
2e-5, atol 1e-4: float32, different summation order); and on small
lattices the |psi|^2-weighted mean of E_loc over all configurations must
equal <psi|H|psi>/<psi|psi> from the ED oracle (float32 vs float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.lattice import Lattice as JLattice
from qmcnn_tpu.models.cnn import LogPsiCNN as JCNN
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.ops import exact as jexact
from qmcnn_tpu.ops import hamiltonians as jh
from qmcnn_tpu.ops.local_energy import local_energy as j_eloc
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch.lattice import Lattice as TLattice
from qmcnn_tpu_torch.models.cnn import LogPsiCNN as TCNN
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops import exact as texact
from qmcnn_tpu_torch.ops import hamiltonians as th
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy as t_eloc
from qmcnn_tpu_torch.utils.transfer import params_from_jax

HAMS = {
    "tfim_chain": (dict(shape=(8,)), "TFIM", dict(j=0.8, h=1.3, hz=0.3)),
    "heis_square": (dict(shape=(4, 4)), "Heisenberg", dict(delta=0.75)),
    "j1j2_square": (dict(shape=(4, 4)), "Heisenberg", dict(j2=0.5)),
    "heis_triangular": (dict(shape=(3, 3), geometry="triangular"),
                        "Heisenberg", dict(marshall=False)),
    "heis_open_chain": (dict(shape=(6,), pbc=False), "Heisenberg", {}),
}


def make(name):
    lat_kw, cls, kw = HAMS[name]
    return (getattr(jh, cls)(JLattice(**lat_kw), **kw),
            getattr(th, cls)(TLattice(**lat_kw), **kw))


def spins(rng, b, n):
    return (2.0 * rng.integers(0, 2, size=(b, n)) - 1.0).astype(np.float32)


@pytest.mark.parametrize("name", sorted(HAMS))
def test_connected_and_diag_equal(name):
    jham, tham = make(name)
    n = tham.lattice.n_sites
    s = spins(np.random.default_rng(0), 12, n)
    assert tham.n_conn == jham.n_conn
    np.testing.assert_array_equal(tham.diag_batch(torch.from_numpy(s)),
                                  np.asarray(jham.diag_batch(s)))
    for got, want in zip(tham.connected_batch(torch.from_numpy(s)),
                         jham.connected_batch(s)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_matrix_equal():
    jham = jh.Heisenberg(JLattice((2, 4)), j2=0.5)
    tham = th.Heisenberg(TLattice((2, 4)), j2=0.5)
    np.testing.assert_array_equal(texact.dense_from_hamiltonian(tham),
                                  jexact.dense_from_hamiltonian(jham))


def _models(shape, seed=0):
    kw = dict(lattice_shape=shape, channels=(4, 3), kernel_size=3,
              param_scale=0.3)
    jm = JCNN(**kw)
    n = int(np.prod(shape))
    v = jm.init(jax.random.key(seed), jnp.ones((1, n), jnp.float32))
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    tm = TCNN(**kw)
    return (lambda p, s: j_apply(jm, p, s), v,
            lambda p, s: t_apply(tm, p, s), params_from_jax(flat))


@pytest.mark.parametrize("name", ["tfim_chain", "heis_square"])
def test_local_energy_matches_jax(name):
    jham, tham = make(name)
    jf, jp, tf, tp = _models(tham.lattice.shape)
    s = spins(np.random.default_rng(1), 16, tham.lattice.n_sites)
    want = j_eloc(jf, jp, jham, s, jf(jp, s))
    ts = torch.from_numpy(s)
    got = t_eloc(tf, tp, tham, ts, tf(tp, ts))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               atol=1e-6)
    chunked = t_eloc(tf, tp, tham, ts, tf(tp, ts), chunk_size=4)
    np.testing.assert_allclose(chunked.re.numpy(), got.re.numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_eloc(tf, tp, tham, ts, tf(tp, ts), chunk_size=5)


@pytest.mark.parametrize("name", ["tfim_chain", "heis_open_chain"])
def test_weighted_local_energy_equals_expectation(name):
    _, tham = make(name)
    n = tham.lattice.n_sites
    _, _, tf, tp = _models(tham.lattice.shape, seed=3)
    s = torch.from_numpy(texact.all_configs(n))
    lp = tf(tp, s)
    e = t_eloc(tf, tp, tham, s, lp)
    w = np.exp(2.0 * (lp.re.double().numpy() - lp.re.double().numpy().max()))
    w /= w.sum()
    mean_eloc = float(np.sum(w * e.re.double().numpy()))
    h = texact.dense_from_hamiltonian(tham).real
    psi = np.exp(lp.re.double().numpy() - lp.re.double().numpy().max())
    expect = float(psi @ h @ psi / (psi @ psi))
    assert mean_eloc == pytest.approx(expect, rel=1e-5, abs=1e-5)


def test_cplx_helpers():
    from qmcnn_tpu.ops import cplx as jc
    from qmcnn_tpu_torch.ops import cplx as tc

    x = np.array([-40.0, -3.0, -1e-4, 0.0, 2e-3, 0.7, 25.0], np.float32)
    np.testing.assert_allclose(tc.lncosh_real(torch.from_numpy(x)).numpy(),
                               np.asarray(jc.lncosh_real(x)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tc.selu_real(torch.from_numpy(x)).numpy(),
                               np.asarray(jc.selu_real(x)), rtol=1e-6,
                               atol=1e-7)
    re = np.array([[1.0, 50.0], [-3.0, 49.0], [0.5, -80.0]], np.float32)
    im = np.array([[0.0, 3.0], [3.1, -3.1], [1.0, 0.2]], np.float32)
    got = tc.logmeanexp(C(torch.from_numpy(re), torch.from_numpy(im)), dim=0)
    want = jc.logmeanexp(jc.C(re, im), axis=0)
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               rtol=1e-6, atol=1e-6)
    e = tc.cexp(C(torch.tensor([0.3]), torch.tensor([2.0])))
    want_e = jc.cexp(jc.C(np.float32([0.3]), np.float32([2.0])))
    np.testing.assert_allclose(e.re.numpy(), np.asarray(want_e.re), rtol=1e-6)
    np.testing.assert_allclose(e.im.numpy(), np.asarray(want_e.im), rtol=1e-6)
