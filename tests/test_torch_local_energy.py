"""PyTorch port, slice 1: Hamiltonians and local energies.

``connected_batch`` / ``diag_batch`` must be array-equal to the JAX
package's (the couplings are dyadic, so every partial sum of the diagonal
is exact in float32 whatever the summation order); E_loc must match JAX on the same parameters and walkers (rtol
2e-5, atol 1e-4: float32, different summation order); and on small
lattices the |psi|^2-weighted mean of E_loc over all configurations must
equal <psi|H|psi>/<psi|psi> from the ED oracle (float32 vs float64). E_loc
forwards only the connected rows that carry an element, and is held to the
static-batch formula of ``tests/torch_static_eloc.py`` (bitwise with a
row-wise log psi)."""
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
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops import exact as texact
from qmcnn_tpu_torch.ops import hamiltonians as th
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy as t_eloc
from qmcnn_tpu_torch.utils import profiling
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_static_eloc import static_connected_sum as _static_sum
from tests.torch_static_eloc import static_local_energy

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


#: torch-only cases beside ``HAMS``: aligned XYZ pair flips carry an element
#: where Jx != Jy; with a field, every single flip does as well
XYZ_CASES = {
    "xyz_jx_ne_jy": dict(jx=1.0, jy=0.6, jz=0.8),
    "xyz_field": dict(jx=0.9, jy=0.9, jz=1.1, hx=0.7, marshall=True),
}


def make_torch(name):
    if name in XYZ_CASES:
        return th.XYZ(TLattice((4, 4)), **XYZ_CASES[name])
    return make(name)[1]


def _rowwise(params, s):
    """A log psi whose value on a row depends on that row alone and is the
    same bit for bit in any batch: integer-valued features (exact float32
    sums in any order), then elementwise maps."""
    a = (s * params["a"]).sum(-1)
    b = (s * torch.roll(s, 1, dims=-1)).sum(-1)
    return C(0.3 * torch.tanh(0.1 * a) + 0.05 * b,
             0.7 * torch.sin(0.2 * a - 0.1 * b))


def _counted(fn, calls):
    def forward(params, s):
        calls.append(s.shape[0])
        return fn(params, s)

    return forward


def _rows():
    c = profiling.counters()
    return c.get("e_loc.rows", 0.0), c.get("e_loc.rows_connected", 0.0)


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", sorted(HAMS) + sorted(XYZ_CASES))
def test_compacted_local_energy_equals_static_batch(name, chunk):
    """E_loc forwards only the connected rows that carry an element, and is
    bitwise the static batch's formula with a row-wise log psi; the TFIM
    and XYZ at Jx != Jy (every row carries one) forward all M K rows in one
    batch, as the static batch does. One
    walker has no anti-aligned bond. The counters read mask.sum() and
    M K."""
    ham = make_torch(name)
    n, k = ham.lattice.n_sites, ham.n_conn
    s = torch.from_numpy(spins(np.random.default_rng(5), 12, n))
    s[3] = 1.0
    params = {"a": torch.from_numpy(
        np.random.default_rng(6).integers(-3, 4, n).astype(np.float32))}
    lp = _rowwise(params, s)
    mask = ham.connected_batch(s)[2]
    calls = []
    before = _rows()
    got = t_eloc(_counted(_rowwise, calls), params, ham, s, lp,
                 chunk_size=chunk)
    after = _rows()
    want = static_local_energy(_rowwise, params, ham, s, lp, chunk_size=chunk)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert after[0] - before[0] == int(mask.sum())
    assert after[1] - before[1] == s.shape[0] * k
    per_chunk = [int(mask[i:i + (chunk or 12)].sum())
                 for i in range(0, 12, chunk or 12)]
    assert calls == per_chunk
    if bool(mask.all()):
        assert calls == [(chunk or 12) * k] * len(calls)
    else:
        assert sum(calls) < 12 * k


@pytest.mark.parametrize("name", ["heis_square", "j1j2_square",
                                  "heis_triangular", "heis_open_chain"])
def test_no_anti_aligned_bond_runs_no_forward(name):
    """A batch in which no walker has an anti-aligned bond calls no forward:
    E_loc is the diagonal, as the static batch gives it."""
    ham = make_torch(name)
    n = ham.lattice.n_sites
    s = torch.ones((4, n))
    s[1::2] = -1.0
    params = {"a": torch.arange(n, dtype=torch.float32) % 3 - 1.0}
    lp = _rowwise(params, s)
    calls = []
    before = _rows()
    got = t_eloc(_counted(_rowwise, calls), params, ham, s, lp, chunk_size=2)
    after = _rows()
    want = static_local_energy(_rowwise, params, ham, s, lp)
    assert calls == []
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert torch.equal(got.re, ham.diag_batch(s))
    assert after[0] == before[0]
    assert after[1] - before[1] == 4 * ham.n_conn


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", ["heis_square", "j1j2_square"])
def test_compacted_local_energy_with_cnn(name, chunk):
    """With the plain CNN the compacted E_loc is the static batch's within
    1e-6 relative (a convolution over another batch may round otherwise)."""
    ham = make_torch(name)
    _, _, tf, tp = _models(ham.lattice.shape, seed=2)
    s = torch.from_numpy(spins(np.random.default_rng(7), 16,
                               ham.lattice.n_sites))
    lp = tf(tp, s)
    got = t_eloc(tf, tp, ham, s, lp, chunk_size=chunk)
    want = static_local_energy(tf, tp, ham, s, lp, chunk_size=chunk)
    scale = float(want.re.abs().max())
    np.testing.assert_allclose(got.re.numpy(), want.re.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got.im.numpy(), want.im.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)


def test_local_energy_under_vmap_forwards_every_row():
    """Under ``torch.func.vmap`` (a per-walker Jacobian of the (1 + alpha H)
    ansatz) the mask cannot be read on the host: every row is forwarded,
    and each walker's E_loc equals the batched one's."""
    ham = make_torch("j1j2_square")
    n = ham.lattice.n_sites
    s = torch.from_numpy(spins(np.random.default_rng(8), 6, n))
    params = {"a": torch.arange(n, dtype=torch.float32) % 5 - 2.0}

    def one(si):
        x = si[None, :]
        e = t_eloc(_rowwise, params, ham, x, _rowwise(params, x))
        return e.re[0], e.im[0]

    re, im = torch.func.vmap(one)(s)
    want = t_eloc(_rowwise, params, ham, s, _rowwise(params, s))
    np.testing.assert_allclose(re.numpy(), want.re.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(im.numpy(), want.im.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("transform", ["grad", "jacrev", "vmap_of_grad"])
def test_local_energy_under_grad_compacts_rows(transform):
    """Inside the (1 + alpha H) ansatz, E_loc under ``torch.func.grad`` or
    ``jacrev`` reads its mask and forwards only the rows that carry an
    element; a ``vmap`` over it (a per-walker gradient) batches the mask
    and forwards every row. Either way the result is the static batch's
    within float32 rounding."""
    from qmcnn_tpu_torch.ops import lanczos as tl

    ham = make_torch("j1j2_square")
    n, k = ham.lattice.n_sites, ham.n_conn
    s = torch.from_numpy(spins(np.random.default_rng(9), 6, n))
    params = {"a": torch.from_numpy(
        np.random.default_rng(10).integers(-3, 4, n).astype(np.float32)),
        tl.ALPHA_KEY: torch.tensor([0.1, 0.05])}

    def run(e_loc_fn):
        wrapped = tl.lanczos_wrap(_rowwise, ham)
        tl.local_energy = e_loc_fn
        try:
            if transform == "grad":
                out = torch.func.grad(
                    lambda q: wrapped(q, s).re.sum())(params)
            elif transform == "jacrev":
                out = torch.func.jacrev(lambda q: wrapped(q, s).im)(params)
            else:
                out = torch.func.vmap(lambda si: torch.func.grad(
                    lambda q: wrapped(q, si[None]).re[0])(params))(s)
        finally:
            tl.local_energy = t_eloc
        return torch.cat([v.reshape(-1) for v in out.values()])

    before = _rows()
    got = run(t_eloc)
    after = _rows()
    want = run(static_local_energy)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    forwarded = after[0] - before[0]
    if transform == "vmap_of_grad":  # one trace of a single walker
        assert after[1] - before[1] == forwarded == k
    else:
        assert after[1] - before[1] == 6 * k
        assert forwarded == int(ham.connected_batch(s)[2].sum()) < 6 * k


def _static_chunks(compute, s, lp, chunk):
    parts = [compute(s[i:i + chunk], lp[i:i + chunk])
             for i in range(0, s.shape[0], chunk)]
    return tuple(C(torch.cat([p[j].re for p in parts]),
                   torch.cat([p[j].im for p in parts]))
                 for j in range(len(parts[0])))


def _estimator_case(name, s, params):
    """(got, want, mask) of one connected-sum estimator on walkers ``s``:
    the port's estimator, its static-batch evaluation, and the mask of
    every connected row it sums (all of its chunks)."""
    from qmcnn_tpu_torch.ops import observables as tobs

    lattice = TLattice((4, 4))
    lp = _rowwise(params, s)
    if name == "spin_spin":
        conn = tobs.spin_spin_connected(lattice, 1, marshall=True)
        got = tobs.offdiag_observable(_rowwise, params, s, lp, conn,
                                      chunk_size=4)
        want = _static_sum(_rowwise, params, s, lp, conn).mean()
        return got, want, conn(s)[2]
    if name == "chirality":
        conn = tobs.chirality_connected(TLattice((3, 3),
                                                 geometry="triangular"))
        got = tobs.offdiag_observable(_rowwise, params, s, lp, conn,
                                      chunk_size=4)
        want = _static_sum(_rowwise, params, s, lp, conn).mean()
        return got, want, conn(s)[2]
    if name == "total_spin_sq":
        n = s.shape[1]
        got = tobs.total_spin_sq(_rowwise, params, s, lp, lattice,
                                 marshall=True, pair_chunk=50)
        mz = s.sum(-1) / 2.0
        want = C(mz * mz + n / 2.0, torch.zeros_like(mz))
        sub = np.asarray(lattice.sublattice_mask)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        for lo in range(0, len(pairs), 50):
            pk = np.asarray(pairs[lo:lo + 50])
            flips = torch.ones((len(pk), n))
            flips[np.arange(len(pk)), pk[:, 0]] = -1.0
            flips[np.arange(len(pk)), pk[:, 1]] = -1.0
            sign = torch.from_numpy(np.where(
                sub[pk[:, 0]] != sub[pk[:, 1]], -1.0, 1.0).astype(
                    np.float32))

            def conn(x, flips=flips, sign=sign, pk=pk):
                anti = (x[:, pk[:, 0]] * x[:, pk[:, 1]]) < 0.0
                return x[:, None, :] * flips[None], sign, anti

            want = want + _static_sum(_rowwise, params, s, lp, conn)
        up = (s > 0).sum(-1)
        return got, want.mean(), up * (n - up)
    ham = th.Heisenberg(lattice, j2=0.5)
    plog = tobs.translation_projected_log_psi(_rowwise, (4, 4), (1, 0))
    got = tobs.sector_energy_ratio(_rowwise, params, s, lp, ham, (4, 4),
                                   (1, 0), chunk_size=4)

    def compute(s_c, lp_c):
        off = _static_sum(plog, params, s_c, lp_c, ham.connected_batch)
        pl = plog(params, s_c)
        den = cplx.cexp(C(pl.re - lp_c.re, pl.im - lp_c.im))
        diag = ham.diag_batch(s_c)
        return (C(diag * den.re + off.re, diag * den.im + off.im), den)

    return got, _static_chunks(compute, s, lp, 4), ham.connected_batch(s)[2]


@pytest.mark.parametrize("name", ["spin_spin", "chirality", "total_spin_sq",
                                  "sector_ratio"])
def test_connected_sum_estimators_forward_only_carrying_rows(name):
    """S.S on the square lattice, the chirality on the triangular one, <S^2>
    and the momentum-sector ratio take the local energy's connected sum:
    each equals its static batch (every row forwarded) within float32
    rounding, and ``e_loc.rows`` advances by exactly the rows that carry
    an element. One walker is fully polarized (no anti-aligned pair)."""
    n = 9 if name == "chirality" else 16
    s = torch.from_numpy(spins(np.random.default_rng(11), 8, n))
    s[2] = 1.0
    params = {"a": torch.from_numpy(
        np.random.default_rng(12).integers(-3, 4, n).astype(np.float32))}
    before = _rows()
    with torch.no_grad():
        got, want, mask = _estimator_case(name, s, params)
    after = _rows()
    for g, w in zip(got if name == "sector_ratio" else (got,),
                    want if name == "sector_ratio" else (want,)):
        for a, b in ((g.re, w.re), (g.im, w.im)):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale)
    assert after[0] - before[0] == int(mask.sum()) > 0


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
