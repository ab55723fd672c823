"""PyTorch port, slice 13: the TDVP layer (``qmcnn_tpu_torch/ops/tdvp.py``)
against the JAX package's ``qmcnn_tpu/ops/tdvp.py``.

Both packages take the same params (``params_from_jax``) and the same
states: the enumerated basis of an 8-site TFIM chain (Born weights), or
32 configurations drawn with numpy from a seed (uniform weights, MC
mode). The models are a real and a complex CNN. Tolerances: the basis
exact; the weights, energy, variance and expectations rtol 1e-5; theta-dot
rtol 1e-4 of its largest entry, at diag_shift 1e-2, where the f32 solves
are well enough conditioned (the dense S + shift has a condition number
of ~1e3-1e4 there; at shift 1e-4 it is ~1e6 and two f32 Cholesky solves
differ by ~2e-3 of the largest entry in either package); epsilon^2 and the
solver residual within 1e-5 absolute; one Euler or Heun step's params
rtol 1e-4 of the largest entry.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.ops import tdvp as jt
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops import tdvp as tt
from qmcnn_tpu_torch.sr import ravel
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 8
SHIFT = 1e-2
M_MC = 32


def text(complex_params: bool) -> str:
    return f"""
lattice: {{shape: [{N}]}}
model: {{channels: [4, 4], kernel_size: 3,
         complex_params: {str(complex_params).lower()}, param_scale: 0.2}}
hamiltonian: {{kind: tfim, h: 1.2}}
"""


class System:
    """One model in both packages: the log psi functions, the Hamiltonians
    and the same params; the basis and a uniform-weight MC batch."""

    def __init__(self, complex_params: bool):
        y = text(complex_params)
        cj, ct = jcfg.from_yaml(y), tcfg.from_yaml(y)
        lj, lt = jb.build_lattice(cj), tb.build_lattice(ct)
        self.hj, self.ht = jb.build_hamiltonian(cj, lj), tb.build_hamiltonian(
            ct, lt)
        mj, mt = jb.build_model(cj, lj), tb.build_model(ct, lt)
        self.fj = lambda p, s: j_apply(mj, p, s)
        self.ft = lambda p, s: t_apply(mt, p, s)
        self.pj = mj.init(jax.random.key(3), jnp.ones((1, N), jnp.float32))
        self.pt = params_from_jax(
            {k: np.asarray(v) for k, v in _flatten(self.pj).items()})
        self.sj = jnp.asarray(jt.all_states(N))
        self.st = torch.as_tensor(tt.all_states(N))
        rng = np.random.default_rng(11)
        mc = (2 * rng.integers(0, 2, (M_MC, N)) - 1).astype(np.float32)
        self.mcj, self.mct = jnp.asarray(mc), torch.as_tensor(mc)
        self.lattice = lt

    def samples(self, weights: str):
        """((s, w) JAX, (s, w) port) for 'born' or 'uniform' weights."""
        if weights == "born":
            return ((self.sj, jt.state_weights(self.fj, self.pj, self.sj)),
                    (self.st, tt.state_weights(self.ft, self.pt, self.st)))
        w = np.full(M_MC, 1.0 / M_MC, np.float32)
        return (self.mcj, jnp.asarray(w)), (self.mct, torch.as_tensor(w))


@pytest.fixture(scope="module")
def systems():
    return {"real": System(False), "complex": System(True)}


def flat_j(tree) -> np.ndarray:
    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0], np.float64)


def flat_t(params) -> np.ndarray:
    return ravel(params)[0].numpy().astype(np.float64)


def close_scaled(got, want, rtol, what=""):
    """Elementwise within rtol of the largest entry of ``want``."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("n, sz_zero", [(6, False), (8, False), (6, True),
                                        (8, True), (10, True)])
def test_all_states_is_jax_basis(n, sz_zero):
    want = jt.all_states(n, sz_zero=sz_zero)
    got = tt.all_states(n, sz_zero=sz_zero)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("n, sz_zero, match", [(25, False, "intractable"),
                                               (7, True, "even number")])
def test_all_states_refusals(n, sz_zero, match):
    for mod in (jt, tt):
        with pytest.raises(ValueError, match=match):
            mod.all_states(n, sz_zero=sz_zero)


@pytest.mark.parametrize("model", ["real", "complex"])
def test_state_weights_and_expectation(systems, model):
    """Born weights over the basis, and <sigma_x> and <H> as expectations
    under them and under uniform weights."""
    from qmcnn_tpu.ops.hamiltonians import TFIM as JTFIM
    from qmcnn_tpu_torch.ops.hamiltonians import TFIM as TTFIM

    c = systems[model]
    wj = jt.state_weights(c.fj, c.pj, c.sj)
    wt = tt.state_weights(c.ft, c.pt, c.st)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-5 * float(np.max(wj)))
    assert abs(float(wt.sum()) - 1.0) < 1e-6
    sx_j, sx_t = JTFIM(c.hj.lattice, j=0.0, h=1.0), TTFIM(c.lattice, j=0.0,
                                                         h=1.0)
    for weights in ("born", "uniform"):
        (sj, wj), (st, wt) = c.samples(weights)
        for opj, opt in ((sx_j, sx_t), (c.hj, c.ht)):
            ej = jt.expectation(c.fj, c.pj, opj, sj, wj)
            et = tt.expectation(c.ft, c.pt, opt, st, wt, chunk_size=8)
            scale = abs(float(ej.re)) + abs(float(ej.im))
            assert abs(float(et.re) - float(ej.re)) <= 1e-5 * scale + 1e-6
            assert abs(float(et.im) - float(ej.im)) <= 1e-5 * scale + 1e-6


#: (mode, model, with_im): the imaginary-time flow of both models (the
#: real one without and with its identically-zero J_im block) and the
#: real-time flow of the complex one
FLOWS = [("imag", "real", False), ("imag", "real", True),
         ("imag", "complex", True), ("real", "complex", True)]


@pytest.mark.parametrize("weights", ["born", "uniform"])
@pytest.mark.parametrize("solver", ["dense", "minsr"])
@pytest.mark.parametrize("mode, model, with_im", FLOWS)
def test_rhs_matches_jax(systems, mode, model, with_im, solver, weights):
    """TDVP.rhs: theta-dot, the energy and its variance, epsilon^2 and the
    residual. theta-dot's sign and block order are what a real-time flow
    gets wrong while still conserving energy, so it is compared entry by
    entry."""
    c = systems[model]
    (sj, wj), (st, wt) = c.samples(weights)
    kw = dict(mode=mode, solver=solver, diag_shift=SHIFT, with_im=with_im)
    rj = jt.TDVP(c.fj, c.hj, **kw).rhs(c.pj, sj, wj)
    rt = tt.TDVP(c.ft, c.ht, chunk_size=8, jacobian_chunk=8, **kw).rhs(
        c.pt, st, wt)
    close_scaled(flat_t(rt.theta_dot), flat_j(rj.theta_dot), 1e-4,
                 "theta_dot")
    assert sorted(rt.theta_dot) == sorted(c.pt)
    for a, b in ((rt.energy.re, rj.energy.re), (rt.e_var, rj.e_var)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert abs(float(rt.energy.im) - float(rj.energy.im)) <= 1e-5 * abs(
        float(rj.energy.re))
    assert abs(float(rt.tdvp_error) - float(rj.tdvp_error)) <= 1e-5
    assert abs(float(rt.residual) - float(rj.residual)) <= 1e-5
    assert 0.0 <= float(rt.tdvp_error) <= 1.0


def test_rhs_condition_number_at_the_compared_shift(systems):
    """The premise of theta-dot's rtol: at SHIFT the dense S + shift of
    the complex model's full sum is conditioned well enough for f32."""
    c = systems["complex"]
    (_, _), (st, wt) = c.samples("born")
    from qmcnn_tpu_torch.sr import materialize_jacobian

    j_re, j_im, _ = materialize_jacobian(c.ft, c.pt, st)
    o = torch.cat([j - (wt[:, None] * j).sum(0) for j in (j_re, j_im)])
    sw = torch.sqrt(torch.cat([wt, wt]))[:, None]
    s_mat = ((sw * o).T @ (sw * o)).double()
    eig = torch.linalg.eigvalsh(s_mat + SHIFT * torch.eye(s_mat.shape[0],
                                                          dtype=torch.double))
    cond = float(eig[-1] / eig[0])
    assert 10.0 < cond < 1e5, cond


@pytest.mark.parametrize("mode, model, with_im", [("imag", "real", False),
                                                  ("real", "complex", True)])
@pytest.mark.parametrize("integrator", ["euler", "heun", "heun_resample"])
def test_integrators_match_jax(systems, mode, model, with_im, integrator):
    """step_euler, and step_heun with and without resample (the full-sum
    reweighting at the predictor): the new params, and the first stage's
    energy that both return."""
    c = systems[model]
    (sj, wj), (st, wt) = c.samples("born")
    kw = dict(mode=mode, solver="minsr", diag_shift=SHIFT, with_im=with_im)
    tdj, tdt = jt.TDVP(c.fj, c.hj, **kw), tt.TDVP(c.ft, c.ht, **kw)
    dt = 0.05
    if integrator == "euler":
        nj, rj = tdj.step_euler(c.pj, dt, sj, wj)
        nt, rt = tdt.step_euler(c.pt, dt, st, wt)
    else:
        res_j = res_t = None
        if integrator == "heun_resample":
            def res_j(p):
                return sj, jt.state_weights(c.fj, p, sj)

            def res_t(p):
                return st, tt.state_weights(c.ft, p, st)
        nj, rj = tdj.step_heun(c.pj, dt, sj, wj, resample=res_j)
        nt, rt = tdt.step_heun(c.pt, dt, st, wt, resample=res_t)
    close_scaled(flat_t(nt), flat_j(nj), 1e-4, "params")
    close_scaled(flat_t(nt) - flat_t(c.pt), flat_j(nj) - flat_j(c.pj), 1e-4,
                 "update")
    np.testing.assert_allclose(float(rt.energy.re), float(rj.energy.re),
                               rtol=1e-5)


def test_heun_resamples_at_the_predictor(systems):
    """With ``resample`` the second stage reads the predictor's samples
    (called once, with the predictor params); the result differs from the
    reused-sample step."""
    c = systems["real"]
    (_, _), (st, wt) = c.samples("born")
    td = tt.TDVP(c.ft, c.ht, mode="imag", solver="dense", diag_shift=SHIFT,
                 with_im=False)
    seen = []

    def resample(p):
        seen.append(p)
        return st, tt.state_weights(c.ft, p, st)

    new_r, r1 = td.step_heun(c.pt, 0.1, st, wt, resample=resample)
    new_0, _ = td.step_heun(c.pt, 0.1, st, wt)
    assert len(seen) == 1
    pred = {k: c.pt[k] + 0.1 * r1.theta_dot[k] for k in c.pt}
    for k in c.pt:
        torch.testing.assert_close(seen[0][k], pred[k])
    assert float(np.abs(flat_t(new_r) - flat_t(new_0)).max()) > 0


def test_post_init_refusals(systems):
    c = systems["real"]
    for mod, f, h in ((jt, c.fj, c.hj), (tt, c.ft, c.ht)):
        with pytest.raises(ValueError, match="unknown TDVP mode"):
            mod.TDVP(f, h, mode="sideways")
        with pytest.raises(ValueError, match="unknown TDVP solver"):
            mod.TDVP(f, h, solver="pcg")
        with pytest.raises(ValueError, match="imaginary score"):
            mod.TDVP(f, h, mode="real", with_im=False)


def test_two_forwards(systems):
    """log psi and E_loc go through ``eval_log_psi_fn`` (counted), the
    Jacobian through ``log_psi_fn``; the result is the one-forward rhs."""
    c = systems["complex"]
    (_, _), (st, wt) = c.samples("born")
    calls = []

    def counted(p, s):
        calls.append(s.shape[0])
        return c.ft(p, s)

    kw = dict(mode="real", solver="dense", diag_shift=SHIFT)
    one = tt.TDVP(c.ft, c.ht, **kw).rhs(c.pt, st, wt)
    two = tt.TDVP(c.ft, c.ht, eval_log_psi_fn=counted, chunk_size=64,
                  **kw).rhs(c.pt, st, wt)
    # log psi of the 256 states, then E_loc's 4 chunks of 64 x 8 flips
    assert calls == [256] + [64 * N] * 4
    close_scaled(flat_t(two.theta_dot), flat_t(one.theta_dot), 1e-5)
