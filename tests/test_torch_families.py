"""PyTorch port, slice 9: the RBM (models/rbm.py), the CNN's translation
and point-group averaging (models/cnn.py), the XYZ Hamiltonian
(ops/hamiltonians.py), the builder's new branches and guards, and the
three JAX snapshots of this slice, each against the JAX package on equal
numpy-seeded inputs.

Tolerances: log psi rtol/atol 1e-4 (the phase modulo 2 pi); XYZ connected
states, matrix elements and masks bitwise; E_loc rtol/atol 1e-5; every
guard raises the JAX package's error with its message."""
import glob
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.lattice import Lattice as JLattice
from qmcnn_tpu.models import cnn as jc
from qmcnn_tpu.models import rbm as jr
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.ops import hamiltonians as jh
from qmcnn_tpu.ops.local_energy import local_energy as j_eloc
from qmcnn_tpu.utils.transfer import _flatten, load_checkpoint_params
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.lattice import Lattice as TLattice
from qmcnn_tpu_torch.models import cnn as tc
from qmcnn_tpu_torch.models import rbm as tr
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.ops import hamiltonians as th
from qmcnn_tpu_torch.ops.local_energy import local_energy as t_eloc
from qmcnn_tpu_torch.sampler.direct import DirectSampler
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.test_torch_priors import _spins, _unflatten
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
CONFIGS = sorted(os.path.basename(p)[:-5]
                 for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
TOL = 1e-4


def assert_log_psi_close(got, want, tol=TOL):
    """Re within rtol/atol ``tol``; the phase modulo 2 pi, its rtol taken
    of the size of the phase before wrapping (as the real part's is of its
    own size): the phase is a sum of terms of that size, each carrying f32
    rounding. On the 8x8 ViT snapshot at one of the 64 configurations
    JAX's own f32 phase lies 1.4e-4 from a float64 evaluation (the port's
    5.9e-5), at a phase of -2.03."""
    np.testing.assert_allclose(got.re.detach().numpy(), np.asarray(want.re),
                               rtol=tol, atol=tol)
    want_im = np.asarray(want.im, np.float64)
    dphi = got.im.detach().numpy() - want_im
    dphi = (dphi + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(want_im + dphi, want_im, rtol=tol, atol=tol)


def assert_amplitudes_close(got, want, tol=TOL):
    """psi / max |psi| within ``tol``: a momentum sector has exact nodes
    (a configuration that a translation maps to itself may have its
    phases cancel), where log psi is unbounded and its f32 value
    arbitrary."""
    top = np.max(np.asarray(want.re))

    def amp(z):
        re, im = (np.asarray(x, np.float64) for x in z)
        return np.exp(re - top + 1j * im)

    np.testing.assert_allclose(amp(got), amp(want), rtol=0, atol=tol)


def _same_params(jm, tm, n, seed=0, noise=0.1):
    """JAX init plus numpy-seeded noise on every leaf, in both packages."""
    v = jm.init(jax.random.key(seed), jnp.ones((1, n), jnp.float32))
    rng = np.random.default_rng(seed + 1)
    flat = {k: (np.asarray(x) + noise * rng.normal(size=np.shape(x))).astype(
        np.float32) for k, x in _flatten(v).items()}
    p = params_from_jax(flat)
    assert sorted(p) == sorted(tm.init(0))
    return _unflatten(flat), p


# ---------------------------------------------------------------------------
# RBM and the averaging wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("complex_params", [False, True])
def test_rbm_matches_jax(tie, complex_params):
    kw = dict(lattice_shape=(4, 3), alpha=2, complex_params=complex_params,
              tie_translations=tie, param_scale=0.1)
    jm, tm = jr.LogPsiRBM(**kw), tr.LogPsiRBM(**kw)
    v, p = _same_params(jm, tm, 12)
    s = _spins(1, 40, 12)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)), jm.apply(v, s))
    if tie:
        w = torch.from_numpy(_spins(2, 12, 6).reshape(4, 3, 1, 6))
        np.testing.assert_array_equal(
            tr.circulant_weight(w, (4, 3)).numpy(),
            np.asarray(jc.circulant_weight(jnp.asarray(w.numpy()), (4, 3))))


WRAPPED = {
    "translation": dict(translation=dict()),
    "translation_stride_momentum": dict(
        translation=dict(shift_stride=2, momentum=(1, 0))),
    "translation_momentum_chain": dict(shape=(8,), translation=dict(
        momentum=(3,))),
    "point_group": dict(point_group=True),
    "point_group_rectangle": dict(shape=(4, 2), point_group=True),
    "both_complex": dict(translation=dict(momentum=(0, 1)), point_group=True,
                         complex_params=True),
}


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_averaged_models_match_jax(name):
    """TranslationAveraged (with shift_stride and momentum phases) and
    PointGroupAveraged around an untied RBM, which no lattice symmetry
    leaves invariant (a momentum projection of an invariant model would
    cancel to 0)."""
    w = WRAPPED[name]
    shape = w.get("shape", (4, 4))
    n = int(np.prod(shape))
    kw = dict(lattice_shape=shape, alpha=1, param_scale=0.2,
              complex_params=w.get("complex_params", False))
    jm, tm = jr.LogPsiRBM(**kw), tr.LogPsiRBM(**kw)
    if "translation" in w:
        jm = jc.TranslationAveraged(inner=jm, lattice_shape=shape,
                                    **w["translation"])
        tm = tc.TranslationAveraged(tm, shape, **w["translation"])
    if w.get("point_group"):
        jm = jc.PointGroupAveraged(inner=jm, lattice_shape=shape)
        tm = tc.PointGroupAveraged(tm, shape)
    v, p = _same_params(jm, tm, n, noise=0.2)
    s = _spins(3, 24, n)
    got, want = t_apply(tm, p, torch.from_numpy(s)), j_apply(jm, v, s)
    if any(w.get("translation", {}).get("momentum", ())):
        assert_amplitudes_close(got, want)
    else:
        assert_log_psi_close(got, want)


# ---------------------------------------------------------------------------
# XYZ
# ---------------------------------------------------------------------------

XYZ_CASES = {
    "chain_xxz": (dict(shape=(8,)), dict(jx=1.0, jy=1.0, jz=0.5)),
    "chain_xyz_fields": (dict(shape=(8,)),
                         dict(jx=1.0, jy=0.4, jz=0.7, hx=0.3, hz=0.2)),
    "square_marshall": (dict(shape=(4, 4)),
                        dict(jx=1.2, jy=0.8, jz=1.0, hx=0.5, marshall=True)),
    "open_chain": (dict(shape=(6,), pbc=False), dict(jx=0.5, jy=-0.5,
                                                     jz=1.0)),
}


@pytest.mark.parametrize("name", sorted(XYZ_CASES))
def test_xyz_matches_jax(name):
    lat_kw, kw = XYZ_CASES[name]
    jham = jh.XYZ(JLattice(**lat_kw), **kw)
    tham = th.XYZ(TLattice(**lat_kw), **kw)
    assert tham.n_conn == jham.n_conn
    assert tham.conserves_sz == jham.conserves_sz
    n = tham.lattice.n_sites
    s = _spins(4, 16, n)
    ts = torch.from_numpy(s)
    for got, want in zip(tham.connected_batch(ts), jham.connected_batch(s)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tham.diag_batch(ts).numpy(),
                                  np.asarray(jham.diag_batch(s)))
    # E_loc through an RBM of equal parameters
    rkw = dict(lattice_shape=lat_kw["shape"], alpha=1, complex_params=True,
               param_scale=0.05)
    jm, tm = jr.LogPsiRBM(**rkw), tr.LogPsiRBM(**rkw)
    v, p = _same_params(jm, tm, n, noise=0.05)

    def jf(vv, x):
        return jm.apply(vv, x)

    def tf(pp, x):
        return t_apply(tm, pp, x)

    want = j_eloc(jf, v, jham, s, jf(v, s))
    got = t_eloc(tf, p, tham, ts, tf(p, ts))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               rtol=1e-5, atol=1e-5)


def test_xyz_marshall_needs_a_bipartite_lattice():
    with pytest.raises(ValueError, match="bipartite"):
        th.XYZ(TLattice((3,)), marshall=True)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _load(over, base="j1j2_4x4_vit.yaml"):
    path = os.path.join(ROOT, "configs", base)
    return jcfg.load(path, over), tcfg.load(path, over)


#: (base config, overrides) that the JAX builder refuses with a ValueError
GUARDS = {
    "arnn_translation": ("tfim16_arnn.yaml",
                         ("model.translation_average=true",)),
    "arnn_point_group": ("j1j2_4x4_arnn.yaml",
                         ("model.point_group_average=true",)),
    "arnn_spin_flip": ("tfim16_arnn.yaml", ("model.spin_flip_sector=1",)),
    "arnn_jastrow": ("tfim16_arnn.yaml", ("model.jastrow=true",)),
    "arnn_phase_net": ("tfim16_arnn.yaml", ("model.phase_net_channels=[2]",)),
    "arnn_odd_sz0": ("heis40_arnn.yaml", ("lattice.shape=[39]",
                                          "hamiltonian.marshall=false")),
    "arnn_conv_chain": ("tfim16_arnn.yaml", ("model.arnn_conv_kernel=3",)),
    "arnn_conv_honeycomb": ("honeycomb3x3_heis.yaml", (
        "model.kind=arnn", "model.arnn_conv_kernel=3",
        "model.spin_flip_sector=0", "sampler.kind=auto")),
    "arnn_bad_sector": ("tfim16_arnn.yaml", ("model.arnn_sector=sz1",)),
    "vit_open": ("j1j2_4x4_vit.yaml", ("lattice.pbc=false",
                                       "hamiltonian.marshall=false")),
    "vit_triangular": ("tri6x3_j1j2.yaml", ("model.kind=vit",
                                            "model.channels=[8]",
                                            "lattice.shape=[6,4]")),
    "vit_translation": ("j1j2_4x4_vit.yaml",
                        ("model.translation_average=true",)),
    "vit_point_group_chain": ("j1j2_4x4_vit.yaml", (
        "lattice.shape=[16]", "model.point_group_average=true")),
    "rbm_tied_open": ("tfim16_sgd.yaml", ("model.kind=rbm",
                                          "lattice.pbc=false")),
    "rbm_momentum": ("tfim16_sgd.yaml", ("model.kind=rbm",
                                         "model.momentum=[1]")),
    "cnn_momentum_without_average": ("tfim16_sgd.yaml",
                                     ("model.momentum=[1]",)),
    "cnn_translation_open": ("tfim16_sgd.yaml", (
        "model.translation_average=true", "lattice.pbc=false")),
    "cnn_point_group_chain": ("tfim16_sgd.yaml",
                              ("model.point_group_average=true",)),
    "cnn_point_group_triangular": ("tri6x3_j1j2.yaml", (
        "model.point_group_average=true",)),
    "honeycomb_translation": ("honeycomb3x3_heis.yaml",
                              ("model.translation_average=true",)),
    "honeycomb_tied_rbm": ("honeycomb3x3_heis.yaml", ("model.kind=rbm",
                                                      "model.phase_bias=null",
                                                      "model.channels=[4]")),
    "direct_on_cnn": ("tfim16_sgd.yaml", ("sampler.kind=direct",)),
    "unknown_sampler": ("tfim16_sgd.yaml", ("sampler.kind=gibbs",)),
    "direct_tempering": ("tfim16_arnn.yaml",
                         ("sampler.tempering_betas=[1.0,0.5]",)),
    "xyz_exchange_moves": ("tfim16_sgd.yaml", (
        "hamiltonian.kind=xyz", "hamiltonian.jy=0.5",
        "sampler.move=exchange")),
    "pallas_tempering": ("tfim16_sgd.yaml", (
        "sampler.backend=pallas", "sampler.tempering_betas=[1.0,0.5]")),
    "lanczos_direct": ("tfim16_arnn.yaml", ("model.lanczos_alpha=0.1",)),
    "lanczos_pallas": ("tfim16_sgd.yaml", ("model.lanczos_alpha=0.1",
                                           "sampler.backend=pallas")),
    "sector_deflation": ("tfim16_sgd.yaml", (
        "optimizer.sector_momentum=[1]", "optimizer.deflate_c=2.0")),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guards_raise_as_in_jax(name):
    base, over = GUARDS[name]
    jc_, tc_ = _load(over, base)
    with pytest.raises(ValueError) as info:
        jb.build(jc_)
    with pytest.raises(ValueError, match=re.escape(str(info.value))):
        tb.build(tc_, device="cpu")


def test_later_slices_raise_not_implemented():
    """No refusal is left: the ViT's bf16 trunk (ROADMAP A20, the last one)
    builds since slice 14, as JAX's does, with a finite log psi from its
    bf16 trunk (its parity with JAX's bf16 model is
    tests/test_torch_vit.py::test_bf16_log_psi_matches_jax), and the
    (1 + alpha H) ansatz since slice 10 (tests/test_torch_sector_lanczos.py)."""
    jc_, tc_ = _load(("model.compute_dtype=bfloat16",), "j1j2_4x4_vit.yaml")
    jb.build(jc_)
    vmc, params, _ = tb.build(tc_, device="cpu")
    lp = vmc.log_psi_fn(params, torch.from_numpy(_spins(3, 16, 16)))
    assert lp.re.dtype == torch.float32
    assert torch.isfinite(lp.re).all() and torch.isfinite(lp.im).all()
    model = tb.build_model(tc_, tb.build_lattice(tc_))
    inner = getattr(model, "inner", model)
    assert inner.dtype == torch.bfloat16


@pytest.mark.parametrize("move,hx,jy", [("auto", 0.0, 1.0), ("auto", 0.2, 1.0),
                                        ("auto", 0.0, 0.5), ("flip", 0.0, 0.5),
                                        ("exchange_anti", 0.0, 1.0)])
def test_resolve_move_and_sampler_kind_match_jax(move, hx, jy):
    over = ("hamiltonian.kind=xyz", f"hamiltonian.hx={hx}",
            f"hamiltonian.jy={jy}", f"sampler.move={move}")
    jc_, tc_ = _load(over, "tfim16_sgd.yaml")
    assert tb.resolve_move(tc_) == jb.resolve_move(jc_)
    for name in CONFIGS:
        path = os.path.join(ROOT, "configs", f"{name}.yaml")
        jcc, tcc = jcfg.load(path), tcfg.load(path)
        assert tb.resolve_sampler_kind(tcc) == jb.resolve_sampler_kind(jcc)
        if jcc.model.kind == "arnn":
            assert tb.resolve_arnn_sector(tcc) == jb.resolve_arnn_sector(jcc)


@pytest.mark.parametrize("config", CONFIGS)
def test_log_psi_is_real_matches_jax(config):
    """model_log_psi_is_real answers as JAX's on every config, and on its
    ARNN (with and without a phase prior), ViT and RBM variants."""
    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    variants = [(), ("model.complex_params=false",),
                ("model.phase_bias=marshall",), ("model.kind=rbm",),
                ("model.kind=arnn", "model.complex_params=false",
                 "model.spin_flip_sector=0"),
                ("model.kind=vit", "model.spin_flip_sector=-1")]
    for over in variants:
        jc_, tc_ = jcfg.load(path, over), tcfg.load(path, over)
        assert tb.model_log_psi_is_real(tc_) == jb.model_log_psi_is_real(jc_)


def test_builder_wires_the_direct_sampler():
    """ARNN configs get the direct sampler, with the inner ARNN's
    conditionals under a pure-phase Jastrow factor; the XYZ model builds
    with its S^z-breaking move."""
    jc_, tc_ = _load(("model.jastrow_phase=true", "run.seed=3"),
                     "tfim16_arnn.yaml")
    vmc, params, _ = tb.build(tc_, device="cpu")
    assert isinstance(vmc.sampler, DirectSampler)
    assert "params/u" in params and "params/inner/w_out" in params
    state = vmc.init_state(5, 32, params)
    walkers = vmc.sampler.sample(params, state.walkers, 9, torch.arange(32))
    assert set(walkers.s.unique().tolist()) == {-1.0, 1.0}
    # the stored log psi is the wrapped model's (the pair phase u is 0 at
    # init, so set it to see it)
    params = dict(params)
    params["params/u"] = torch.linspace(-1, 1, len(params["params/u"]))
    walkers = vmc.sampler.sample(params, state.walkers, 9, torch.arange(32))
    lp = vmc.log_psi_fn(params, walkers.s)
    assert torch.equal(walkers.log_psi.im, lp.im)
    heis = tb.build(_load((), "heis40_arnn.yaml")[1], device="cpu")[0]
    assert heis.sampler.sz_zero
    xyz = tb.build(_load(("hamiltonian.kind=xyz", "hamiltonian.hx=0.3"),
                         "tfim16_sgd.yaml")[1], device="cpu")[0]
    assert isinstance(xyz.ham, th.XYZ) and xyz.sampler.move == "flip"


# ---------------------------------------------------------------------------
# the JAX snapshots of this slice
# ---------------------------------------------------------------------------

FIXTURES = ["j1j2_4x4_vit_cap", "j1j2_8x8_vit_cap", "kagome3x3_r3_arnn"]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_log_psi_matches_jax(name):
    """Each trained snapshot in its run's own config (from its meta.json):
    the port's model takes its parameters unchanged (every key and shape)
    and gives JAX's log psi on 64 configurations."""
    with open(os.path.join(RUNS, f"{name}.csv.meta.json")) as f:
        text = json.load(f)["config"]
    jc_, tc_ = jcfg.from_yaml(text), tcfg.from_yaml(text)
    jl, tl = jb.build_lattice(jc_), tb.build_lattice(tc_)
    jm, tm = jb.build_model(jc_, jl), tb.build_model(tc_, tl)
    flat = load_checkpoint_params(os.path.join(RUNS,
                                               f"{name}.csv.params.npz"))
    flat = {k: np.asarray(x) for k, x in flat.items()}
    p = params_from_jax(flat)
    init = tm.init(0)
    assert sorted(init) == sorted(p)
    for k, x in init.items():
        assert tuple(x.shape) == tuple(p[k].shape), k
    s = _spins(7, 64, tl.n_sites)
    want = j_apply(jm, _unflatten(flat), s)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)), want)


@pytest.mark.parametrize("config", ["j1j2_4x4_vit", "j1j2_8x8_vit",
                                    "tfim16_arnn", "j1j2_4x4_arnn",
                                    "heis40_arnn"])
def test_new_configs_count_their_params_as_jax(config):
    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    jc_, tc_ = jcfg.load(path), tcfg.load(path)
    jm = jb.build_model(jc_, jb.build_lattice(jc_))
    tl = tb.build_lattice(tc_)
    v = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                       jnp.ones((1, tl.n_sites))))
    want = {k: tuple(x.shape) for k, x in _flatten(v).items()}
    got = {k: tuple(x.shape) for k, x in
           tb.build_model(tc_, tl).init(0).items()}
    assert got == want
