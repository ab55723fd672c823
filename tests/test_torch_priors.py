"""PyTorch port, slice 8: the phase priors, Jastrow factors and PhaseNet
(models/phase.py, models/jastrow.py, models/phasenet.py), the builder's
wrapping order, and the four frustrated-lattice snapshots, each against
the JAX package on equal numpy-seeded inputs.

Tolerances: log psi rtol 1e-4 / atol 1e-5 with the phase wrapped to
(-pi, pi] (a prior's phase may land on another branch of 2 pi k);
gradients rtol 1e-4; tables and parameter transfers exactly equal."""
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.models import jastrow as jj
from qmcnn_tpu.models import phase as jp
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils import transfer as jtransfer
from qmcnn_tpu.vmc import energy_and_grad as j_energy_and_grad
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.models import jastrow as tj
from qmcnn_tpu_torch.models import phase as tp
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized
from qmcnn_tpu_torch.models.phasenet import PhaseNet
from qmcnn_tpu_torch.sampler.direct import DirectSampler
from qmcnn_tpu_torch.sampler.metropolis import WalkerState
from qmcnn_tpu_torch.utils import transfer as ttransfer
from qmcnn_tpu_torch.vmc import energy_and_grad as t_energy_and_grad
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
LATTICES = [((8,), "hypercubic"), ((4, 4), "hypercubic"),
            ((6, 3), "triangular"), ((6, 6), "triangular"),
            ((3, 3), "honeycomb"), ((2, 3), "kagome"), ((3, 3), "kagome")]
#: (config, the JAX run's meta.json whose config the snapshot trained in)
FIXTURES = {
    "tri6x3_j1j2_jphase": "tri6x3_j1j2",
    "kagome3x3_r3_kgcnn": "kagome3x3_kgcnn",
    "kagome3x3_r3_phasenet": "kagome3x3_phasenet",
    "kagome3x3_r3_control": "kagome3x3_heis",
}


def _spins(seed, m, n):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.integers(0, 2, (m, n)) - 1.0).astype(np.float32)


def _unflatten(flat):
    out = {}
    for k, x in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = jnp.asarray(x)
    return out


def assert_log_psi_close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.re.detach().numpy(), np.asarray(want.re),
                               rtol=rtol, atol=atol)
    dphi = got.im.detach().numpy() - np.asarray(want.im)
    dphi = (dphi + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dphi, 0.0, atol=max(atol, rtol * np.abs(
        np.asarray(want.re)).max()))


def _meta_cfg(name):
    """The JAX run's own config of a snapshot, in both packages."""
    import json

    with open(os.path.join(RUNS, f"{name}.csv.meta.json")) as f:
        text = json.load(f)["config"]
    return jcfg.from_yaml(text), tcfg.from_yaml(text)


def _models(over, base="tri6x3_j1j2.yaml"):
    path = os.path.join(ROOT, "configs", base)
    jc, tc = jcfg.load(path, over), tcfg.load(path, over)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    return jb.build_model(jc, jl), tb.build_model(tc, tl), tl.n_sites


def _perturbed(jm, n, seed=2, scale=0.05):
    """JAX init plus numpy-seeded noise on every leaf (v, u and the gate
    start at zero, where a parity test would see nothing)."""
    v = jm.init(jax.random.key(0), jnp.ones((1, n), jnp.float32))
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(x) + scale * rng.normal(size=np.shape(x))).astype(
        np.float32) for k, x in jtransfer._flatten(v).items()}


@pytest.mark.parametrize("shape,geometry", LATTICES)
def test_tables_equal_jax(shape, geometry):
    from qmcnn_tpu.lattice import Lattice as JLattice

    jl, tl = JLattice(shape, geometry=geometry), Lattice(shape,
                                                         geometry=geometry)
    cm_t, n_t = tj.distance_classes(tl)
    cm_j, n_j = jj.distance_classes(jl)
    assert n_t == n_j
    np.testing.assert_array_equal(cm_t, cm_j)
    for kind in tp.KINDS:
        try:
            want = jp.phase_half_angles(kind, jl)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tp.phase_half_angles(kind, tl)
            continue
        assert tp.phase_half_angles(kind, tl) == want
    with pytest.raises(ValueError, match="unknown phase_bias"):
        tp.phase_half_angles("q0", tl)


CASES = {
    "phase_bias": ("model.channels=[3,3]",),
    "jastrow_amp_phase": ("model.channels=[3,3]", "model.jastrow=true",
                          "model.jastrow_phase=true"),
    "phase_net": ("model.channels=[3,3]", "model.phase_net_channels=[2,2,2]"),
    "all_spin_flip": ("model.channels=[3,3]", "model.jastrow=true",
                      "model.jastrow_phase=true",
                      "model.phase_net_channels=[2,2,2]",
                      "model.spin_flip_sector=-1"),
    "kagome_sqrt3_real": ("model.channels=[3,3]",
                                  "model.complex_params=false",
                                  "model.phase_bias=sublattice_sqrt3",
                                  "model.jastrow=true"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapped_model_matches_jax(name):
    """log psi of the builder's wrapped models (params perturbed so v, u
    and the gate are live) on 64 configurations, and the init's key names
    and shapes; the JAX wrapping order."""
    base = ("kagome3x3_heis.yaml" if name.startswith("kagome")
            else "tri6x3_j1j2.yaml")
    jm, tm, n = _models(CASES[name], base)
    flat = _perturbed(jm, n)
    assert {k: tuple(x.shape) for k, x in tm.init(0).items()} == {
        k: x.shape for k, x in flat.items()}
    s = _spins(3, 64, n)
    assert_log_psi_close(t_apply(tm, ttransfer.params_from_jax(flat),
                                 torch.from_numpy(s)),
                         j_apply(jm, _unflatten(flat), s))
    if name == "all_spin_flip":
        # SpinFlip(PhaseBias(Jastrow(PhaseNet(CNN)))), as in JAX
        assert isinstance(tm, SpinFlipSymmetrized)
        assert isinstance(tm.inner, tp.PhaseBias)
        assert isinstance(tm.inner.inner, tj.Jastrow)
        assert isinstance(tm.inner.inner.inner, PhaseNet)


def test_wrappers_start_equal_to_the_bare_model():
    """v = u = gate = 0 at init: the Jastrow factor and PhaseNet leave log
    psi as the bare model's."""
    _, tm, n = _models(("model.channels=[3,3]", "model.jastrow=true",
                        "model.jastrow_phase=true",
                        "model.phase_net_channels=[2,2]"))
    p = tm.init(0)
    bare = {"params/" + k[len("params/inner/inner/inner/"):]: x
            for k, x in p.items() if k.startswith("params/inner/inner/inner/")}
    s = torch.from_numpy(_spins(4, 16, n))
    got = t_apply(tm, p, s)
    want = t_apply(tm.inner.inner.inner, bare, s)
    np.testing.assert_array_equal(got.re.numpy(), want.re.numpy())
    phi = s @ tm.coeff
    np.testing.assert_allclose(got.im.numpy(), (want.im + phi).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_wrapped_covariance_gradient_matches_jax():
    """energy_and_grad of PhaseBias(Jastrow(PhaseNet(complex CNN))) on
    equal walkers: E_loc, and the gradient of every leaf (v, u, the gate
    and the trunk included) within rtol 1e-4."""
    over = ("model.channels=[3,3]", "model.jastrow=true",
            "model.jastrow_phase=true", "model.phase_net_channels=[2,2]",
            "sampler.n_walkers=32")
    jm, tm, n = _models(over)
    flat = _perturbed(jm, n)
    path = os.path.join(ROOT, "configs", "tri6x3_j1j2.yaml")
    jc, tc = jcfg.load(path, over), tcfg.load(path, over)
    j_ham = jb.build_hamiltonian(jc, jb.build_lattice(jc))
    t_ham = tb.build_hamiltonian(tc, tb.build_lattice(tc))
    s = _spins(5, 32, n)
    v = _unflatten(flat)
    lp = j_apply(jm, v, s)
    from qmcnn_tpu.sampler.metropolis import WalkerState as JW

    walkers_j = JW(s=jnp.asarray(s), log_psi=lp,
                   n_accept=jnp.zeros(32, jnp.int32),
                   n_prop=jnp.zeros(32, jnp.int32))
    _, _, g_j, eloc_j, _ = j_energy_and_grad(
        lambda p, x: j_apply(jm, p, x), j_ham, v, walkers_j)
    p = ttransfer.params_from_jax(flat)
    s_t = torch.from_numpy(s)

    def log_psi_fn(q, x):
        return t_apply(tm, q, x)

    walkers_t = WalkerState(s=s_t, log_psi=log_psi_fn(p, s_t),
                            n_accept=torch.zeros(32, dtype=torch.int32),
                            n_prop=torch.zeros(32, dtype=torch.int32))
    _, _, g_t, eloc_t, _ = t_energy_and_grad(log_psi_fn, t_ham, p, walkers_t)
    np.testing.assert_allclose(eloc_t.re.numpy(), np.asarray(eloc_j.re),
                               rtol=1e-4, atol=1e-4)
    want = {k: np.asarray(x) for k, x in jtransfer._flatten(g_j).items()}
    assert sorted(want) == sorted(g_t)
    for k, x in want.items():
        np.testing.assert_allclose(g_t[k].numpy(), x, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_matches_jax(fixture):
    """Each snapshot at full width in its run's own config: bitwise through
    params_from_jax / params_to_jax, key names and shapes equal to both
    packages' init, and log psi as JAX computes it on 64 configurations."""
    flat = ttransfer.load_checkpoint_params(
        os.path.join(RUNS, f"{fixture}.csv.params.npz"))
    p = ttransfer.params_from_jax(flat)
    back = ttransfer.params_to_jax(p)
    assert sorted(back) == sorted(flat)
    for k, x in flat.items():
        assert back[k].dtype == x.dtype
        np.testing.assert_array_equal(back[k], x)
    jc, tc = _meta_cfg(fixture)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    jm, tm = jb.build_model(jc, jl), tb.build_model(tc, tl)
    shapes = {k: x.shape for k, x in flat.items()}
    assert {k: tuple(x.shape) for k, x in tm.init(0).items()} == shapes
    j_init = jm.init(jax.random.key(0), jnp.ones((1, tl.n_sites)))
    assert {k: x.shape for k, x in jtransfer._flatten(j_init).items()} \
        == shapes
    s = _spins(9, 64, tl.n_sites)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)),
                         j_apply(jm, _unflatten(flat), s))


def test_warm_start_phase_net_from_control_matches_jax():
    """kagome3x3_phasenet warm-started from the PhaseBias-only control
    snapshot: the 'inner'-transparent retry copies the CNN under
    params/inner/inner/ and keeps the trunk and gate fresh, as JAX does."""
    source = ttransfer.load_checkpoint_params(
        os.path.join(RUNS, "kagome3x3_r3_control.csv.params.npz"))
    path = os.path.join(ROOT, "configs", "kagome3x3_phasenet.yaml")
    jc, tc = jcfg.load(path), tcfg.load(path)
    jm = jb.build_model(jc, jb.build_lattice(jc))
    fresh = jm.init(jax.random.key(0), jnp.ones((1, 27)))
    j_merged, j_n, j_f = jtransfer.transfer_params(fresh, source)
    t_fresh = ttransfer.params_from_jax(
        {k: np.asarray(x) for k, x in jtransfer._flatten(fresh).items()})
    t_merged, t_n, t_f = ttransfer.transfer_params(t_fresh, source)
    assert (t_n, t_f) == (j_n, j_f) == (8, 9)
    for k, x in jtransfer._flatten(j_merged).items():
        np.testing.assert_array_equal(t_merged[k].numpy(), np.asarray(x))
    assert sorted(t_merged) == sorted(tb.build_model(
        tc, tb.build_lattice(tc)).init(0))


CONFIGS = sorted(os.path.basename(p)[:-5]
                 for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("config", CONFIGS)
def test_every_config_builds_or_names_its_slice(config):
    """All 30 configs build on the CPU at full width, the ARNN ones with
    the direct sampler."""
    assert len(CONFIGS) == 30
    cfg = tcfg.load(os.path.join(ROOT, "configs", f"{config}.yaml"))
    vmc, params, lattice = tb.build(cfg, device="cpu")
    assert isinstance(vmc.sampler, DirectSampler) == (
        cfg.model.kind == "arnn")
    assert sum(x.numel() for x in params.values()) > 0
    assert (vmc.sr is None) == (not cfg.sr.enabled)
    if cfg.sr.enabled:
        assert vmc.sr.momentum == cfg.sr.momentum
