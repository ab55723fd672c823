"""PyTorch port, slice 8: the D6 GCNNs of the triangular and kagome lattices
(models/tgcnn.py, models/kgcnn.py) against the JAX package on equal
numpy-seeded inputs, and the memory footprint the auto chunk sizes read.

Tolerances: log psi rtol 1e-4 / atol 1e-5 with the phase wrapped to
(-pi, pi] (two f32 implementations may round a phase to another branch of
2 pi k); the bf16 stack within a twentieth of the JAX model's own
bf16-vs-f32 gap. The sign characters (A2/B1/B2) have exact nodes, where
psi = 0 and log psi is the rounding residue of a cancelling character sum
(the JAX model's docstring): there the per-element sums S_g (no
cancellation) are held to the f32 tolerance, the nodes must coincide, log
psi is compared where the character sum keeps more than 1e-2 of its terms,
and the normalized amplitudes everywhere (atol 1e-3, as the square GCNN's
tests compare them)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu import builder as jb
from qmcnn_tpu import configs as jcfg
from qmcnn_tpu.models import kgcnn as jk
from qmcnn_tpu.models import tgcnn as jt
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.models import kgcnn as tk
from qmcnn_tpu_torch.models import tgcnn as tt
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.cnn import module_names
from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                            params_from_jax, params_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KGCNN_FIXTURE = os.path.join(ROOT, "runs",
                             "kagome3x3_r3_kgcnn.csv.params.npz")


def _spins(seed, m, n):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.integers(0, 2, (m, n)) - 1.0).astype(np.float32)


def _wrap(x):
    return (np.asarray(x) + np.pi) % (2 * np.pi) - np.pi


def assert_log_psi_close(got, want, rtol=1e-4, atol=1e-5, mask=None):
    g_re, w_re = got.re.detach().numpy(), np.asarray(want.re)
    dphi = _wrap(got.im.detach().numpy() - np.asarray(want.im))
    if mask is not None:
        g_re, w_re, dphi = g_re[mask], w_re[mask], dphi[mask]
    np.testing.assert_allclose(g_re, w_re, rtol=rtol, atol=atol)
    np.testing.assert_allclose(dphi, 0.0, atol=max(atol, rtol * np.abs(
        w_re).max()))


def _pair(jm, tm, n, perturb=None):
    """JAX init of ``jm``, the same params in the port (optionally
    ``perturb``-ed in numpy, then shared), and their init key shapes."""
    v = jm.init(jax.random.key(0), jnp.ones((1, n), jnp.float32))
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    fresh = {k: tuple(x.shape) for k, x in tm.init(0).items()}
    assert fresh == {k: x.shape for k, x in flat.items()}
    if perturb is not None:
        flat = perturb(flat)
    return flat, params_from_jax(flat)


def _unflatten(flat):
    out = {}
    for k, x in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = jnp.asarray(x)
    return out


def _widen_last_layer(n_layers, scale=0.15, seed=1):
    """Replace the last layer's kernels (fan_in shrinks them 0.1/sqrt(N G C)
    at init) by normal(scale) draws, so the S_g have O(1) spread."""
    def perturb(flat):
        rng = np.random.default_rng(seed)
        out = dict(flat)
        for k in sorted(out):
            if f"TriGroupConv_{n_layers - 1}/kernel" in k:
                out[k] = (rng.normal(size=out[k].shape) * scale).astype(
                    np.float32)
        return out
    return perturb


@pytest.mark.parametrize("radius", [1, 2])
def test_d6_tables_and_star_grid_equal_jax(radius):
    for a, b in zip(tt.d6_tables(radius), jt.d6_tables(radius)):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tt.d6_site_perms((6, 6)),
                                  jt.d6_site_perms((6, 6)))
    # the dense expanded kernels are JAX's star gather + scatter
    G, offsets, _, elem_idx, tap_perm, _, _ = jt.d6_tables(radius)
    T = len(offsets)
    rng = np.random.default_rng(radius)
    lift = rng.normal(size=(T, 1, 3)).astype(np.float32)
    group = rng.normal(size=(G, T, 3, 2)).astype(np.float32)
    k = 2 * radius + 1
    layer = tt.TriGroupConv(1, 3, k, lift=True)
    np.testing.assert_array_equal(
        layer.expand(torch.from_numpy(lift)).numpy(),
        np.asarray(jt._star_lift_kernel(jnp.asarray(lift), tap_perm,
                                        offsets)))
    layer = tt.TriGroupConv(3, 2, k)
    np.testing.assert_array_equal(
        layer.expand(torch.from_numpy(group)).numpy(),
        np.asarray(jt._star_group_kernel(jnp.asarray(group), elem_idx,
                                         tap_perm, offsets)))


@pytest.mark.parametrize("shape", [(3, 3), (4, 4)])
@pytest.mark.parametrize("character", ["A1", "A2", "B1", "B2"])
def test_tri_gcnn_matches_jax(shape, character):
    """The fan_in/selu deep recipe (3 layers, complex, residual) with the
    last layer widened: S_g, log psi (away from the nodes of a sign
    character) and the normalized amplitudes."""
    kw = dict(lattice_shape=shape, channels=(3, 3, 3), radius=1,
              complex_params=True, param_scale=1.0, init_mode="fan_in",
              activation="selu", residual=True, character=character)
    jm, tm = jt.LogPsiTriGCNN(**kw), tt.LogPsiTriGCNN(**kw)
    n = shape[0] * shape[1]
    flat, p = _pair(jm, tm, n, _widen_last_layer(3))
    s = _spins(int(shape[0]) * 10 + len(character), 64, n)
    v = _unflatten(flat)
    want_g = jm.apply(v, s, method=jm.elements)
    with torch.no_grad():
        for name, x in module_names(p).items():
            tm.get_parameter(name).copy_(x)
        got_g = tm.group_sums(torch.from_numpy(s))
    np.testing.assert_allclose(got_g.re.numpy(), np.asarray(want_g.re),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g.im.numpy(), np.asarray(want_g.im),
                               rtol=1e-4, atol=1e-5)
    want = j_apply(jm, v, s)
    got = t_apply(tm, p, torch.from_numpy(s))
    # |psi| against the sum of |e^{S_g}|: how much of the character sum
    # survives its cancellation, per configuration, in each package
    chi = jt.d6_tables(1)[5][character]

    def kept(re, im):
        z = np.exp(np.asarray(re, np.float64) + 1j * np.asarray(im,
                                                                np.float64))
        return np.abs((z * chi).sum(1)) / np.abs(z).sum(1)

    k_j = kept(want_g.re, want_g.im)
    k_t = kept(got_g.re.numpy(), got_g.im.numpy())
    # the nodes (configurations that a chi = -1 element maps onto
    # themselves up to a translation: psi = 0 exactly) are the same
    nodes = k_j < 1e-4
    np.testing.assert_array_equal(k_t < 1e-4, nodes)
    if nodes.all():  # on the 3x3 torus A2 is a null state in both
        return
    # elsewhere log psi, where it is bounded (a cancellation to 1e-2 costs
    # two digits of the f32 sums)
    far = k_j > 1e-2
    assert far.sum() >= 8
    assert_log_psi_close(got, want, mask=far)

    def amp(re, im):  # normalized amplitudes, nodes included
        re, im = np.asarray(re, np.float64), np.asarray(im, np.float64)
        return np.exp(re - np.asarray(want.re).max()) * np.exp(1j * im)

    np.testing.assert_allclose(amp(got.re.numpy(), got.im.numpy()),
                               amp(want.re, want.im), atol=1e-3)


def test_tri_gcnn_radius2_matches_jax():
    """The radius-2 star (19 taps in a 5x5 grid) on the 5x5 torus."""
    kw = dict(lattice_shape=(5, 5), channels=(2, 2), radius=2,
              complex_params=True, param_scale=0.2)
    jm, tm = jt.LogPsiTriGCNN(**kw), tt.LogPsiTriGCNN(**kw)
    flat, p = _pair(jm, tm, 25)
    s = _spins(5, 64, 25)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)),
                         j_apply(jm, _unflatten(flat), s))


@pytest.mark.parametrize("complex_params", [False, True])
def test_tri_gcnn_bf16_matches_jax(complex_params):
    """The bf16 stack rounds where the JAX triangular model rounds (its
    activations op by op in bf16, with bf16 constants): the port's bf16
    log psi sits within a twentieth of the JAX model's own bf16-vs-f32 gap
    (what is left is the f32 summation order flipping a bf16 rounding now
    and then)."""
    kw = dict(lattice_shape=(4, 4), channels=(4, 4, 4), radius=1,
              complex_params=complex_params, param_scale=1.0,
              init_mode="fan_in", activation="selu", residual=True)
    s = _spins(6, 64, 16)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = jt.LogPsiTriGCNN(compute_dtype=dtype, **kw)
        tm = tt.LogPsiTriGCNN(compute_dtype=dtype, **kw)
        flat, p = _pair(jm, tm, 16, _widen_last_layer(3, 0.05))
        out[dtype] = (j_apply(jm, _unflatten(flat), s),
                      t_apply(tm, p, torch.from_numpy(s)))
    (j32, _), (j16, t16) = out["float32"], out["bfloat16"]
    gap = np.abs(np.asarray(j16.re) - np.asarray(j32.re)).max()
    assert gap > 0
    assert np.abs(t16.re.numpy() - np.asarray(j16.re)).max() <= gap / 20
    assert np.abs(_wrap(t16.im.numpy() - np.asarray(j16.im))).max() \
        <= gap / 20
    # the activation itself is JAX's to the bit
    x = np.linspace(-3, 3, 4001)
    want = np.asarray(jax.nn.selu(jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    _, act = tt.activations_in_dtype("selu", torch.bfloat16)
    got = act(torch.tensor(x, dtype=torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_tri_gcnn_guards_match_jax():
    for kw, msg in ((dict(lattice_shape=(4, 3)), "square"),
                    (dict(lattice_shape=(4, 4), character="E1"),
                     "character"),
                    (dict(lattice_shape=(4, 4), radius=3), "radius"),
                    (dict(lattice_shape=(4, 4), radius=2), "exceeds")):
        with pytest.raises(ValueError, match=msg):
            tt.LogPsiTriGCNN(**kw)
    with pytest.raises(ValueError, match="square cell torus"):
        tk.LogPsiKagomeGCNN(cell_shape=(2, 3))
    for geometry, shape in (("triangular", "[6,3]"), ("kagome", "[2,3]")):
        cfg = tcfg.load(os.path.join(ROOT, "configs", "tri6x6_tgcnn.yaml"),
                        (f"lattice.geometry={geometry}",
                         f"lattice.shape={shape}", "model.kernel_size=3"))
        with pytest.raises(ValueError):
            tb.build_model(cfg, tb.build_lattice(cfg))


def test_fine_embedding_and_kagome_gcnn_match_jax():
    for shape in ((2, 2), (3, 3)):
        for a, b in zip(tk.fine_embedding(shape), jk.fine_embedding(shape)):
            np.testing.assert_array_equal(a, b)
    kw = dict(cell_shape=(2, 2), channels=(3, 3, 3), radius=1,
              complex_params=True, param_scale=1.0, init_mode="fan_in",
              activation="selu", residual=True)
    jm, tm = jk.LogPsiKagomeGCNN(**kw), tk.LogPsiKagomeGCNN(**kw)
    flat, p = _pair(jm, tm, 12, _widen_last_layer(3))
    s = _spins(7, 64, 12)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)),
                         j_apply(jm, _unflatten(flat), s))


def test_kagome_gcnn_fixture_matches_jax():
    """The trained kagome GCNN snapshot (PhaseBias on the kagome GCNN, W =
    120, 4 layers, 50,620 params) at full width on 64 configurations:
    bitwise transfer both ways and log psi as JAX computes it."""
    from qmcnn_tpu.models.phase import PhaseBias as JPB
    from qmcnn_tpu.models.phase import phase_half_angles as j_half

    flat = load_checkpoint_params(KGCNN_FIXTURE)
    p = params_from_jax(flat)
    back = params_to_jax(p)
    assert sorted(back) == sorted(flat)
    for k, x in flat.items():
        np.testing.assert_array_equal(back[k], x)
    cfg = tcfg.load(os.path.join(ROOT, "configs", "kagome3x3_kgcnn.yaml"))
    lat = tb.build_lattice(cfg)
    tm = tb.build_model(cfg, lat)
    assert sum(x.numel() for x in p.values()) == 50620
    assert {k: tuple(x.shape) for k, x in tm.init(0).items()} == {
        k: x.shape for k, x in flat.items()}
    jcfg_ = jcfg.load(os.path.join(ROOT, "configs", "kagome3x3_kgcnn.yaml"))
    jl = jb.build_lattice(jcfg_)
    jm = jb.build_model(jcfg_, jl)
    assert isinstance(jm, JPB)
    assert jm.half_angles == j_half("sublattice_120", jl)
    s = _spins(8, 64, lat.n_sites)
    assert_log_psi_close(t_apply(tm, p, torch.from_numpy(s)),
                         j_apply(jm, _unflatten(flat), s))


@pytest.mark.parametrize("config", ["tri6x6_tgcnn", "kagome3x3_kgcnn",
                                    "j1j2_8x8_gcnn", "kagome3x3_phasenet",
                                    "j1j2_4x4_vit", "j1j2_8x8_vit",
                                    "tfim16_arnn", "j1j2_4x4_arnn",
                                    "heis40_arnn"])
@pytest.mark.parametrize("mem_gib", [2, 80])
def test_footprint_and_auto_chunks_match_jax(config, mem_gib):
    """model_footprint (G = 12 on the D6 lattices, kagome's 4/3 fine-torus
    width, hexagonal-star taps, the PhaseNet trunk's layers; the ViT's MLP
    width and the ARNN's dense heads) and both auto chunk sizes equal
    JAX's."""
    from qmcnn_tpu.utils import memory as jmem
    from qmcnn_tpu_torch.utils import memory as tmem

    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    over = ("run.n_devices=1",)
    jc, tc = jcfg.load(path, over), tcfg.load(path, over)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    jh, th = jb.build_hamiltonian(jc, jl), tb.build_hamiltonian(tc, tl)
    n_params = sum(x.numel() for x in tb.build_model(tc, tl).init(0)
                   .values())
    mem = int(mem_gib * 2**30)
    assert dataclasses.asdict(tmem.model_footprint(tc, tl.n_sites)) == \
        dataclasses.asdict(jmem.model_footprint(jc, jl.n_sites))
    assert tmem.auto_chunk_size(tc, tl, th, n_params, mem_bytes=mem) \
        == jmem.auto_chunk_size(jc, jl, jh, n_params, hbm_bytes=mem)
    assert tmem.auto_jacobian_chunk(tc, tl, th, n_params, mem_bytes=mem) \
        == jmem.auto_jacobian_chunk(jc, jl, jh, n_params, hbm_bytes=mem)


@pytest.mark.parametrize("config", ["tri6x6_tgcnn", "kagome3x3_kgcnn"])
def test_d6_gcnns_take_no_kernel(config):
    """K2 computes the C4v square GCNN only: the D6 GCNNs keep the plain
    model on CUDA, and K1 never serves them."""
    cfg = tcfg.load(os.path.join(ROOT, "configs", f"{config}.yaml"))
    assert not tb.gcnn_kernel_eligible(cfg)
    assert not tb.uses_fused_gcnn_forward(cfg, "cuda")
    assert not tb.uses_fused_cnn_forward(cfg, "cuda")
    assert tb.resolve_sampler_backend(cfg, "cuda") == "torch"
