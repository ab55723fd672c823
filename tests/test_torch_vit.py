"""PyTorch port, slice 9: the ViT ansatz (models/vit.py) against the JAX
package on equal numpy-seeded inputs, at a 4x4 lattice with 2 blocks of
width 8: factored and dot-product attention, real and complex heads,
spin-flip sectors +1 and -1, and the point-group average; the bf16 trunk
(slice 14) at 4x4 and 8x8, factored and dot-product, real and complex.

Tolerances: log psi rtol/atol 1e-4, the phase compared modulo 2 pi; the
geometry tables exactly equal. The bf16 trunk is held to the same 1e-4
against the JAX bf16 model evaluated op by op (``jm.apply``, each
primitive rounding to bf16, as the existing cases run it): the port rounds
where that evaluation does (GELU op by op with bf16 constants, each dense
layer after its product and after its bias, layer norm once from f32
statistics), and the two agree to ~1e-5 (the f32 head's summation order).
Under ``jax.jit`` XLA on the CPU fuses the bf16 chains and rounds once per
fusion, which moves JAX's own log psi by up to ~0.3 at 4x4 and ~3.7 at
8x8 dot-product from its op-by-op value at these noisy test weights (my
CPU run): that is a rounding choice of the compiler, not of the model,
and it is not the reference here.

The trunk's spans and counter (``vit``, ``vit.attn``, ``vit.mlp``,
``vit.sequences``) are held to what one forward records, and log psi, the
surrogate gradient and the score Jacobian to bitwise equality with and
without recording."""
import dataclasses
import json
import os

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
from qmcnn_tpu_torch.sr import materialize_jacobian
from qmcnn_tpu_torch.utils import profiling
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.test_torch_priors import _spins, _unflatten
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


_VIT_KW = dict(lattice_shape=(4, 4), channels=(8, 8), patch=2, n_heads=2,
               mlp_ratio=2, factored=True, complex_params=True,
               param_scale=0.5)


def _pair(spin_flip=0, point_group=False, seed=0, **kw):
    """JAX and port ViTs (2 blocks of width 8, 2 heads, patch 2 on 4x4)
    with equal parameters: the JAX init plus numpy-seeded noise on every
    leaf (biases and layer-norm offsets start at zero)."""
    kw = dict(_VIT_KW, **kw)
    jm, tm = jv.LogPsiViT(**kw), tv.LogPsiViT(**kw)
    if point_group:
        jm = JPointGroup(inner=jm, lattice_shape=(4, 4))
        tm = PointGroupAveraged(tm, (4, 4))
    if spin_flip:
        jm = jg.SpinFlipSymmetrized(inner=jm, sector=spin_flip)
        tm = SpinFlipSymmetrized(tm, spin_flip)
    n = int(np.prod(kw["lattice_shape"]))
    v = jm.init(jax.random.key(seed), jnp.ones((1, n), jnp.float32))
    rng = np.random.default_rng(seed + 1)
    flat = {k: (np.asarray(x) + 0.2 * rng.normal(size=np.shape(x))).astype(
        np.float32) for k, x in _flatten(v).items()}
    return jm, _unflatten(flat), tm, params_from_jax(flat)


BF16_CASES = {
    f"{'x'.join(map(str, shape))}_{'factored' if fac else 'dot'}_"
    f"{'complex' if cplx else 'real'}": dict(
        lattice_shape=shape, factored=fac, complex_params=cplx,
        compute_dtype="bfloat16")
    for shape in ((4, 4), (8, 8)) for fac in (True, False)
    for cplx in (True, False)}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_log_psi_matches_jax(name):
    """The bf16 trunk against JAX's bf16 model on the same params and
    spins (TOL; see the module docstring), and further from the f32 model
    than from JAX's bf16 one (the trunk does run in bf16)."""
    kw = BF16_CASES[name]
    n = int(np.prod(kw["lattice_shape"]))
    jm, v, tm, p = _pair(**kw)
    assert tm.dtype == torch.bfloat16
    s = _spins(2, 48, n)
    got = t_apply(tm, p, torch.from_numpy(s))
    assert got.re.dtype == torch.float32
    assert_log_psi_close(got, jm.apply(v, s))
    f32 = t_apply(tv.LogPsiViT(**dict(_VIT_KW, **dict(
        kw, compute_dtype="float32"))), p, torch.from_numpy(s))
    assert float((f32.re - got.re).abs().max()) > 10 * TOL


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
    """The bf16 trunk builds (its parity is test_bf16_log_psi_matches_jax);
    a compute dtype neither package supports, and bad shapes, raise."""
    assert tv.LogPsiViT((4, 4), channels=(8, 8),
                        compute_dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        tv.LogPsiViT((4, 4), channels=(8, 8), compute_dtype="float16")
    with pytest.raises(ValueError, match="does not divide"):
        tv.LogPsiViT((5, 4), channels=(8, 8))
    with pytest.raises(ValueError, match="constant-width"):
        tv.LogPsiViT((4, 4), channels=(8, 16))
    with pytest.raises(ValueError, match="not divisible by n_heads"):
        tv.LogPsiViT((4, 4), channels=(6, 6), n_heads=4)


def _sequences() -> float:
    return profiling.counters().get("vit.sequences", 0.0)


@pytest.mark.parametrize("batch", [1, 5])
def test_forward_records_its_spans_and_counter(batch):
    """One forward inside a recording window: one ``vit`` span holding
    n_blocks ``vit.attn`` and ``vit.mlp`` spans in block order, and
    ``vit.sequences`` up by the 4 rolled copies of each configuration."""
    _, _, tm, p = _pair()
    s = torch.from_numpy(_spins(4, batch, 16))
    before = _sequences()
    with profiling.recording() as window:
        t_apply(tm, p, s)
    assert _sequences() - before == 4 * batch
    names = [sp.name for sp in window.spans]
    assert names == ["vit"] + ["vit.attn", "vit.mlp"] * tm.n_blocks
    top = window.spans[0]
    assert all(sp.parent is top for sp in window.spans[1:])
    assert all(sp.end_ns is not None and sp.end_ns >= sp.start_ns
               for sp in window.spans)


def test_nothing_recorded_outside_a_window_and_the_counter_counts_vmap():
    """Outside a window no span is kept; the counter is always on, and the
    score Jacobian (one vmap over the walkers a part) counts every walker's
    copies: 4 M for each of its two parts."""
    _, _, tm, p = _pair()
    s = torch.from_numpy(_spins(5, 6, 16))
    held = len(profiling.spans())
    before = _sequences()
    t_apply(tm, p, s)
    assert len(profiling.spans()) == held
    assert _sequences() - before == 4 * 6
    before = _sequences()
    materialize_jacobian(lambda q, x: t_apply(tm, q, x), p, s)
    assert _sequences() - before == 2 * 4 * 6
    assert len(profiling.spans()) == held


def test_recording_leaves_log_psi_gradient_and_jacobian_bitwise():
    """log psi, the surrogate loss's gradient and the score Jacobian read
    the same bits with the spans recording and without."""
    _, _, tm, p = _pair(factored=False)
    s = torch.from_numpy(_spins(6, 8, 16))
    weights = torch.linspace(-1, 1, 8)

    def fn(q, x):
        return t_apply(tm, q, x)

    def results():
        lp = fn(p, s)
        grads = torch.func.grad(
            lambda q: (fn(q, s).re * weights).mean()
            + fn(q, s).im.mean())(p)
        j_re, j_im, _ = materialize_jacobian(fn, p, s)
        return [lp.re, lp.im, j_re, j_im] + [grads[k] for k in sorted(grads)]

    off = results()
    with profiling.recording() as window:
        on = results()
    assert len([sp for sp in window.spans if sp.name == "vit"]) == 5
    for a, b in zip(off, on):
        assert torch.equal(a, b)


#: an H100 80GB's ``total_memory``
H100_BYTES = 85_017_493_504


@pytest.mark.parametrize("mem, chunk", [(H100_BYTES, None),
                                        (H100_BYTES // 2, 128)])
def test_deep_vit_cell_chunks_as_jax(mem, chunk):
    """The benchmark's 10x10 Deep ViT configuration (d 72, 12 heads, 8
    blocks, 256 walkers, 400 connected rows each): its footprint and auto
    E_loc and Jacobian chunks equal the JAX builder's, and on one H100 the
    E_loc batch of 102,400 configurations runs unchunked (the estimate's
    transient 256 x 401 x 230,400 bytes = 23.65 GB fits the 45% budget;
    an H100 80GB HBM3 read a 35.67 GB peak in the cell); on half of it,
    128 walkers a chunk."""
    from qmcnn_tpu import builder as jb
    from qmcnn_tpu import configs as jcfg
    from qmcnn_tpu.utils import memory as jmem
    from qmcnn_tpu_torch import builder as tb
    from qmcnn_tpu_torch import configs as tcfg
    from qmcnn_tpu_torch.utils import memory as tmem

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "j1j2_10x10_vit.json")) as f:
        cfg = json.load(f)["config"]
    # one device: the JAX builder divides the walkers by its device count
    cfg["run"]["n_devices"] = 1
    text = json.dumps(cfg)
    jc, tc = jcfg.from_yaml(text), tcfg.from_yaml(text)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    jh, th = jb.build_hamiltonian(jc, jl), tb.build_hamiltonian(tc, tl)
    fp = tmem.model_footprint(tc, tl.n_sites)
    assert dataclasses.asdict(fp) == dataclasses.asdict(
        jmem.model_footprint(jc, jl.n_sites))
    assert fp.fwd_bytes() == 230_400
    n_params = 267_432
    got = tmem.auto_chunk_size(tc, tl, th, n_params, mem_bytes=mem)
    assert got == chunk == jmem.auto_chunk_size(jc, jl, jh, n_params,
                                                hbm_bytes=mem)
    assert tmem.auto_jacobian_chunk(tc, tl, th, n_params,
                                    mem_bytes=mem) is None
    est = tmem.peak_estimate(tc, tl, th, n_params, mem_bytes=mem,
                             chunk_size=got)
    assert est["transient_bytes"] == (chunk or 256) * 401 * 230_400
