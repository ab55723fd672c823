"""PyTorch port, slice 5: the bfloat16 compute dtype end to end.

The same numpy-seeded parameters and spins go through the JAX models at
``compute_dtype='bfloat16'`` and the port's, and through the TPU kernel's
bf16 route (``gcnn_pallas``, interpreted on the CPU, as
tests/test_gcnn_pallas.py runs it) and the port's plain bf16 version of K2.

Tolerances. Both packages round at the same points (bf16 operands and
activations, f32 sums, f32 activation math rounded once, the bf16 residual
skip), so what is left is the order of the f32 sums, which now and then
flips one bf16 rounding. Each tolerance is sized from the JAX side itself:
  * the GCNN and K2: the JAX package's own bf16 kernel-vs-model gap on the
    same inputs (the kernel adds the f32 bias on its f32 sums and takes the
    direct 4-product complex form; the model adds a bf16 bias and takes
    Karatsuba), measured in the test;
  * the CNN (no JAX bf16 kernel): a hundredth of the JAX model's own
    bf16-vs-f32 gap, so the port reproduces the bf16 rounding itself and
    not just its size.
"""
import functools
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.kernels import gcnn_pallas as jk
from qmcnn_tpu.models import cnn as jc
from qmcnn_tpu.models import gcnn as jg
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.models import cnn as tc
from qmcnn_tpu_torch.models import gcnn as tg
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.utils.transfer import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R2 = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn_r2.yaml")
HEIS = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")


def _spins(seed, m, n):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.integers(0, 2, (m, n)) - 1.0).astype(np.float32)


def _perturb_biases(v):
    """Nonzero biases (zero ones make the lncosh stack even in s)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jax.random.normal(
            jax.random.key(zlib.crc32(str(path).encode())), x.shape)
        if "bias" in str(path) else x, v)


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# -- the CNN ----------------------------------------------------------------

CNN_CASES = {
    "real_lncosh": dict(lattice_shape=(4, 4), channels=(4, 4),
                        param_scale=0.3),
    "real_selu_residual": dict(lattice_shape=(4, 4), channels=(4, 4, 4, 4),
                               activation="selu", residual=True,
                               init_mode="fan_in", param_scale=1.0),
    "complex_lncosh": dict(lattice_shape=(4, 4), channels=(4, 4),
                           complex_params=True, param_scale=0.3),
    "complex_chain_k5": dict(lattice_shape=(12,), channels=(12, 12),
                             kernel_size=5, complex_params=True,
                             param_scale=0.3),
    "complex_selu_residual": dict(lattice_shape=(4, 4),
                                  channels=(4, 4, 4, 4), complex_params=True,
                                  activation="selu", residual=True,
                                  init_mode="fan_in", param_scale=1.0),
}


@functools.lru_cache(maxsize=None)
def _cnn(name):
    """(JAX f32, JAX bf16, port f32, port bf16) log psi as numpy (re, im)
    pairs on one set of params and spins."""
    kw = CNN_CASES[name]
    n = int(np.prod(kw["lattice_shape"]))
    v = _perturb_biases(jc.LogPsiCNN(**kw).init(jax.random.key(0),
                                                jnp.ones((1, n))))
    p = params_from_jax({k: np.asarray(x) for k, x in _flatten(v).items()})
    s = _spins(1, 48, n)
    out = []
    for pkg in ("jax", "port"):
        for dt in ("float32", "bfloat16"):
            if pkg == "jax":
                lp = j_apply(jc.LogPsiCNN(compute_dtype=dt, **kw), v, s)
            else:
                lp = t_apply(tc.LogPsiCNN(compute_dtype=dt, **kw), p,
                             torch.from_numpy(s))
            out.append((np.asarray(lp.re), np.asarray(lp.im)))
    return out


@pytest.mark.parametrize("name", sorted(CNN_CASES))
def test_cnn_bf16_matches_jax(name):
    j32, j16, _, t16 = _cnn(name)
    gap = max(_max_abs(j16[0], j32[0]), _max_abs(j16[1], j32[1]))
    assert gap > 0
    tol = 1e-2 * gap
    assert _max_abs(t16[0], j16[0]) <= tol
    assert _max_abs(t16[1], j16[1]) <= tol
    assert t16[0].dtype == np.float32
    if not CNN_CASES[name].get("complex_params"):
        assert not t16[1].any()


def test_cnn_params_map_complex_conv_keys():
    """params_from_jax maps ComplexConv_i/kernel_re|kernel_im|bias_re|
    bias_im onto the port's modules, and the port's init draws the same
    keys and shapes as the JAX init."""
    kw = CNN_CASES["complex_selu_residual"]
    v = jc.LogPsiCNN(**kw).init(jax.random.key(0), jnp.ones((1, 16)))
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    assert sorted(flat) == sorted(
        f"params/ComplexConv_{i}/{n}" for i in range(4)
        for n in ("bias_im", "bias_re", "kernel_im", "kernel_re"))
    fresh = tc.LogPsiCNN(**kw).init(0)
    assert {k: tuple(t.shape) for k, t in fresh.items()} == {
        k: a.shape for k, a in flat.items()}
    model = tc.LogPsiCNN(**kw)
    model.load_state_dict(tc.module_names(params_from_jax(flat)))
    np.testing.assert_array_equal(
        model.ComplexConv_2.kernel_im.detach().numpy(),
        flat["params/ComplexConv_2/kernel_im"])


# -- the GCNN and K2 ----------------------------------------------------------

GCNN_CASES = {
    "selu_residual_complex": dict(channels=(4, 4, 4), complex_params=True,
                                  activation="selu", residual=True,
                                  init_mode="fan_in", param_scale=1.0),
    "selu_residual_spin_flip": dict(channels=(4, 4, 4), complex_params=True,
                                    activation="selu", residual=True,
                                    init_mode="fan_in", param_scale=1.0,
                                    spin_flip=1),
    "lncosh_complex": dict(channels=(3, 3), complex_params=True,
                           param_scale=0.3),
    "selu_real": dict(channels=(3, 3), complex_params=False,
                      activation="selu", param_scale=0.3),
}


@functools.lru_cache(maxsize=None)
def _gcnn(name):
    """Everything one GCNN case compares, on one set of params and spins
    (4x4): the JAX bf16 model and fused kernel (interpreted) log psi, the
    JAX bf16 readout sums S_g, the port's bf16 model, FusedLogPsi (CPU:
    the plain version) and plain S_g, and the port's f32 model."""
    kw = dict(GCNN_CASES[name])
    sf = kw.pop("spin_flip", 0)
    kw.update(lattice_shape=(4, 4), kernel_size=3)
    fused_kw = dict(lattice_shape=(4, 4), channels=kw["channels"],
                    kernel_size=3, complex_params=kw["complex_params"],
                    activation=kw.get("activation", "lncosh"),
                    residual=kw.get("residual", False), spin_flip_sector=sf)
    s = _spins(2, 40, 16)
    out = {}
    for dt in ("float32", "bfloat16"):
        inner = jg.LogPsiGCNN(compute_dtype=dt, **kw)
        jm = jg.SpinFlipSymmetrized(inner=inner, sector=sf) if sf else inner
        v = _perturb_biases(jm.init(jax.random.key(0), jnp.ones((1, 16))))
        p = params_from_jax({k: np.asarray(x)
                             for k, x in _flatten(v).items()})
        ti = tg.LogPsiGCNN(compute_dtype=dt, **kw)
        tm = tg.SpinFlipSymmetrized(ti, sf) if sf else ti
        out[f"jax_model_{dt}"] = j_apply(jm, v, s)
        out[f"port_model_{dt}"] = t_apply(tm, p, torch.from_numpy(s))
    fast = jk.make_fused_log_psi(compute_dtype="bfloat16", block=8,
                                 interpret=True, **fused_kw)
    out["jax_kernel"] = fast(v, s)
    before = (k2.gcnn_group_sums.launches, k2.gcnn_group_sums.launches_bf16)
    out["port_fused"] = k2.FusedLogPsi(compute_dtype="bfloat16",
                                       **fused_kw)(p, torch.from_numpy(s))
    assert (k2.gcnn_group_sums.launches,
            k2.gcnn_group_sums.launches_bf16) == before  # CPU: plain version
    # the readout sums of the bare stack
    cp = kw["complex_params"]
    inner_v = {"params": v["params"]["inner"]} if sf else v
    lift, layers, biases = jk.expand_gcnn_params(inner_v, 3, cp)
    w_re = jnp.stack([a for a, _ in layers])
    zeros = jnp.zeros_like
    sg = jk._group_sums(
        s, lift[0], lift[1] if cp else zeros(lift[0]), w_re,
        jnp.stack([b for _, b in layers]) if cp else zeros(w_re),
        jnp.stack([a for a, _ in biases]),
        jnp.stack([b for _, b in biases]) if cp
        else jnp.zeros((len(biases), lift[0].shape[-1])),
        lattice_shape=(4, 4), channels=kw["channels"], kernel_size=3,
        complex_params=cp, activation=fused_kw["activation"],
        residual=fused_kw["residual"], block=8, interpret=True,
        dtype_name="bfloat16")
    out["jax_sg"] = sg
    ws = k2.expand_gcnn_params(p, 3, cp, "params/inner/" if sf else "params/")
    args = {k: fused_kw[k] for k in ("lattice_shape", "channels",
                                     "kernel_size", "activation",
                                     "residual")}
    out["port_sg"] = k2.gcnn_group_sums(torch.from_numpy(s), ws,
                                        compute_dtype="bfloat16", **args)
    out["port_sg_f32"] = k2.gcnn_group_sums(torch.from_numpy(s), ws, **args)
    return out


def _jax_gap(o):
    """The JAX package's own bf16 kernel-vs-model gap in Re log psi."""
    gap = _max_abs(o["jax_kernel"].re, o["jax_model_bfloat16"].re)
    assert gap > 0
    return gap


def _phase_err(a, b):
    d = np.asarray(a) - np.asarray(b)
    return float(np.max(np.abs((d + np.pi) % (2 * np.pi) - np.pi)))


@pytest.mark.parametrize("name", sorted(GCNN_CASES))
def test_gcnn_bf16_model_matches_jax(name):
    o = _gcnn(name)
    tol = _jax_gap(o)
    got, want = o["port_model_bfloat16"], o["jax_model_bfloat16"]
    assert _max_abs(got.re, want.re) <= tol
    assert _phase_err(got.im, want.im) <= tol


@pytest.mark.parametrize("name", sorted(GCNN_CASES))
def test_plain_bf16_k2_matches_jax_kernel(name):
    """The plain bf16 version of K2 against the TPU kernel's bf16 route:
    FusedLogPsi against make_fused_log_psi, and the readout sums S_g
    against _group_sums, within the JAX kernel-vs-model gap; and the bf16
    route differs from the f32 route (it really rounds)."""
    o = _gcnn(name)
    tol = _jax_gap(o)
    assert _max_abs(o["port_fused"].re, o["jax_kernel"].re) <= tol
    assert _phase_err(o["port_fused"].im, o["jax_kernel"].im) <= tol
    for part in ("re", "im"):
        assert _max_abs(getattr(o["port_sg"], part),
                        getattr(o["jax_sg"], part)) <= tol
    assert _max_abs(o["port_sg"].re, o["port_sg_f32"].re) > 0


@pytest.mark.parametrize("name", ["selu_residual_complex",
                                  "selu_residual_spin_flip"])
def test_gcnn_bf16_close_to_f32_in_both_packages(name):
    """The bf16-vs-f32 gap of each package, with the JAX package's own bf16
    tolerances (tests/test_ansatz.py: rtol 2e-2, atol 5e-2), and the two
    gaps equal within the JAX kernel-vs-model gap."""
    o = _gcnn(name)
    for pkg in ("jax", "port"):
        a, b = o[f"{pkg}_model_float32"], o[f"{pkg}_model_bfloat16"]
        np.testing.assert_allclose(np.asarray(b.re), np.asarray(a.re),
                                   rtol=2e-2, atol=5e-2)
    gap_j = np.asarray(o["jax_model_bfloat16"].re) - np.asarray(
        o["jax_model_float32"].re)
    gap_t = np.asarray(o["port_model_bfloat16"].re) - np.asarray(
        o["port_model_float32"].re)
    assert float(np.max(np.abs(gap_t - gap_j))) <= _jax_gap(o)


@pytest.mark.parametrize("name", ["real_selu_residual",
                                  "complex_selu_residual"])
def test_cnn_bf16_close_to_f32_in_both_packages(name):
    j32, j16, t32, t16 = _cnn(name)
    for (a, b) in ((j32, j16), (t32, t16)):
        np.testing.assert_allclose(b[0], a[0], rtol=2e-2, atol=5e-2)
        np.testing.assert_allclose(b[1], a[1], rtol=2e-2, atol=7e-2)
    gap = max(_max_abs(j16[0], j32[0]), _max_abs(j16[1], j32[1]))
    assert _max_abs(t16[0] - t32[0], j16[0] - j32[0]) <= 1e-2 * gap


def test_bf16_residual_rounds_as_xla():
    """XLA rounds a bf16 (z + z_in) * 0.7071067811865476 twice: after the
    add and after the multiply, by the constant rounded to bf16
    (0.70703125). The port's skip_scale and the plain K2's rounding give
    the same bits on 100,000 pairs."""
    rng = np.random.default_rng(0)
    a, b = (jnp.asarray(rng.normal(size=100_000).astype(np.float32)
                        ).astype(jnp.bfloat16) for _ in range(2))
    want = np.asarray(jax.jit(lambda x, y: (x + y) * 0.7071067811865476)(
        a, b).astype(jnp.float32))
    ta, tb_ = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (a, b))
    scale = tc.skip_scale(torch.bfloat16)
    assert scale == 0.70703125 and tc.skip_scale(torch.float32) == \
        0.7071067811865476
    got = ((ta + tb_) * scale).float().numpy()
    np.testing.assert_array_equal(got, want)
    unscaled = ((ta + tb_) * 0.7071067811865476).float().numpy()
    assert (unscaled != want).any()  # the f32 constant would differ


# -- the kernel's bf16 layout ------------------------------------------------

def _unpack_stages(packed, kk, kdim, ncols):
    """The inverse of the documented stage layout: [L-1, cb, step, ng, h,
    r, e] -> the GEMM matrix [L-1, kk, K, N] (k -> channel through
    K_PERM), in float32."""
    n, n_cb, steps_pad, ntb = packed.shape[:4]
    b = packed.float().permute(0, 2, 4, 6, 1, 3, 5).reshape(
        n, steps_pad, 16, n_cb * ntb * 8)
    inv = [k2.K_PERM.index(c) for c in range(16)]
    b = b[:, :kk * kdim // 16][:, :, inv, :ncols]
    return b.reshape(n, kk, kdim, ncols)


@pytest.mark.parametrize("width,cplx", [(24, True), (80, True), (40, False)])
def test_pack_group_weights_bf16_layout(width, cplx):
    """The bf16 route's ring stages: at sampled (layer, column block, step,
    column group ng, k half h, column r, k e) the stage holds the bf16
    entry of [[wr, wi], [-wi, wr]] (complex; columns interleaved in 8s,
    re then im of 8 output channels) or of w (real) at input channel
    16 kc + K_PERM[8 h + e] of tap step // (K / 16), part kc // (Kp / 16);
    input channels past W, columns past N and the padded steps are zero."""
    rng = np.random.default_rng(10)
    wr = torch.from_numpy(rng.normal(size=(2, 9, width, width)).astype(
        np.float32))
    wi = torch.from_numpy(rng.normal(size=(2, 9, width, width)).astype(
        np.float32)) if cplx else None
    stg = k2.pack_group_weights_bf16(wr, wi)
    kp, parts = k2.k_padded(width), 2 if cplx else 1
    kdim, ncols = parts * kp, parts * width
    ntb = k2.tile_cols(ncols // 8)
    steps = 9 * kdim // 16
    steps_pad = -(-steps // k2.BF16_STAGE_STEPS) * k2.BF16_STAGE_STEPS
    assert stg.dtype == torch.bfloat16 and tuple(stg.shape) == (
        2, -(-ncols // (8 * ntb)), steps_pad, ntb, 2, 8, 8)
    r16, i16 = wr.to(torch.bfloat16), None if wi is None else wi.to(
        torch.bfloat16)

    def want(l, step, k, col):
        tap, kc = divmod(step, kdim // 16)
        part, kc = divmod(kc, kp // 16)
        ci = 16 * kc + k2.K_PERM[k]
        if cplx:
            pair, within = divmod(col, 16)
            out_im, co = divmod(within, 8)
            co += 8 * pair
        else:
            out_im, co = 0, col
        if ci >= width or co >= width or col >= ncols:
            return 0.0
        if not cplx:
            return float(r16[l, tap, ci, co])
        w = [[r16, i16], [-i16, r16]][part][out_im]
        return float(w[l, tap, ci, co])

    rng = np.random.default_rng(11)
    for _ in range(400):
        l, cb = int(rng.integers(2)), int(rng.integers(stg.shape[1]))
        step, ng = int(rng.integers(steps)), int(rng.integers(ntb))
        h, r, e = (int(v) for v in rng.integers(0, (2, 8, 8)))
        col = (cb * ntb + ng) * 8 + r
        assert float(stg[l, cb, step, ng, h, r, e]) == want(l, step,
                                                              8 * h + e, col)
    assert not stg[:, :, steps:].float().any()  # the padded steps
    # the GEMM matrix unpacked from the stages is gemm_weights_bf16's
    full = _unpack_stages(stg, 9, kdim, ncols)
    np.testing.assert_array_equal(
        full.numpy(), k2.gemm_weights_bf16(wr, wi).to(torch.bfloat16).float()
        .numpy())
    assert k2.k_padded(24) == 32 and k2.k_padded(80) == 80


@pytest.mark.parametrize("cplx", [True, False])
def test_bf16_gemm_stages_compute_one_layer(cplx):
    """[xr | xi] gathered by tap times the GEMM matrix unpacked from the
    stages equals one layer of gcnn_group_sums_reference's direct form
    (the circular convolution before bias and activation), in float64 from
    bf16 values."""
    from qmcnn_tpu_torch.models.gcnn import conv_expanded

    rng = np.random.default_rng(12)
    width, shape, batch = 24, (4, 4), 3
    hw = shape[0] * shape[1]

    def bf(*size):
        return torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(
            torch.bfloat16).double()

    wr, wi = bf(1, 9, width, width), bf(1, 9, width, width) if cplx else None
    xr, xi = bf(batch, width, *shape), bf(batch, width, *shape)
    stg = k2.pack_group_weights_bf16(wr.float(), None if wi is None
                                     else wi.float())
    kp, parts = k2.k_padded(width), 2 if cplx else 1
    b = _unpack_stages(stg, 9, parts * kp, parts * width)[0].double()

    def flax(w):
        return w[0].reshape(3, 3, width, width)

    with torch.no_grad():
        if cplx:
            yr = conv_expanded(xr, flax(wr)) - conv_expanded(xi, flax(wi))
            yi = conv_expanded(xr, flax(wi)) + conv_expanded(xi, flax(wr))
        else:
            yr = conv_expanded(xr, flax(wr))
    # the GEMM: row (configuration, site) of tap t reads site
    # ((i + a - 1) mod H, (j + b - 1) mod W), channels padded to Kp
    pad = torch.zeros(batch, kp - width, *shape, dtype=torch.float64)
    xs = [torch.cat([xr, pad], 1)] + ([torch.cat([xi, pad], 1)] if cplx
                                      else [])
    y = torch.zeros(batch * hw, parts * width, dtype=torch.float64)
    for t in range(9):
        a, c = divmod(t, 3)
        rows = torch.cat([torch.roll(x, (1 - a, 1 - c), (2, 3)).permute(
            0, 2, 3, 1).reshape(batch * hw, kp) for x in xs], 1)
        y += rows @ b[t]
    y = y.reshape(batch, *shape, -1)
    if cplx:  # columns interleaved in 8s: re, im of 8 channels
        y = y.reshape(batch, *shape, width // 8, 2, 8)
        got_r, got_i = (y[..., j, :].reshape(batch, *shape, width)
                        for j in (0, 1))
        np.testing.assert_allclose(got_i.permute(0, 3, 1, 2).numpy(),
                                   yi.numpy(), rtol=1e-12, atol=1e-12)
    else:
        got_r = y
    np.testing.assert_allclose(got_r.permute(0, 3, 1, 2).numpy(),
                               yr.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,channels,n_cfg", [
    ((8, 8), 10, 2), ((8, 8), 8, 2), ((10, 10), 10, 2), ((12, 12), 10, 2),
    ((16, 16), 10, 1), ((4, 4), 3, 8)])
def test_bf16_configs_per_block(shape, channels, n_cfg):
    """A bf16 block holds up to BF16_MAX_GROUPS consumer warpgroups of whole
    configurations (as many as one 64-row M tile holds: 1 at 8x8 and above,
    4 at 4x4) beside a ring of at least two weight stages: 2 at 8x8, W = 80
    (the f32 route takes 2), and 16x16 at W = 80 fits one warpgroup."""
    hw, width = shape[0] * shape[1], 8 * channels
    c_wg = k2.bf16_group_configs(hw)
    assert k2.configs_per_block(hw, width, 9, True, "bfloat16") == n_cfg
    assert k2.smem_bytes(hw, width, 9, True, n_cfg,
                         "bfloat16") <= k2.MAX_SMEM_BYTES
    assert n_cfg == k2.BF16_MAX_GROUPS * c_wg or k2.smem_bytes(
        hw, width, 9, True, n_cfg + c_wg, "bfloat16") > k2.MAX_SMEM_BYTES
    assert k2.smem_bytes(64, 80, 9, True, 2, "bfloat16") == 68384
    plan = k2.bf16_plan(64, 80, 9, True, 2)
    assert (plan.ntb, plan.c_wg, plan.n_buf, plan.stages, plan.threads,
            plan.smem_bytes) == (20, 1, 1, 16, 384, 211968)
    assert k2.configs_per_block(64, 80, 9, True) == 2


def test_every_gcnn_config_keeps_its_bf16_eligibility():
    """Every committed square GCNN config, in bfloat16, takes K2's bf16
    route with a ring of at least two stages, as it did before the ring
    (all of them, 16x16 at W = 80 included)."""
    import glob

    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))):
        cfg = tcfg.load(path, ("model.compute_dtype=bfloat16",))
        m, lat = cfg.model, cfg.lattice
        if m.kind != "gcnn" or lat.geometry != "hypercubic":
            continue
        assert tb.gcnn_kernel_eligible(cfg), path
        hw, width = int(np.prod(lat.shape)), 8 * m.channels[0]
        n_cfg = k2.configs_per_block(hw, width, 9, m.complex_params,
                                     "bfloat16")
        plan = k2.bf16_plan(hw, width, 9, m.complex_params,
                            n_cfg // k2.bf16_group_configs(hw))
        assert plan.stages >= k2.BF16_MIN_STAGES, path
        assert plan.smem_bytes <= k2.MAX_SMEM_BYTES, path


def test_packed_weights_are_kept_per_route():
    ws = k2.expand_gcnn_params(
        tg.LogPsiGCNN((4, 4), channels=(2, 2), complex_params=True).init(0),
        3, True)
    f32 = k2.packed_weights(ws)
    bf = k2.packed_weights(ws, "bfloat16")
    assert bf.frag_re.dtype == torch.bfloat16 and f32.frag_re.dtype != \
        torch.bfloat16
    assert k2.packed_weights(ws, "bfloat16") is bf
    assert k2.packed_weights(ws) is f32


# -- eligibility --------------------------------------------------------------

def test_bf16_eligibility():
    """A bf16 GCNN takes K2's bf16 route on CUDA; a bf16 or complex CNN
    never takes K1 (it samples with the torch sweep and evaluates with the
    model), as in JAX."""
    r2 = tcfg.load(R2)
    assert tb.gcnn_kernel_eligible(r2)
    assert tb.uses_fused_gcnn_forward(r2, "cuda")
    assert not tb.uses_fused_gcnn_forward(r2, "cpu")
    assert tb.resolve_sampler_backend(r2, "cuda") == "torch"
    fused = tb.fused_gcnn_log_psi(r2, tb.build_lattice(r2))
    assert fused.compute_dtype == "bfloat16"
    for over in (("model.compute_dtype=bfloat16",),
                 ("model.complex_params=true",),
                 ("model.compute_dtype=bfloat16",
                  "model.complex_params=true")):
        cfg = tcfg.load(HEIS, over)
        assert not tb.cnn_forward_eligible(cfg), over
        assert not tb.kernel_eligible(cfg), over
        assert not tb.uses_fused_cnn_forward(cfg, "cuda"), over
        assert tb.resolve_sampler_backend(cfg, "cuda") == "torch"
        tb.build_model(cfg, tb.build_lattice(cfg))  # builds, no raise
    with pytest.raises(ValueError, match="compute_dtype"):
        tb.build_model(tcfg.load(HEIS, ("model.compute_dtype=float16",)),
                       tb.build_lattice(tcfg.load(HEIS)))
