"""PyTorch port, slice 2: the square-lattice GCNN (models/gcnn.py) and the
fused GCNN forward's plain version (kernels/gcnn_forward.py), each against
the JAX package on equal inputs; and the kernel's 3xTF32 product scheme
(its TF32 hi/lo split and fragment weight layout) emulated on the CPU.

The JAX Pallas kernel runs as tests/test_gcnn_pallas.py runs it
(``interpret=True``), on the same 4x4 cases and with its tolerances:
1e-4 (float32; the fused forward takes the direct 4-product complex form
where the model takes Karatsuba), 1e-3 on the deep residual stack (rounding
compounds with depth), and sign-changing characters compared in normalized
amplitudes (exact nodes make log psi unbounded there)."""
import dataclasses
import functools
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmcnn_tpu.kernels import gcnn_pallas as jk
from qmcnn_tpu.models import gcnn as jg
from qmcnn_tpu.models.cnn import log_psi_apply as j_apply
from qmcnn_tpu.utils.transfer import _flatten
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.models import gcnn as tg
from qmcnn_tpu_torch.models.cnn import _SKIP_SCALE, true_f32
from qmcnn_tpu_torch.models.cnn import log_psi_apply as t_apply
from qmcnn_tpu_torch.models.cnn import module_names
from qmcnn_tpu_torch.ops import cplx
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                            params_from_jax, transfer_params)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCNN_CFG = os.path.join(ROOT, "configs", "j1j2_8x8_gcnn.yaml")
FIXTURE = os.path.join(ROOT, "runs", "j1j2_8x8_d12_fix.csv.params.npz")
H = W = 4
N = H * W
M = 24


def _spins(seed, m=M, n=N):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.integers(0, 2, (m, n)) - 1.0).astype(np.float32)


def _build(channels=(3, 3), complex_params=True, activation="lncosh",
           residual=False, character="A1", spin_flip=0, param_scale=0.3):
    """JAX and port models with equal (bias-perturbed) parameters."""
    kw = dict(lattice_shape=(H, W), channels=channels, kernel_size=3,
              complex_params=complex_params, param_scale=param_scale,
              character=character, activation=activation, residual=residual)
    j_inner = jg.LogPsiGCNN(**kw)
    jm = (jg.SpinFlipSymmetrized(inner=j_inner, sector=spin_flip)
          if spin_flip else j_inner)
    v = jm.init(jax.random.key(0), jnp.ones((1, N), jnp.float32))
    # zero biases and an even lncosh make the inner net even under s -> -s
    # (the sector -1 projection would vanish): perturb the biases
    v = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jax.random.normal(
            jax.random.key(zlib.crc32(str(path).encode())), x.shape)
        if "bias" in str(path) else x, v)
    t_inner = tg.LogPsiGCNN(**kw)
    tm = tg.SpinFlipSymmetrized(t_inner, spin_flip) if spin_flip else t_inner
    flat = {k: np.asarray(x) for k, x in _flatten(v).items()}
    return dict(jm=jm, v=v, tm=tm, p=params_from_jax(flat), kw=kw,
                spin_flip=spin_flip)


CASES = [
    dict(),
    dict(activation="selu"),
    dict(complex_params=False),
    dict(complex_params=False, activation="selu"),
    dict(channels=(2, 2, 2, 2), activation="selu", residual=True, tol=1e-3),
    dict(character="B1", param_scale=0.1, amp=True),
    dict(activation="selu", spin_flip=1, tol=5e-4),
    dict(character="B2", spin_flip=-1, param_scale=0.1, amp=True),
]
IDS = ["-".join(f"{k}={v}" for k, v in kw.items()) or "default"
       for kw in CASES]


def _norm_amp(re, im):
    re, im = np.asarray(re), np.asarray(im)
    mag = np.exp(re - np.max(re[np.isfinite(re)]))
    return (np.where(mag > 0, mag * np.cos(im), 0.0),
            np.where(mag > 0, mag * np.sin(im), 0.0))


def _pre_wrap_phase(c, s):
    """Per configuration, max_g |Im S_g| over the group-element readout
    sums (of s and of -s under a spin-flip projection): the size of the
    phase before the projection's logmeanexp wraps it into (-pi, pi]."""
    spin = c["spin_flip"]
    inner = c["tm"].inner if spin else c["tm"]
    prefix = "params/inner/" if spin else "params/"
    inner.load_state_dict(module_names(
        {"params/" + k[len(prefix):]: v for k, v in c["p"].items()
         if k.startswith(prefix)}), strict=True)
    x = torch.from_numpy(s)
    with torch.no_grad():
        sizes = [inner.group_sums(y).im.abs().amax(1)
                 for y in ((x, -x) if spin else (x,))]
    return torch.stack(sizes).amax(0).numpy()


def _assert_log_psi_close(got, want, tol, amp, pre_wrap):
    """Re within rtol/atol ``tol``. The phase modulo 2 pi within
    tol * (1 + the size of the phase before wrapping, ``pre_wrap``): the
    phase is the wrapped sum of per-site terms that add up to tens or
    hundreds of radians, each sum carrying f32 rounding of that size (as
    rtol scales the real part with its size). An absolute 1e-4 alone held
    the default case to 5.98e-5 against pre-wrap phases of 25-93, which a
    different CPU or thread layout can push past the bound."""
    if amp:
        for g, w in zip(_norm_amp(got.re, got.im),
                        _norm_amp(want.re, want.im)):
            np.testing.assert_allclose(g, w, atol=1e-3)
        return
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=tol, atol=tol)
    dphi = np.asarray(got.im) - np.asarray(want.im)
    dphi = (dphi + np.pi) % (2 * np.pi) - np.pi
    bound = tol * (1.0 + pre_wrap)
    d_re = np.abs(np.asarray(got.re) - np.asarray(want.re)).max()
    print(f"margins: max |d Re| {d_re:.3e}, "
          f"max |d phase| {np.abs(dphi).max():.3e} = "
          f"{np.abs(dphi).max() / tol:.3f} of {tol:g}, "
          f"{np.max(np.abs(dphi) / bound):.4f} of the bound (pre-wrap "
          f"phase {pre_wrap.min():.1f}-{pre_wrap.max():.1f})")
    np.testing.assert_array_less(np.abs(dphi), bound)


@pytest.mark.parametrize("k", [3, 5])
def test_c4v_tables_equal_jax(k):
    for a, b in zip(tg.c4v_tables(k), jg.c4v_tables(k)):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("k", [3, 5])
def test_kernel_expansions_equal_jax(k):
    _, _, elem_idx, tap_perm, _, _ = tg.c4v_tables(k)
    rng = np.random.default_rng(k)
    lift = rng.normal(size=(k, k, 1, 3)).astype(np.float32)
    group = rng.normal(size=(8, k, k, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tg._lift_kernel(torch.from_numpy(lift), tap_perm, k).numpy(),
        np.asarray(jg._lift_kernel(jnp.asarray(lift), tap_perm, k)))
    np.testing.assert_array_equal(
        tg._group_kernel(torch.from_numpy(group), elem_idx, tap_perm,
                         k).numpy(),
        np.asarray(jg._group_kernel(jnp.asarray(group), elem_idx, tap_perm,
                                    k)))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_model_matches_jax(kw):
    kw = dict(kw)
    tol, amp = kw.pop("tol", 1e-4), kw.pop("amp", False)
    c = _build(**kw)
    s = _spins(1)
    want = j_apply(c["jm"], c["v"], s)
    got = t_apply(c["tm"], c["p"], torch.from_numpy(s))
    _assert_log_psi_close(got, want, tol, amp, _pre_wrap_phase(c, s))
    assert sorted(c["p"]) == sorted(c["tm"].init(0))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_fused_plain_version_matches_jax_pallas(kw):
    """gcnn_group_sums (CPU: its plain version) against JAX _group_sums,
    and FusedLogPsi against make_fused_log_psi, both interpreted."""
    kw_in, kw = kw, dict(kw)
    tol, amp = kw.pop("tol", 1e-4), kw.pop("amp", False)
    c = _build(**kw)
    m = c["kw"]
    s = _spins(2)
    fast = jk.make_fused_log_psi(
        lattice_shape=(H, W), channels=m["channels"], kernel_size=3,
        complex_params=m["complex_params"], character=m["character"],
        activation=m["activation"], residual=m["residual"],
        spin_flip_sector=c["spin_flip"], block=8, interpret=True)
    args = dict(lattice_shape=(H, W), channels=m["channels"], kernel_size=3,
                complex_params=m["complex_params"], character=m["character"],
                activation=m["activation"], residual=m["residual"],
                spin_flip_sector=c["spin_flip"])
    before = k2.gcnn_group_sums.launches
    got = k2.FusedLogPsi(**args)(c["p"], torch.from_numpy(s))
    assert k2.gcnn_group_sums.launches == before  # CPU: the plain version
    _assert_log_psi_close(got, fast(c["v"], s), tol, amp,
                          _pre_wrap_phase(c, s))
    # the readout sums themselves
    ws, sg_j, sums_kw = _jax_group_sums(CASES.index(kw_in))
    sg_t = k2.gcnn_group_sums(torch.from_numpy(s), ws, **sums_kw)
    for a, b in ((sg_t.re, sg_j[0]), (sg_t.im, sg_j[1])):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol * 10)


@functools.lru_cache(maxsize=None)
def _jax_group_sums(i):
    """Case i of CASES: the port's expanded weights, checked element by
    element against JAX ``expand_gcnn_params``, and JAX ``_group_sums``
    (interpreted, float32) on ``_spins(2)`` as a numpy (re, im) pair, and
    the keywords of ``gcnn_group_sums``."""
    kw = {k: v for k, v in CASES[i].items() if k not in ("tol", "amp")}
    c = _build(**kw)
    m = c["kw"]
    s = _spins(2)
    inner_v = c["v"]["params"]["inner"] if c["spin_flip"] else c["v"][
        "params"]
    lift, layers, biases = jk.expand_gcnn_params(
        {"params": inner_v}, 3, m["complex_params"])
    prefix = "params/inner/" if c["spin_flip"] else "params/"
    ws = k2.expand_gcnn_params(c["p"], 3, m["complex_params"], prefix)
    np.testing.assert_array_equal(ws.lift_re.numpy(), np.asarray(lift[0]))
    for i, (w_re, w_im) in enumerate(layers):
        np.testing.assert_array_equal(ws.w_re[i].numpy(), np.asarray(w_re))
        if m["complex_params"]:
            np.testing.assert_array_equal(ws.w_im[i].numpy(),
                                          np.asarray(w_im))
    np.testing.assert_array_equal(ws.b_re.numpy(),
                                  np.stack([np.asarray(b) for b, _ in biases]))
    zeros = lambda a: jnp.zeros_like(a)  # noqa: E731
    w_stack = jnp.stack([a for a, _ in layers])
    sg_j = jk._group_sums(
        s, lift[0], lift[1] if m["complex_params"] else zeros(lift[0]),
        w_stack, jnp.stack([b for _, b in layers]) if m["complex_params"]
        else zeros(w_stack), jnp.stack([a for a, _ in biases]),
        jnp.stack([b for _, b in biases]) if m["complex_params"]
        else jnp.zeros((len(biases), lift[0].shape[-1])),
        lattice_shape=(H, W), channels=m["channels"], kernel_size=3,
        complex_params=m["complex_params"], activation=m["activation"],
        residual=m["residual"], block=8, interpret=True,
        dtype_name="float32")
    sums_kw = dict(lattice_shape=(H, W), channels=m["channels"],
                   kernel_size=3, activation=m["activation"],
                   residual=m["residual"])
    return ws, (np.asarray(sg_j.re), np.asarray(sg_j.im)), sums_kw


def _bits(t):
    return t.contiguous().view(torch.int32).numpy()


def test_tf32_split():
    """hi and lo carry TF32 values (the low 13 mantissa bits zero), hi is
    round-to-nearest, ties away from zero, at 11 significant bits (an
    independent frexp formula), and hi + lo is x within 2^-22 relative."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(
        np.float32)
    ties = np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(1, 8, 2)
    x = np.concatenate([x, ties, -ties, [0.0, 1.0, -3.5]]).astype(np.float32)
    hi, lo = k2.tf32_split(torch.from_numpy(x))
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    m, e = np.frexp(x.astype(np.float64))
    want = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want)
    total = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert (np.abs(total - x) <= 2.0 ** -22 * np.abs(x)).all()


def test_pack_group_weights_layout():
    """The kernel's B fragments: word (hi b0, hi b1, lo b0, lo b1) of lane
    4 g + t at (layer, tap, k step ks, column tile nt) holds the TF32 parts
    of w[8 ks + 2 t, 8 nt + g] and w[8 ks + 2 t + 1, 8 nt + g]."""
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.normal(size=(2, 9, 24, 24)).astype(np.float32))
    frag = k2.pack_group_weights(w).numpy()
    assert frag.shape == (2, 9, 3, 3, 8, 4, 4)
    hi, lo = (v.numpy() for v in k2.tf32_split(w))
    for l, t, ks, nt, g, tg_ in ((0, 0, 0, 0, 0, 0), (1, 8, 2, 1, 7, 3),
                                 (1, 4, 1, 2, 3, 2), (0, 5, 2, 0, 5, 1)):
        ci, co = 8 * ks + 2 * tg_, 8 * nt + g
        np.testing.assert_array_equal(
            frag[l, t, ks, nt, g, tg_],
            [hi[l, t, ci, co], hi[l, t, ci + 1, co], lo[l, t, ci, co],
             lo[l, t, ci + 1, co]])
    # every weight appears once in each part
    np.testing.assert_array_equal(np.sort(frag[..., :2].ravel()),
                                  np.sort(hi.ravel()))
    np.testing.assert_array_equal(np.sort(frag[..., 2:].ravel()),
                                  np.sort(lo.ravel()))


def test_packed_weights_follow_parameter_updates():
    """The kernel's packed weights are split once per weight state: reused
    for the same unchanged tensors, packed again after an in-place change
    or for new tensors."""
    c = _build()
    ws = k2.expand_gcnn_params(c["p"], 3, True)
    first = k2.packed_weights(ws)
    assert k2.packed_weights(ws) is first
    assert k2.packed_weights(k2.GCNNWeights(*ws)) is first  # same tensors
    np.testing.assert_array_equal(first.frag_re.numpy(),
                                  k2.pack_group_weights(ws.w_re).numpy())
    ws.w_im.mul_(0.5)  # in place: the version counter moves
    moved = k2.packed_weights(ws)
    assert moved is not first
    np.testing.assert_array_equal(moved.frag_im.numpy(),
                                  k2.pack_group_weights(ws.w_im).numpy())
    real = k2.expand_gcnn_params(_build(complex_params=False)["p"], 3, False)
    assert k2.packed_weights(real).frag_im is None


def _conv_3xtf32(a, w):
    """conv(a_lo, w_hi) + conv(a_hi, w_lo) + conv(a_hi, w_hi): the
    kernel's three TF32 passes (each product exact in f32). The weights
    are split by ``tf32_split``; an activation's hi is its TF32 rounding
    and its lo the remainder as the tensor cores read it, truncated to
    TF32."""
    a_hi = k2.tf32_split(a)[0]
    bits = (a - a_hi).contiguous().view(torch.int32)
    a_lo = (bits & -0x2000).view(torch.float32)
    w_hi, w_lo = k2.tf32_split(w)
    return (tg.conv_expanded(a_lo, w_hi) + tg.conv_expanded(a_hi, w_lo)
            + tg.conv_expanded(a_hi, w_hi))


def _group_sums_3xtf32(x, weights, *, lattice_shape, channels, kernel_size,
                       activation, residual):
    """``gcnn_group_sums_reference`` with every group layer's convolution
    taken in the kernel's 3xTF32 scheme (the lift stays f32)."""
    complex_params = weights.lift_im is not None
    k, width, n_layers = kernel_size, k2.G * channels[0], len(channels)
    act = cplx.ACTIVATIONS[activation][0 if complex_params else 1]
    batch = x.shape[0]

    def flax(w, cin):
        return w.reshape(k, k, cin, width)

    with true_f32():
        z = x.reshape(batch, 1, *lattice_shape)
        lift = [tg.conv_expanded(z, flax(weights.lift_re, 1))]
        if complex_params:
            lift.append(tg.conv_expanded(z, flax(weights.lift_im, 1)))
        z = C(*lift) if complex_params else lift[0]
        for i in range(n_layers):
            z_in = z
            if i > 0:
                wr = flax(weights.w_re[i - 1], width)
                if complex_params:
                    wi = flax(weights.w_im[i - 1], width)
                    z = C(_conv_3xtf32(z.re, wr) - _conv_3xtf32(z.im, wi),
                          _conv_3xtf32(z.re, wi) + _conv_3xtf32(z.im, wr))
                else:
                    z = _conv_3xtf32(z, wr)
            br = weights.b_re[i].reshape(-1, 1, 1)
            if complex_params:
                z = act(C(z.re + br, z.im + weights.b_im[i].reshape(-1, 1, 1)))
            else:
                z = act(z + br)
            if residual and 0 < i < n_layers - 1:
                z = (z + z_in) * _SKIP_SCALE
    z = cplx.as_c(z)
    c = channels[-1]
    return C(z.re.reshape(batch, k2.G, c, -1).sum((2, 3)),
             z.im.reshape(batch, k2.G, c, -1).sum((2, 3)))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_3xtf32_group_sums_keep_f32(kw):
    """The kernel's product scheme, emulated, against the f32 plain version
    and JAX ``_group_sums`` (interpreted, float32), with the stated
    tolerances of the parity test above: the split keeps the f32
    contract."""
    tol = kw.get("tol", 1e-4)
    ws, sg_j, args = _jax_group_sums(CASES.index(kw))
    s = torch.from_numpy(_spins(2))
    got = _group_sums_3xtf32(s, ws, **args)
    plain = k2.gcnn_group_sums_reference(s, ws, **args)
    for a, b, j in ((got.re, plain.re, sg_j[0]), (got.im, plain.im, sg_j[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(a.numpy(), j, rtol=tol, atol=tol * 10)


def test_fixture_matches_jax():
    """The committed depth-12 snapshot (C = 10 x 12, selu, residual, A1,
    spin-flip +1) in float32: 8 configurations within rtol 1e-4 (float32,
    another summation order over a 12-layer stack)."""
    flat = load_checkpoint_params(FIXTURE)
    kw = dict(lattice_shape=(8, 8), channels=(10,) * 12, kernel_size=3,
              complex_params=True, param_scale=1.0, init_mode="fan_in",
              activation="selu", residual=True, character="A1")
    jm = jg.SpinFlipSymmetrized(inner=jg.LogPsiGCNN(**kw), sector=1)
    tm = tg.SpinFlipSymmetrized(tg.LogPsiGCNN(**kw), 1)
    nested = {}
    for key, val in flat.items():
        d = nested
        *head, last = key.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = jnp.asarray(val)
    s = _spins(3, m=8, n=64)
    s[:, :32] = np.abs(s[:, :32])
    s[:, 32:] = -np.abs(s[:, 32:])  # the S^z = 0 sector
    rng = np.random.default_rng(4)
    s = np.stack([rng.permutation(row) for row in s])
    want = j_apply(jm, nested, s)
    got = t_apply(tm, params_from_jax(flat), torch.from_numpy(s))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               rtol=1e-4)
    fused = k2.FusedLogPsi(spin_flip_sector=1, **{
        k: v for k, v in kw.items()
        if k not in ("param_scale", "init_mode")})(params_from_jax(flat),
                                                   torch.from_numpy(s))
    np.testing.assert_allclose(fused.re.numpy(), np.asarray(want.re),
                               rtol=1e-4)


@pytest.mark.parametrize("character", ["A1", "A2", "B1", "B2"])
def test_space_group_characters(character):
    """psi(g.s) = chi(g) psi(s) for every C4v element, and translation
    invariance, in amplitudes normalized to the batch (sign-changing
    characters have exact nodes where log psi is unbounded). atol 1e-4:
    float32 rounding of the eight exp(S_g) terms that cancel near a node."""
    c = _build(character=character, param_scale=0.1)
    chars = tg.c4v_tables(3)[4][character]
    s = torch.from_numpy(_spins(5, m=6))
    base = t_apply(c["tm"], c["p"], s)
    scale = float(base.re.max())

    def amp(lp):
        mag = np.exp(lp.re.numpy() - scale)
        return mag * np.exp(1j * lp.im.numpy())

    grid = s.reshape(-1, H, W)
    for g, (r, m) in enumerate(tg.c4v_tables(3)[5]):
        moved = t_apply(c["tm"], c["p"],
                        tg.grid_transform(grid, int(r), int(m)).reshape(-1, N))
        np.testing.assert_allclose(amp(moved), chars[g] * amp(base),
                                   atol=1e-4)
    shifted = t_apply(c["tm"], c["p"],
                      torch.roll(grid, (1, 2), (1, 2)).reshape(-1, N))
    np.testing.assert_allclose(amp(shifted), amp(base), atol=1e-4)


def test_fused_forward_rejects():
    c = _build()
    args = dict(lattice_shape=(H, W), channels=(3, 3), kernel_size=3,
                complex_params=True)
    s = torch.from_numpy(_spins(6, m=4))
    with pytest.raises(ValueError, match="equal channel"):
        k2.FusedLogPsi(**{**args, "channels": (2, 4)})(c["p"], s)
    with pytest.raises(ValueError, match="spin-flip sector"):
        k2.FusedLogPsi(**args, spin_flip_sector=2)
    with pytest.raises(ValueError, match="bare GCNN"):  # a prior's leaf
        k2.FusedLogPsi(**args)({**c["p"], "params/PhaseBias_0/theta": s[0]},
                                s)
    ws = k2.expand_gcnn_params(c["p"], 3, True)
    with pytest.raises(ValueError, match="2D lattice"):
        k2.gcnn_group_sums(s, ws, lattice_shape=(2, 2, 4), channels=(3, 3),
                           kernel_size=3)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        k2.gcnn_group_sums(s.to("meta"), ws, lattice_shape=(H, W),
                           channels=(3, 3), kernel_size=3)


def test_fused_forward_reuses_expanded_weights():
    """The expanded weights are gathered once per parameter state: reused
    for the same tensors (in any dict), gathered again after an in-place
    change or for new tensors, and the result stays the model's."""
    c = _build()
    f = k2.FusedLogPsi(lattice_shape=(H, W), channels=(3, 3), kernel_size=3,
                       complex_params=True)
    s = torch.from_numpy(_spins(7, m=6))
    p = {k: v.clone() for k, v in c["p"].items()}
    first = f.weights(p)
    assert f.weights(p) is first and f.weights(dict(p)) is first
    key = "params/GroupConv_1/kernel_im"
    p[key].add_(0.05)  # in place: the version counter moves
    moved = f.weights(p)
    assert moved is not first
    np.testing.assert_array_equal(
        moved.w_im.numpy(), k2.expand_gcnn_params(p, 3, True).w_im.numpy())
    fresh = {**p, key: p[key] * 2.0}  # a new tensor under the same key
    assert f.weights(fresh) is not moved
    for params in (p, fresh):
        got, want = f(params, s), t_apply(c["tm"], params, s)
        np.testing.assert_allclose(got.re.numpy(), want.re.numpy(),
                                   rtol=1e-4, atol=1e-5)


def _gcnn_cfg(*over):
    return tcfg.load(GCNN_CFG, over)


def test_gcnn_eligibility():
    cfg = _gcnn_cfg()
    assert tb.gcnn_kernel_eligible(cfg) and not tb.kernel_eligible(cfg)
    assert tb.uses_fused_gcnn_forward(cfg, "cuda")
    assert not tb.uses_fused_gcnn_forward(cfg, "cpu")
    # the sweep engine is the plain proposal loop either way
    assert tb.resolve_sampler_backend(cfg, "cuda") == "torch"
    assert tb.resolve_sampler_backend(cfg, "cpu") == "torch"
    xla = _gcnn_cfg("sampler.backend=xla")
    assert tb.resolve_sampler_backend(xla, "cuda") == "torch"
    assert not tb.uses_fused_gcnn_forward(xla, "cuda")
    with pytest.raises(ValueError):
        tb.resolve_sampler_backend(_gcnn_cfg("sampler.backend=pallas"),
                                   "cuda")
    for over in (("model.channels=[8,4]",), ("model.jastrow=true",),
                 ("model.phase_bias=marshall",),
                 ("lattice.geometry=triangular",)):
        cfg = _gcnn_cfg(*over)
        assert not tb.gcnn_kernel_eligible(cfg), over
        assert not tb.uses_fused_gcnn_forward(cfg, "cuda"), over
        assert tb.resolve_sampler_backend(cfg, "cuda") == "torch"
    # bf16 takes the kernel's bf16 route (slice 5)
    bf16 = _gcnn_cfg("model.compute_dtype=bfloat16")
    assert tb.gcnn_kernel_eligible(bf16)
    assert tb.uses_fused_gcnn_forward(bf16, "cuda")
    assert tb.fused_gcnn_log_psi(bf16, tb.build_lattice(bf16)
                                 ).compute_dtype == "bfloat16"
    tb.build_model(bf16, tb.build_lattice(bf16))
    # the Jastrow factor and the triangular GCNN build since slice 8 (on
    # the plain model, as checked above); the Lanczos-dressed ansatz builds
    # since slice 10 (build() wraps the composed model) and takes no kernel:
    # neither computes (1 + alpha H) psi
    from qmcnn_tpu_torch.models.jastrow import Jastrow
    from qmcnn_tpu_torch.models.tgcnn import LogPsiTriGCNN

    for over, kind in ((("model.jastrow=true",), Jastrow),
                       (("lattice.geometry=triangular",), LogPsiTriGCNN)):
        cfg = _gcnn_cfg(*over)
        model = tb.build_model(cfg, tb.build_lattice(cfg))
        assert isinstance(model, tg.SpinFlipSymmetrized)
        assert isinstance(model.inner, kind), over
    cfg = _gcnn_cfg("model.lanczos_alpha=0.1")
    assert isinstance(tb.build_model(cfg, tb.build_lattice(cfg)),
                      tg.SpinFlipSymmetrized)
    assert not tb.gcnn_kernel_eligible(cfg)
    assert not tb.uses_fused_gcnn_forward(cfg, "cuda")
    deep = tcfg.load(os.path.join(ROOT, "configs", "j1j2_8x8_gcnn_deep.yaml"))
    assert tb.gcnn_kernel_eligible(deep)


@pytest.mark.parametrize("name,fits", [
    ("j1j2_8x8_gcnn", True), ("j1j2_8x8_gcnn_deep", True),
    ("j1j2_8x8_gcnn_res8", True), ("j1j2_10x10_gcnn", True),
    ("j1j2_10x10_gcnn_deep", True), ("j1j2_12x12_gcnn_deep", True),
    ("j1j2_16x16_gcnn_deep", False), ("j1j2_8x8_gcnn_r2", True),
    ("j1j2_16x16_gcnn_deep+bfloat16", True)])
def test_gcnn_eligibility_needs_shared_memory(name, fits):
    """A config whose block of activations exceeds Hopper's shared memory
    (16x16 at W = 80 in float32: 337,920 bytes) is not eligible, so 'auto'
    keeps the plain model on CUDA instead of sending it to a kernel that
    raises. The bf16 route reckons at 2 bytes per value: the bf16 hero
    config fits, and so would 16x16 at W = 80 (190,464 bytes)."""
    name, _, dtype = name.partition("+")
    cfg = tcfg.load(os.path.join(ROOT, "configs", f"{name}.yaml"),
                    (f"model.compute_dtype={dtype}",) if dtype else ())
    m = cfg.model
    smem = k2.smem_bytes(int(np.prod(cfg.lattice.shape)), 8 * m.channels[0],
                         9, m.complex_params, 1, m.compute_dtype)
    assert (smem <= k2.MAX_SMEM_BYTES) == fits
    assert tb.gcnn_kernel_eligible(cfg) == fits
    assert tb.uses_fused_gcnn_forward(cfg, "cuda") == fits
    assert tb.resolve_sampler_backend(cfg, "cuda") == "torch"


@pytest.mark.parametrize("shape,channels,n_cfg", [
    ((8, 8), 8, 3), ((8, 8), 10, 2), ((10, 10), 8, 2), ((12, 12), 10, 1),
    ((4, 4), 3, 16)])
def test_gcnn_configs_per_block(shape, channels, n_cfg):
    """A block takes as many configurations as shared memory holds (up to
    MAX_ROWS rows), in whole warps of at most MAX_THREADS threads."""
    hw, width = shape[0] * shape[1], 8 * channels
    assert k2.configs_per_block(hw, width, 9, True) == n_cfg
    assert k2.smem_bytes(hw, width, 9, True, n_cfg) <= k2.MAX_SMEM_BYTES
    assert (n_cfg + 1) * hw > k2.MAX_ROWS or k2.smem_bytes(
        hw, width, 9, True, n_cfg + 1) > k2.MAX_SMEM_BYTES
    threads = k2.launch_threads(hw, width, n_cfg)
    assert threads % 32 == 0 and 32 <= threads <= k2.MAX_THREADS


def test_warm_start_from_fixture_is_bit_exact():
    over = ("model.channels=[10,10,10,10,10,10,10,10,10,10,10,10]",
            "model.activation=selu", "model.init_mode=fan_in",
            "model.param_scale=1.0", "model.residual=true")
    cfg = _gcnn_cfg(*over)
    model = tb.build_model(cfg, tb.build_lattice(cfg))
    fresh = model.init(0)
    source = load_checkpoint_params(FIXTURE)
    merged, n_copied, n_fresh = transfer_params(fresh, source)
    assert (n_copied, n_fresh) == (48, 0)
    for k, v in source.items():
        np.testing.assert_array_equal(merged[k].numpy(), v)
    # fresh init draws the same shapes as the snapshot
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in source.items()}


@pytest.mark.parametrize("config", ["j1j2_8x8_gcnn", "j1j2_8x8_gcnn_deep"])
@pytest.mark.parametrize("mem_gib", [0.5, 8, 80])
def test_gcnn_auto_chunking_matches_jax(config, mem_gib):
    from qmcnn_tpu import builder as jb
    from qmcnn_tpu import configs as jcfg
    from qmcnn_tpu.utils import memory as jmem
    from qmcnn_tpu_torch.utils import memory as tmem

    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    over = ("run.n_devices=1",)
    jc, tc = jcfg.load(path, over), tcfg.load(path, over)
    jl, tl = jb.build_lattice(jc), tb.build_lattice(tc)
    jh, th = jb.build_hamiltonian(jc, jl), tb.build_hamiltonian(tc, tl)
    mem, n_params = int(mem_gib * 2**30), 18656
    assert dataclasses.asdict(tmem.model_footprint(tc, tl.n_sites)) == \
        dataclasses.asdict(jmem.model_footprint(jc, jl.n_sites))
    assert tmem.auto_chunk_size(tc, tl, th, n_params, mem_bytes=mem) \
        == jmem.auto_chunk_size(jc, jl, jh, n_params, hbm_bytes=mem)
    assert tmem.auto_jacobian_chunk(tc, tl, th, n_params, mem_bytes=mem) \
        == jmem.auto_jacobian_chunk(jc, jl, jh, n_params, hbm_bytes=mem)
