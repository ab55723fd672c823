"""PyTorch port: the CUDA kernels (the Metropolis sweep, the fused GCNN
forward) against their plain PyTorch versions on the card. Imports no JAX,
so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode; the
plain versions' parity with JAX is tests/test_torch_sweep.py,
tests/test_torch_gcnn.py and tests/test_torch_bf16.py). Sweep decisions
must be equal; log psi within
rtol 1e-5 (float32, the kernel's 3xTF32 tensor-core products summed in
another order than cuDNN's), and bitwise the same in any slot of a block. GCNN
readout sums within rtol/atol 1e-4, 1e-3 for residual stacks deeper than 3
layers (float32, the kernel's 3xTF32 tensor-core products summed in
another order; rounding compounds with depth). K2's bf16 route: see
BF16_RTOL."""
import numpy as np
import pytest
import torch

from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.models.cnn import LogPsiCNN
from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN
from qmcnn_tpu_torch.sampler.metropolis import (init_walkers, prng_key,
                                                sweep_noise)

# (lattice shape, channels, kernel, walkers): 1D/2D, odd/even k, channel
# counts off the 8-wide mma tiles, a one-layer stack (no tensor-core layer),
# N = 1600, the hero width C = 24 (6 walkers per block), heis40's 6-layer
# k = 7 chain, and walker counts that fill no block
CASES = {
    "chain_k5": ((16,), (12, 12), 5, 37),
    "square_k3": ((6, 6), (16, 16, 16), 3, 64),
    "even_k_odd_channels": ((4, 6), (5, 20), 2, 33),
    "wide_lattice": ((40, 40), (3,), 3, 5),
    "hero_c24": ((10, 10), (24, 24, 24), 3, 13),
    "heis40_k7": ((40,), (12,) * 6, 7, 19),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _setup(name, move, dev):
    shape, channels, k, m = CASES[name]
    lat = Lattice(shape)
    model = LogPsiCNN(shape, channels=channels, kernel_size=k,
                      param_scale=0.25)
    params = model.init(5, device=dev)
    s = init_walkers(prng_key(1), m, lat.n_sites,
                     sector="sz0" if move == "exchange" else None, device=dev)
    lp = k1.sweep_reference(params, s, torch.zeros(m, device=dev),
                            lattice_shape=shape, n_props=0)[1]
    bonds = lat.nn_bonds if move == "exchange" else None
    n_choices = lat.n_sites if move == "flip" else len(bonds)
    noise = sweep_noise(prng_key(2), torch.arange(m, device=dev),
                        2 * lat.n_sites, n_choices)
    return params, s, lp, dict(lattice_shape=shape, move=move, bonds=bonds,
                               noise=noise, n_props=2 * lat.n_sites)


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["flip", "exchange"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(name, move):
    dev = _card()
    params, s, lp, kw = _setup(name, move, dev)
    before = k1.metropolis_sweep.launches
    got = k1.metropolis_sweep(params, s, lp, **kw)
    torch.cuda.synchronize()
    assert k1.metropolis_sweep.launches == before + 1
    want = k1.sweep_reference(params, s, lp, **kw)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    if move == "exchange":
        assert torch.equal(got[0].sum(1), s.sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_recompute_mode(name):
    dev = _card()
    params, s, lp, kw = _setup(name, "flip", dev)
    kw.update(n_props=0, noise=None)
    s_k, lp_k, acc = k1.metropolis_sweep(params, s, torch.zeros_like(lp),
                                         **kw)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s) and int(acc.sum()) == 0
    np.testing.assert_allclose(lp_k.cpu().numpy(), lp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["square_k3", "hero_c24", "heis40_k7"])
def test_log_psi_does_not_depend_on_slot_or_batch(name):
    """A configuration's log psi is bitwise the same in any slot of a block
    and at any batch size: a permuted batch, a sub-batch and a batch that
    repeats the configurations give the same bits."""
    dev = _card()
    params, s, lp, kw = _setup(name, "flip", dev)
    kw.update(n_props=0, noise=None)
    zeros = torch.zeros(s.shape[0] + 3, device=dev)

    def recompute(x):
        return k1.metropolis_sweep(params, x, zeros[:x.shape[0]], **kw)[1]

    full = recompute(s)
    perm = torch.randperm(s.shape[0], generator=torch.Generator().manual_seed(
        0)).to(dev)
    assert torch.equal(recompute(s[perm]), full[perm])
    assert torch.equal(recompute(s[3:8]), full[3:8])
    assert torch.equal(recompute(torch.cat([s[:3], s]))[3:], full)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["square_k3", "hero_c24", "heis40_k7"])
def test_fused_cnn_log_psi_matches_model(name):
    """FusedCNNLogPsi (the kernel's recompute mode) against the cuDNN model
    (TF32 off): rtol 1e-5 (float32 sums in another order)."""
    from qmcnn_tpu_torch.models.cnn import log_psi_apply

    dev = _card()
    shape, channels, k, m = CASES[name]
    model = LogPsiCNN(shape, channels=channels, kernel_size=k,
                      param_scale=0.25)
    params = model.init(5, device=dev)
    s = init_walkers(prng_key(3), 4 * m, int(np.prod(shape)), device=dev)
    before = k1.metropolis_sweep.launches
    got = k1.FusedCNNLogPsi(lattice_shape=shape)(params, s)
    assert k1.metropolis_sweep.launches == before + 1
    want = log_psi_apply(model.to(dev), params, s)
    np.testing.assert_allclose(got.re.cpu().numpy(), want.re.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not bool(got.im.any())


@pytest.mark.cuda
def test_shared_memory_limit_raises():
    dev = _card()
    model = LogPsiCNN((64, 64), channels=(16, 16), kernel_size=3)
    params = model.init(0, device=dev)
    s = init_walkers(prng_key(0), 2, 64 * 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        k1.metropolis_sweep(params, s, torch.zeros(2, device=dev),
                            lattice_shape=(64, 64), n_props=0)


# (lattice, C per group element, layers, complex, activation, residual,
# batch): W = 8C of 64, 80 and 96; real and complex; lncosh and selu; a
# residual stack; a single-layer net; site counts that fill no 16-row mma
# tile (25, 36, 100, 144); blocks of 1 to 7 configurations (10x10 at W = 64
# takes 2, 12x12 at W = 80 takes 1, 8x8 at W = 64 takes 3); and batches
# that are no multiple of the block's configuration count
GCNN_CASES = {
    "w64_l3_lncosh_complex": ((8, 8), 8, 3, True, "lncosh", False, 37),
    "w80_l5_selu_residual": ((8, 8), 10, 5, True, "selu", True, 19),
    "w96_l2_selu_real": ((6, 6), 12, 2, False, "selu", False, 33),
    "w64_l2_lncosh_real_5x5": ((5, 5), 8, 2, False, "lncosh", False, 5),
    "w80_l1_complex": ((4, 4), 10, 1, True, "lncosh", False, 3),
    "w64_l3_lncosh_complex_10x10": ((10, 10), 8, 3, True, "lncosh", False,
                                    7),
    "w80_l3_selu_complex_12x12": ((12, 12), 10, 3, True, "selu", False, 5),
    "w64_l3_lncosh_complex_b1000": ((8, 8), 8, 3, True, "lncosh", False,
                                    1000),
}


def _gcnn_setup(name, dev, cases=None):
    shape, c, n_layers, cplx, act, residual, batch = (cases
                                                      or GCNN_CASES)[name]
    model = LogPsiGCNN(shape, channels=(c,) * n_layers, kernel_size=3,
                       complex_params=cplx, param_scale=1.0,
                       init_mode="fan_in", activation=act, residual=residual)
    params = model.init(3, device=dev)
    gen = torch.Generator().manual_seed(4)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
              if "bias" in k else v for k, v in params.items()}
    x = init_walkers(prng_key(5), batch, int(np.prod(shape)), device=dev)
    ws = k2.expand_gcnn_params(params, 3, cplx)
    kw = dict(lattice_shape=shape, channels=(c,) * n_layers, kernel_size=3,
              activation=act, residual=residual)
    return params, x, ws, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GCNN_CASES))
def test_gcnn_kernel_matches_plain_version(name):
    dev = _card()
    _, x, ws, kw = _gcnn_setup(name, dev)
    before = k2.gcnn_group_sums.launches
    got = k2.gcnn_group_sums(x, ws, **kw)
    torch.cuda.synchronize()
    assert k2.gcnn_group_sums.launches == before + 1
    want = k2.gcnn_group_sums_reference(x, ws, **kw)
    tol = 1e-3 if kw["residual"] and len(kw["channels"]) > 3 else 1e-4
    for a, b in ((got.re, want.re), (got.im, want.im)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=tol, atol=tol)
    again = k2.gcnn_group_sums(x, ws, **kw)  # the readout is deterministic
    assert torch.equal(again.re, got.re) and torch.equal(again.im, got.im)


@pytest.mark.cuda
@pytest.mark.parametrize("character,sector", [("A1", 1), ("B1", -1)])
def test_gcnn_fused_log_psi_matches_model(character, sector):
    """The fused log psi against the plain model (spin-flip projected), in
    amplitudes normalized to the batch for a sign-changing character."""
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized

    dev = _card()
    kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8), kernel_size=3,
              complex_params=True, param_scale=0.1, character=character)
    model = SpinFlipSymmetrized(LogPsiGCNN(**kw), sector)
    params = model.init(6, device=dev)
    gen = torch.Generator().manual_seed(7)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
              if "bias" in k else v for k, v in params.items()}
    s = init_walkers(prng_key(8), 41, 64, sector="sz0", device=dev)
    kw.pop("param_scale")
    got = k2.FusedLogPsi(spin_flip_sector=sector, **kw)(params, s)
    want = log_psi_apply(model, params, s)
    scale = float(want.re.max())

    def amp(lp):
        return (torch.exp(lp.re - scale) * torch.exp(1j * lp.im)).cpu()

    np.testing.assert_allclose(amp(got).numpy(), amp(want).numpy(),
                               atol=1e-3)


#: the bf16 route against its plain bf16 version: both round at the same
#: points (bf16 weights and activations, f32 sums, the f32 bias and
#: activation rounded once, the bf16 residual), so what is left is the f32
#: summation order now and then flipping one bf16 rounding of an
#: activation (2^-8 relative), which later layers carry on. S_g is held to
#: BF16_RTOL of (1 + each configuration's largest |S_g|): a few flips in a
#: sum of 64 x W activations, sized from the errors measured on the H100
#: at depths 8 and 12 (up to 1.7e-4 at depth 8, 5.7e-3 on the depth-12
#: snapshot, as two plain versions summing in other orders differ: PERF.md)
BF16_RTOL = 1e-2
#: the bf16 cases: the f32 cases above, the gcnn_r2 hero shape (8x8, C = 10
#: x 8, selu, residual, complex), channel counts whose W = 8C is no
#: multiple of 16 (the padded k step), a batch of 1, 10x10 (two ragged
#: 64-row M tiles per configuration), 16x16 at W = 80 (four M tiles in two
#: passes between two buffers: the largest block, one warpgroup) and W = 128
#: complex (N = 256, one M tile of accumulators per warpgroup)
GCNN_BF16_CASES = dict(GCNN_CASES, **{
    "w80_l8_selu_residual_r2": ((8, 8), 10, 8, True, "selu", True, 67),
    "w24_l3_selu_residual_odd_c": ((4, 4), 3, 3, True, "selu", True, 9),
    "w40_l3_lncosh_real_odd_c": ((6, 6), 5, 3, False, "lncosh", False, 11),
    "w80_l3_selu_complex_b1": ((8, 8), 10, 3, True, "selu", False, 1),
    "w80_l4_selu_residual_10x10": ((10, 10), 10, 4, True, "selu", True, 7),
    "w80_l3_selu_complex_16x16": ((16, 16), 10, 3, True, "selu", False, 3),
    "w128_l3_lncosh_complex": ((8, 8), 16, 3, True, "lncosh", False, 21),
})


def _assert_sg_close(got, want, rtol):
    size = 1.0 + torch.maximum(want.re.abs(), want.im.abs()).amax(dim=1)
    for a, b in ((got.re, want.re), (got.im, want.im)):
        err = ((a - b).abs() / size[:, None]).max()
        assert float(err) <= rtol, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GCNN_BF16_CASES))
def test_gcnn_bf16_kernel_matches_plain_version(name):
    """K2's bf16 route against its plain bf16 version; it counts on its own
    counter, is deterministic, and differs from the f32 route (its plain
    version, as 16x16 at W = 80 takes no f32 kernel)."""
    dev = _card()
    _, x, ws, kw = _gcnn_setup(name, dev, GCNN_BF16_CASES)
    before = (k2.gcnn_group_sums.launches, k2.gcnn_group_sums.launches_bf16)
    got = k2.gcnn_group_sums(x, ws, compute_dtype="bfloat16", **kw)
    torch.cuda.synchronize()
    assert (k2.gcnn_group_sums.launches,
            k2.gcnn_group_sums.launches_bf16) == (before[0], before[1] + 1)
    want = k2.gcnn_group_sums_reference(x, ws, compute_dtype="bfloat16",
                                        **kw)
    _assert_sg_close(got, want, BF16_RTOL)
    again = k2.gcnn_group_sums(x, ws, compute_dtype="bfloat16", **kw)
    assert torch.equal(again.re, got.re) and torch.equal(again.im, got.im)
    f32 = k2.gcnn_group_sums_reference(x, ws, **kw)
    assert not torch.equal(f32.re, got.re)


@pytest.mark.cuda
@pytest.mark.parametrize("character,sector", [("A1", 1), ("B1", -1)])
def test_gcnn_bf16_fused_log_psi_matches_plain(character, sector):
    """FusedLogPsi on the bf16 route against the same forward on the CPU
    (the plain bf16 version), in amplitudes normalized to the batch."""
    dev = _card()
    kw = dict(lattice_shape=(8, 8), channels=(10,) * 4, kernel_size=3,
              complex_params=True, character=character,
              activation="selu", residual=True)
    model = LogPsiGCNN(param_scale=1.0, init_mode="fan_in", **kw)
    from qmcnn_tpu_torch.models.gcnn import SpinFlipSymmetrized

    params = SpinFlipSymmetrized(model, sector).init(6, device=dev)
    s = init_walkers(prng_key(8), 41, 64, sector="sz0", device=dev)
    fused = k2.FusedLogPsi(spin_flip_sector=sector, compute_dtype="bfloat16",
                           **kw)
    got = fused(params, s)
    want = fused({k: v.cpu() for k, v in params.items()}, s.cpu())
    scale = float(want.re.max())

    def amp(lp):
        return (torch.exp(lp.re.cpu() - scale)
                * torch.exp(1j * lp.im.cpu())).numpy()

    np.testing.assert_allclose(amp(got), amp(want), atol=BF16_RTOL)


@pytest.mark.cuda
def test_gcnn_shared_memory_limit_raises():
    dev = _card()
    _, _, ws, _ = _gcnn_setup("w64_l3_lncosh_complex", dev)
    x = init_walkers(prng_key(0), 2, 16 * 16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        k2.gcnn_group_sums(x, ws, lattice_shape=(16, 16), channels=(8,) * 3,
                           kernel_size=3)
    # bf16 rows take half the bytes: 24x24 at W = 64 is still too large
    x = init_walkers(prng_key(0), 2, 24 * 24, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        k2.gcnn_group_sums(x, ws, lattice_shape=(24, 24), channels=(8,) * 3,
                           kernel_size=3, compute_dtype="bfloat16")
