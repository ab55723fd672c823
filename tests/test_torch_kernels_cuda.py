"""PyTorch port: the CUDA sweep kernel against its plain PyTorch version on
the card. Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips (the kernel has no CPU mode; the
plain version's parity with JAX is tests/test_torch_sweep.py). Decisions
must be equal; log psi within rtol 1e-5 (float32, the kernel sums in
another order than cuDNN)."""
import numpy as np
import pytest
import torch

from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.models.cnn import LogPsiCNN
from qmcnn_tpu_torch.sampler.metropolis import (init_walkers, prng_key,
                                                sweep_noise)

# (lattice shape, channels, kernel, walkers): 1D/2D, odd/even k, channel
# counts off the 16-wide register block, N above one block's 1024 threads,
# and walker counts that fit no block size
CASES = {
    "chain_k5": ((16,), (12, 12), 5, 37),
    "square_k3": ((6, 6), (16, 16, 16), 3, 64),
    "even_k_odd_channels": ((4, 6), (5, 20), 2, 33),
    "wide_lattice": ((40, 40), (3,), 3, 5),
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
def test_shared_memory_limit_raises():
    dev = _card()
    model = LogPsiCNN((64, 64), channels=(16, 16), kernel_size=3)
    params = model.init(0, device=dev)
    s = init_walkers(prng_key(0), 2, 64 * 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        k1.metropolis_sweep(params, s, torch.zeros(2, device=dev),
                            lattice_shape=(64, 64), n_props=0)
