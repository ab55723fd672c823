"""PyTorch port: the local energy's row compaction on the card. E_loc
forwards only the connected rows that carry a matrix element; where the
evaluation forward computes each configuration on its own (K1's recompute
mode, K2 bf16) it must be bitwise the static batch's
(``tests/torch_static_eloc.py``) at the same walkers and params, and with
the plain-torch ViT (cuBLAS picks its GEMMs by batch size) within 1e-6
relative. The nearest-neighbour S.S of the measure cell takes the same
connected sum and is held bitwise on K1. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_local_energy_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode; the
compaction's CPU test is tests/test_torch_local_energy.py)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from qmcnn_tpu_torch import builder
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
from qmcnn_tpu_torch.ops import observables
from qmcnn_tpu_torch.ops.local_energy import connected_sum, local_energy
from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key
from qmcnn_tpu_torch.utils import profiling
from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                            params_from_jax)
from tests.torch_static_eloc import static_connected_sum, static_local_energy

ROOT = Path(__file__).resolve().parent.parent
#: the trained flagship CNN, so the ratios are far from 1
FLAGSHIP = ROOT / "runs" / "ab_cnn_float32.csv.params.npz"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _setup(config, walkers):
    cfg = tcfg.load(str(ROOT / "configs" / f"{config}.yaml"),
                    (f"sampler.n_walkers={walkers}",))
    vmc, params, lattice = builder.build(cfg, device="cuda")
    s = init_walkers(prng_key(11), walkers, lattice.n_sites, sector="sz0",
                     device="cuda")
    return vmc, params, s


def _both(fn, params, ham, s):
    """(compacted, static) E_loc and the rows the compacted one forwarded."""
    with torch.no_grad():
        lp = fn(params, s)
        before = profiling.counters().get("e_loc.rows", 0.0)
        got = local_energy(fn, params, ham, s, lp)
        rows = profiling.counters()["e_loc.rows"] - before
        want = static_local_energy(fn, params, ham, s, lp)
    torch.cuda.synchronize()
    mask = ham.connected_batch(s)[2]
    assert rows == int(mask.sum()) < mask.numel()
    return got, want


@pytest.mark.cuda
def test_compacted_e_loc_bitwise_on_k1_recompute():
    """heis10x10_sr at 256 walkers, the trained flagship's weights: E_loc
    through K1's recompute forward equals the static batch's bit for bit."""
    _card()
    vmc, _, s = _setup("heis10x10_sr", 256)
    fn = vmc.eval_log_psi_fn
    assert isinstance(fn, k1.FusedCNNLogPsi)
    params = params_from_jax(load_checkpoint_params(str(FLAGSHIP)), "cuda")
    launches = k1.metropolis_sweep.launches
    got, want = _both(fn, params, vmc.ham, s)
    assert k1.metropolis_sweep.launches - launches == 3
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


@pytest.mark.cuda
def test_compacted_nn_ss_bitwise_on_k1_recompute():
    """The measure cell's nearest-neighbour S.S (heis10x10_sr, 2,048
    walkers, Marshall basis, the flagship's weights) through K1's recompute
    forward forwards only its anti-aligned pairs and equals the static
    batch bit for bit, per walker and in the estimator's mean."""
    _card()
    vmc, _, s = _setup("heis10x10_sr", 2048)
    fn = vmc.eval_log_psi_fn
    assert isinstance(fn, k1.FusedCNNLogPsi)
    params = params_from_jax(load_checkpoint_params(str(FLAGSHIP)), "cuda")
    conn = observables.spin_spin_connected(vmc.ham.lattice, 1,
                                           marshall=True)
    with torch.no_grad():
        lp = fn(params, s)
        before = profiling.counters().get("e_loc.rows", 0.0)
        got = connected_sum(fn, params, s, lp, conn)
        rows = profiling.counters()["e_loc.rows"] - before
        mean = observables.offdiag_observable(fn, params, s, lp, conn)
        want = static_connected_sum(fn, params, s, lp, conn)
    torch.cuda.synchronize()
    mask = conn(s)[2]
    assert rows == int(mask.sum()) < mask.numel()
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert torch.equal(mean.re, want.re.mean())
    assert torch.equal(mean.im, want.im.mean())


@pytest.mark.cuda
def test_compacted_e_loc_bitwise_on_k2_bf16():
    """j1j2_8x8_gcnn_r2 at 64 walkers (bf16, spin-flip sector): E_loc
    through K2's bf16 route equals the static batch's bit for bit."""
    _card()
    vmc, params, s = _setup("j1j2_8x8_gcnn_r2", 64)
    fn = vmc.eval_log_psi_fn
    assert isinstance(fn, k2.FusedLogPsi) and fn.compute_dtype == "bfloat16"
    launches = k2.gcnn_group_sums.launches_bf16
    got, want = _both(fn, params, vmc.ham, s)
    assert k2.gcnn_group_sums.launches_bf16 - launches == 3
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


@pytest.mark.cuda
def test_compacted_e_loc_vit_close():
    """j1j2_8x8_vit at 32 walkers (the plain f32 trunk): within 1e-6
    relative of the static batch's E_loc."""
    _card()
    vmc, params, s = _setup("j1j2_8x8_vit", 32)
    got, want = _both(vmc.eval_log_psi_fn, params, vmc.ham, s)
    scale = float(want.re.abs().max())
    for a, b in ((got.re, want.re), (got.im, want.im)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-6 * scale)
