"""A/B timing of the fused Metropolis sweep (K1) between source trees on
one CUDA card, in the order the trees are given:

  python -m qmcnn_tpu_torch.sweep_ab --tree OTHER --tree . --tree . \\
      --tree OTHER [--out FILE]

For each ``--tree`` one subprocess imports ``qmcnn_tpu_torch`` from that
tree (building its kernel there) and
  * times ``metropolis_sweep`` with CUDA events at the shapes of
    ``chip_smoke.py``: one exchange sweep of the heis10x10_sr flagship
    (M = 2,048, 10x10, C = 16^3, k = 3, the params of
    runs/ab_cnn_float32.csv.params.npz), one flip sweep of the tfim16 shape
    (M = 2,048, N = 16, C = (12, 12), k = 5), and the recompute forward
    (``n_props = 0``) at the heis10x10_sr E_loc batch (2,048 x 201 =
    411,648 configurations) beside the cuDNN model (TF32 off) on the same
    batch, with the largest relative difference of the two;
  * times a training step of configs/heis10x10_sr.yaml from the same
    params phase by phase (three steps after a warm-up, as
    ``step_timing``), with whatever evaluation forward that tree's
    builder chooses.
The inputs come from seeds through code both trees share (the walkers'
init, the noise), so every run sees the same tensors. Prints one JSON line
per run and, last, the mean of each number per tree.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

MARK = "SWEEP_AB "


def _worker(root: str) -> dict:
    """One tree's run; ``qmcnn_tpu_torch`` must resolve to ``root``."""
    import torch
    import qmcnn_tpu_torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.lattice import chain, square
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN, log_psi_apply
    from qmcnn_tpu_torch.sampler.metropolis import (fold_in, init_walkers,
                                                    prng_key, sweep_noise)
    from qmcnn_tpu_torch.step_timing import step_split
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    pkg = Path(qmcnn_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the tree {root}")
    here = Path(__file__).resolve().parent.parent
    dev = "cuda"

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    t0 = time.perf_counter()
    k1.build()
    rec = {"tree": root, "device": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0}
    flagship = params_from_jax(load_checkpoint_params(
        str(here / "runs" / "ab_cnn_float32.csv.params.npz")), dev)
    tfim_params = LogPsiCNN((16,), channels=(12, 12), kernel_size=5,
                            param_scale=0.2).init(11, device=dev)
    m = 2048
    ids = torch.arange(m, device=dev)
    for name, params, lat, move, reps in (
            ("flagship", flagship, square(10), "exchange", 10),
            ("tfim16", tfim_params, chain(16), "flip", 50)):
        n = lat.n_sites
        bonds = lat.nn_bonds if move == "exchange" else None
        s = init_walkers(prng_key(1), m, n, device=dev,
                         sector="sz0" if move == "exchange" else None)
        kw = dict(lattice_shape=lat.shape, move=move, bonds=bonds)
        lp = k1.metropolis_sweep(params, s, torch.zeros(m, device=dev),
                                 n_props=0, **kw)[1]
        noise = sweep_noise(prng_key(2), ids, n,
                            len(bonds) if move == "exchange" else n)
        rec[f"{name}_sweep_ms"] = cuda_ms(
            lambda: k1.metropolis_sweep(params, s, lp, n_props=n,
                                        noise=noise, **kw), reps)

    x = init_walkers(prng_key(3), m * 201, 100, sector="sz0", device=dev)
    zeros = torch.zeros(x.shape[0], device=dev)
    model = LogPsiCNN((10, 10), channels=(16, 16, 16), kernel_size=3).to(dev)

    def recompute():
        return k1.metropolis_sweep(flagship, x, zeros, lattice_shape=(10, 10),
                                   n_props=0)[1]

    got, want = recompute(), log_psi_apply(model, flagship, x).re
    rec["e_loc_batch_max_rel_err"] = float(
        ((got.double() - want.double()).abs() / want.double().abs()).max())
    del got, want
    rec["e_loc_batch_ms"] = cuda_ms(recompute, 3)
    rec["e_loc_batch_cudnn_ms"] = cuda_ms(
        lambda: log_psi_apply(model, flagship, x), 3)
    del x, zeros

    cfg = configs.load(str(here / "configs" / "heis10x10_sr.yaml"), ())
    vmc, _, _ = build(cfg, device=dev)
    key = prng_key(cfg.run.seed + 100)
    state = vmc.init_state(fold_in(key, 0), m, flagship, device=dev)
    state = vmc.thermalize(state, fold_in(key, 1), ids, 20)
    step = step_split(vmc, state, 3)
    rec.update({f"step_{k}_ms": v for k, v in step.items()})
    rec["step_total_ms"] = sum(step.values())
    return rec


def main(argv=None) -> int:
    from qmcnn_tpu_torch.gcnn_ab import run_ab

    return run_ab(argv, Path(__file__).resolve(), MARK,
                  __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
