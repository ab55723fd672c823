#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — compile every CUDA kernel of the training path;
  3. kernels  — the fused Metropolis sweep against its plain PyTorch
                version on the card (TF32 off), at the flagship shapes
                (10x10, C=16^3, k=3, M=2048, trained fixture params) and at
                the tfim16 shape (N=16, C=(12,12), k=5);
  4. main     — the training path through ``qmcnn_tpu_torch.train.train``:
                configs/heis10x10_sr.yaml at full width warm-started from
                runs/ab_cnn_float32.csv.params.npz (5 steps after the
                config's 100 thermalization sweeps; the tail energy must sit
                within 0.01/site of the -0.6705/site the JAX run that wrote
                the fixture reached), then a few steps of
                configs/tfim16_sgd.yaml (flip moves, 1D, the ED check);
                the kernel launch counters are zeroed before the heis10x10
                run and read after it;
  5. timings  — CUDA-event times of the kernel, its plain version and the
                torch sampler per sweep, the kernel's bound, and the
                per-phase split of one flagship training step;
  6. report   — one JSON line of kernel records, the card line, and the
                final ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
CUDA device or without the ``qmcnn_tpu_torch`` package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "runs" / "ab_cnn_float32.csv.params.npz"
E_SITE_FIXTURE = -0.6705  # the JAX run that wrote the fixture (BASELINE.md)
#: card peaks (H100 SXM data sheet): FP32 outside the tensor cores, HBM rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

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


def forward_flop(params, n_sites: int) -> int:
    """FLOPs of one LogPsiCNN forward's convolutions (2 per MAC)."""
    flop = 0
    for k, v in params.items():
        if k.endswith("/kernel"):
            flop += 2 * n_sites * v.numel()
    return flop


def sweep_case(name, params, lattice, m, move, seed, device):
    """Walkers, noise and the reference log psi for one sweep check."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import sweep_reference
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    n = lattice.n_sites
    s = init_walkers(prng_key(seed), m, n,
                     sector="sz0" if move == "exchange" else None,
                     device=device)
    lp = sweep_reference(params, s, torch.zeros(m, device=device),
                         lattice_shape=lattice.shape, n_props=0)[1]
    bonds = lattice.nn_bonds if move == "exchange" else None
    n_choices = n if move == "flip" else len(bonds)
    return dict(name=name, params=params, lattice=lattice, s=s, lp=lp,
                bonds=bonds, move=move, n_choices=n_choices,
                ids=torch.arange(m, device=device), key=prng_key(seed + 1))


def compare_kernel(case, n_sweeps: int = 2) -> dict:
    """Kernel vs plain version on the card: recompute mode, then an
    n_sweeps run with injected noise. Returns max abs error of log psi."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import (metropolis_sweep,
                                                          sweep_reference)
    from qmcnn_tpu_torch.sampler.metropolis import sweep_noise

    p, lat, s, lp = case["params"], case["lattice"], case["s"], case["lp"]
    kw = dict(lattice_shape=lat.shape, move=case["move"], bonds=case["bonds"])
    _, lp_k, _ = metropolis_sweep(p, s, lp, n_props=0, **kw)
    torch.cuda.synchronize()
    a, b = lp_k.double().cpu().numpy(), lp.double().cpu().numpy()
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    max_abs = float(np.max(np.abs(a - b)))
    print(f"  {case['name']}: recompute max rel err {rel:.3e} "
          f"(max abs {max_abs:.3e}, |log psi| ~ {np.abs(b).mean():.3f})")
    check(rel <= 1e-5, f"{case['name']} recompute rel err {rel} > 1e-5")

    n_props = n_sweeps * lat.n_sites
    noise = sweep_noise(case["key"], case["ids"], n_props, case["n_choices"])
    s_k, lp_kt, acc_k = metropolis_sweep(p, s, lp, n_props=n_props,
                                         noise=noise, **kw)
    s_r, lp_rt, acc_r = sweep_reference(p, s, lp, n_props=n_props,
                                        noise=noise, **kw)
    torch.cuda.synchronize()
    differ = float((s_k != s_r).any(dim=1).float().mean())
    lp_re = sweep_reference(p, s_k, lp_kt, n_props=0, **kw)[1]
    track = float(((lp_kt - lp_re).abs() / lp_re.abs()).max())
    acc = float(acc_k.float().mean()) / n_props
    print(f"  {case['name']} {case['move']} {n_sweeps} sweeps: walkers "
          f"ending in a different s {differ:.5f}, tracked-vs-recomputed "
          f"log psi max rel {track:.3e}, accept {acc:.4f} (plain "
          f"{float(acc_r.float().mean()) / n_props:.4f})")
    check(differ <= 1e-3, f"{case['name']}: {differ} of walkers differ")
    check(track <= 1e-4, f"{case['name']}: tracked log psi off by {track}")
    check(0.0 < acc < 1.0, f"{case['name']}: accept rate {acc}")
    if case["move"] == "exchange":
        sz = s_k.sum(dim=1)
        check(bool((sz == s.sum(dim=1)).all()), "S^z not conserved")
    return {"max_abs_err": max_abs}


def time_sweep(case, card: str) -> dict:
    """Kernel, plain version and torch sampler ms per sweep, and the bound."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import (metropolis_sweep,
                                                          sweep_reference)
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN, log_psi_apply
    from qmcnn_tpu_torch.ops.cplx import C
    from qmcnn_tpu_torch.sampler.metropolis import (MetropolisSampler,
                                                    WalkerState, sweep_noise)

    p, lat, s, lp = case["params"], case["lattice"], case["s"], case["lp"]
    m, n = s.shape
    kw = dict(lattice_shape=lat.shape, move=case["move"], bonds=case["bonds"])
    noise = sweep_noise(case["key"], case["ids"], n, case["n_choices"])
    ms = cuda_ms(lambda: metropolis_sweep(p, s, lp, n_props=n, noise=noise,
                                          **kw), reps=5)
    plain_ms = cuda_ms(lambda: sweep_reference(p, s, lp, n_props=n,
                                               noise=noise, **kw), reps=2)
    channels = [int(v.shape[-1]) for k, v in sorted(p.items())
                if k.endswith("/kernel")]
    ksz = tuple(p["params/RealConv_0/kernel"].shape[:-2])
    model = LogPsiCNN(lat.shape, channels=channels, kernel_size=ksz)
    sampler = MetropolisSampler(lambda q, x: log_psi_apply(model, q, x),
                                n_sites=n, move=case["move"],
                                bonds=case["bonds"], backend="torch")
    zeros = torch.zeros(m, dtype=torch.int32, device=s.device)
    state = WalkerState(s, C(lp, torch.zeros_like(lp)), zeros, zeros)
    torch_ms = cuda_ms(lambda: sampler.sample(p, state, case["key"],
                                              case["ids"], 1, noise=noise),
                       reps=2)
    flop = m * n * forward_flop(p, n)
    n_bytes = 4 * (2 * m * n + 3 * m + 3 * n * m
                   + sum(v.numel() for v in p.values()))
    ops_ms = flop / FP32_FLOPS * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"  {case['name']} ({card}): kernel {ms:.4f} ms/sweep, plain "
          f"version {plain_ms:.4f} ms/sweep, torch sampler {torch_ms:.4f} "
          f"ms/sweep, bound {bound_ms:.4f} ms ({flop:.3e} FLOP at "
          f"{FP32_FLOPS:.3g} FP32 FLOP/s; bytes {bytes_ms:.5f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "torch_sampler_ms": torch_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def step_split(cfg, state, card: str) -> None:
    """Per-phase device time of flagship training steps (host clock around
    synchronized phases)."""
    import torch
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.vmc import energy_and_grad

    vmc, _, _ = build(cfg, device="cuda")
    params, walkers = state.params, state.walkers
    opt_state = vmc.optimizer.init(params)
    ids = torch.arange(walkers.s.shape[0], device="cuda")
    totals = {"sample": 0.0, "e_loc": 0.0, "gradient": 0.0, "sr": 0.0,
              "update": 0.0}
    n = 3

    def lap(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(n + 1):
        t0 = time.perf_counter()
        w = vmc.sampler.refresh(params, vmc.sampler.reset_counters(walkers))
        w = vmc.sampler.sample(params, w, fold_in(prng_key(7), i), ids, 1)
        t_sample = lap(t0)
        t0 = time.perf_counter()
        local_energy(vmc.log_psi_fn, params, vmc.ham, w.s, w.log_psi,
                     chunk_size=vmc.chunk_size)
        t_eloc = lap(t0)
        t0 = time.perf_counter()
        _, _, grads, e_loc = energy_and_grad(vmc.log_psi_fn, vmc.ham, params,
                                             w, chunk_size=vmc.chunk_size)
        t_grad = lap(t0) - t_eloc
        t0 = time.perf_counter()
        grads, iters, _ = vmc.sr.solve(vmc.log_psi_fn, params, w.s, grads,
                                       state.step, e_loc=e_loc)
        t_sr = lap(t0)
        t0 = time.perf_counter()
        upd, opt_state = vmc.optimizer.update(grads, opt_state)
        params = {k: params[k] + upd[k] for k in params}
        t_upd = lap(t0)
        walkers = w
        if i:  # the first step warms up
            for k, v in zip(totals, (t_sample, t_eloc, t_grad, t_sr, t_upd)):
                totals[k] += v / n
    total = sum(totals.values())
    parts = ", ".join(f"{k} {v:.2f}" for k, v in totals.items())
    print(f"  heis10x10_sr step ({card}): {total:.2f} ms = {parts} ms "
          f"(pcg iters last step {iters})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "qmcnn_tpu_torch").is_dir():
        print(f"chip_smoke: qmcnn_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.lattice import chain, square
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN
    from qmcnn_tpu_torch.train import train
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    path, log = k1.build()
    print(f"[2] build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    # 3. kernel vs plain version on the card
    print("[3] fused sweep vs plain version (TF32 off)", flush=True)
    dev = "cuda"
    flagship = params_from_jax(load_checkpoint_params(str(FIXTURE)), dev)
    sq = square(10)
    tfim = chain(16)
    tfim_model = LogPsiCNN(tfim.shape, channels=(12, 12), kernel_size=5,
                           param_scale=0.2)
    tfim_params = tfim_model.init(11, device=dev)
    cases = {
        "flagship_exchange": sweep_case("heis10x10", flagship, sq, 2048,
                                        "exchange", 1, dev),
        "flagship_flip": sweep_case("heis10x10", flagship, sq, 2048, "flip",
                                    2, dev),
        "tfim16_flip": sweep_case("tfim16", tfim_params, tfim, 2048, "flip",
                                  3, dev),
    }
    errs = {k: compare_kernel(c)["max_abs_err"] for k, c in cases.items()}

    # 4. main path, counters zeroed just before and read just after
    print("[4] main path: heis10x10_sr training", flush=True)
    out_dir = ROOT / ".runs" / "chip_smoke"  # git-ignored
    out_dir.mkdir(parents=True, exist_ok=True)
    csv = out_dir / "heis10x10_sr.csv"
    cfg = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"), (
        f"run.init_from={FIXTURE}", "run.n_steps=5", "run.log_every=1",
        f"run.csv_path={csv}"))
    k1.metropolis_sweep.launches = 0
    t0 = time.perf_counter()
    state, logger = train(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = k1.metropolis_sweep.launches
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    tail, _ = logger.tail_energy()
    e_site = tail / sq.n_sites
    print(f"    heis10x10_sr: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {launches}, E/site tail {e_site:.5f} (fixture "
          f"{E_SITE_FIXTURE}), accept {acc.tolist()}, sr_iters "
          f"{hist['sr_iters']}")
    check(np.isfinite(e).all(), "non-finite energies")
    check(((acc > 0) & (acc < 1)).all(), "accept rate outside (0, 1)")
    check(min(hist["sr_iters"]) > 0, "SR ran no iterations")
    check(launches > 0, "the training path never launched the kernel")
    check(abs(e_site - E_SITE_FIXTURE) <= 0.01,
          f"E/site {e_site} not within 0.01 of {E_SITE_FIXTURE}")

    print("[4] main path: tfim16_sgd training", flush=True)
    csv_t = out_dir / "tfim16_sgd.csv"
    cfg_t = configs.load(str(ROOT / "configs" / "tfim16_sgd.yaml"), (
        "run.n_steps=20", "run.log_every=5", f"run.csv_path={csv_t}"))
    before = k1.metropolis_sweep.launches
    t0 = time.perf_counter()
    _, logger_t = train(cfg_t, device="cuda")
    e_t = np.asarray(logger_t.history["energy_re"])
    rel = logger_t.history["rel_err"]
    print(f"    tfim16_sgd: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {k1.metropolis_sweep.launches - before}, rel_err "
          f"{[round(r, 4) for r in rel]}")
    check(np.isfinite(e_t).all(), "tfim16: non-finite energies")
    check(k1.metropolis_sweep.launches > before, "tfim16: no kernel launch")
    # 20 plain-SGD steps barely leave the near-uniform init (E = -h N =
    # -16, rel_err 0.216): hold the tail to the variational bound and to
    # that starting point
    tail_t, err_t = logger_t.tail_energy()
    e_exact = -20.404594  # ED ground energy of the N=16, h=J TFIM chain
    print(f"    tfim16_sgd tail {tail_t:.5f} +- {err_t:.5f}, ED {e_exact}")
    check(e_exact - 5 * err_t - 1e-3 <= tail_t <= -15.5,
          f"tfim16: tail energy {tail_t} outside [ED, -15.5]")
    check(rel[-1] < 0.25, f"tfim16: rel_err {rel[-1]} vs ED")

    # 5. timings
    print(f"[5] timings ({card})", flush=True)
    t_flag = time_sweep(cases["flagship_exchange"], card)
    t_tfim = time_sweep(cases["tfim16_flip"], card)
    step_split(cfg, state, card)

    # 6. report
    rec = {
        "name": "metropolis_sweep",
        "route": "cuda",
        "source": "qmcnn_tpu_torch/csrc/metropolis_sweep.cu",
        "replaces": "qmcnn_tpu/kernels/metropolis_pallas.py:97",
        "launches": launches,
        "max_abs_err": errs["flagship_exchange"],
        "ms": t_flag["ms"],
        "plain_ms": t_flag["plain_ms"],
        "bound_ms": t_flag["bound_ms"],
        "bound_by": t_flag["bound_by"],
        "library_ms": None,
    }
    print(f"    tfim16 shape: kernel {t_tfim['ms']:.4f} ms/sweep, plain "
          f"{t_tfim['plain_ms']:.4f}, bound {t_tfim['bound_ms']:.5f} "
          f"({card})")
    print(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
