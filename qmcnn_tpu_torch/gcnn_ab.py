"""A/B timing of the fused GCNN forward (K2) between source trees on one
CUDA card, in the order the trees are given:

  python -m qmcnn_tpu_torch.gcnn_ab --tree OTHER --tree . --tree . \\
      --tree OTHER [--out FILE]

For each ``--tree`` one subprocess imports ``qmcnn_tpu_torch`` from that
tree (building its kernel there) and
  * times ``gcnn_group_sums`` with CUDA events at the three shapes of
    ``chip_smoke.py``: the E_loc chunk of configs/j1j2_8x8_gcnn.yaml
    (131,072 configurations, W = 64, L = 3), its sweep shape (2,048) and
    the depth-12 snapshot runs/j1j2_8x8_d12_fix.csv.params.npz (512,
    W = 80, L = 12, selu, residual);
  * holds each against that tree's plain version (max abs error of S_g);
  * times K2's bf16 route at the shapes of configs/j1j2_8x8_gcnn_r2.yaml
    (its E_loc chunk, 131,072 configurations, W = 80, L = 8, selu,
    residual, and its sweep shape, 2,048) and at the depth-12 snapshot,
    each with its max and mean signed S_g error against that tree's plain
    bf16 version (relative to 1 + each configuration's largest |S_g|);
  * times a training step of configs/j1j2_8x8_gcnn.yaml and of
    configs/j1j2_8x8_gcnn_r2.yaml phase by phase (three steps after a
    warm-up, as ``step_timing``).
The inputs come from seeds through code both trees share (the model's
init, the walkers' init), so every run sees the same tensors. Prints one
JSON line per run and, last, the mean of each number per tree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

MARK = "GCNN_AB "


def _cuda_ms(fn, reps: int) -> float:
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


def _worker(root: str) -> dict:
    """One tree's run; ``qmcnn_tpu_torch`` must resolve to ``root``."""
    import torch
    import qmcnn_tpu_torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN
    from qmcnn_tpu_torch.sampler.metropolis import (fold_in, init_walkers,
                                                    prng_key)
    from qmcnn_tpu_torch.step_timing import step_split
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    pkg = Path(qmcnn_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the tree {root}")
    here = Path(__file__).resolve().parent.parent
    dev = "cuda"
    t0 = time.perf_counter()
    k2.build()
    build_s = time.perf_counter() - t0

    def case(model_kw, batch, seed, params=None):
        if params is None:  # chip_smoke.gcnn_case: bias-perturbed init
            params = LogPsiGCNN(**model_kw).init(seed, device=dev)
            gen = torch.Generator().manual_seed(seed + 1)
            params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
                      if "bias" in k else v for k, v in params.items()}
        prefix = ("params/inner/" if any("/inner/" in k for k in params)
                  else "params/")
        ws = k2.expand_gcnn_params(params, 3, model_kw["complex_params"],
                                   prefix)
        shape = model_kw["lattice_shape"]
        x = init_walkers(prng_key(seed + 2), batch, shape[0] * shape[1],
                         sector="sz0", device=dev)
        kw = dict(lattice_shape=shape, channels=tuple(model_kw["channels"]),
                  kernel_size=3,
                  activation=model_kw.get("activation", "lncosh"),
                  residual=model_kw.get("residual", False))
        return ws, x, kw

    main_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                   complex_params=True, param_scale=0.05)
    d12 = params_from_jax(load_checkpoint_params(
        str(here / "runs" / "j1j2_8x8_d12_fix.csv.params.npz")), dev)
    d12_kw = dict(lattice_shape=(8, 8), channels=(10,) * 12,
                  complex_params=True, activation="selu", residual=True)
    shapes = {"e_loc_chunk": (case(main_kw, 256 * 256 * 2, 26), 5),
              "sweep": (case(main_kw, 1024 * 2, 27), 30),
              "d12": (case(d12_kw, 512, 22, params=d12), 20)}
    r2_kw = dict(lattice_shape=(8, 8), channels=(10,) * 8,
                 complex_params=True, activation="selu", residual=True,
                 param_scale=1.0, init_mode="fan_in")
    bf16_shapes = {"bf16_e_loc_chunk": (case(r2_kw, 256 * 256 * 2, 45), 5),
                   "bf16_sweep": (case(r2_kw, 1024 * 2, 46), 30),
                   "bf16_d12": (shapes["d12"][0], 20)}
    rec = {"tree": root, "device": torch.cuda.get_device_name(0),
           "build_s": build_s}
    for name, ((ws, x, kw), reps) in shapes.items():
        got = k2.gcnn_group_sums(x, ws, **kw)
        want = k2.gcnn_group_sums_reference(x, ws, **kw)
        rec[f"{name}_max_abs_err"] = max(
            float((got.re - want.re).abs().max()),
            float((got.im - want.im).abs().max()))
        rec[f"{name}_ms"] = _cuda_ms(
            lambda: k2.gcnn_group_sums(x, ws, **kw), reps)
        del got, want
    for name, ((ws, x, kw), reps) in bf16_shapes.items():
        kw = dict(kw, compute_dtype="bfloat16")
        got = k2.gcnn_group_sums(x, ws, **kw)
        want = k2.gcnn_group_sums_reference(x, ws, **kw)
        size = 1.0 + torch.maximum(want.re.abs(), want.im.abs()).amax(dim=1)
        diffs = [(a - b) / size[:, None] for a, b in ((got.re, want.re),
                                                      (got.im, want.im))]
        rec[f"{name}_max_rel_err"] = max(float(d.abs().max()) for d in diffs)
        rec[f"{name}_mean_signed_rel_err"] = sum(
            float(d.mean()) for d in diffs) / 2
        rec[f"{name}_ms"] = _cuda_ms(
            lambda: k2.gcnn_group_sums(x, ws, **kw), reps)
        del got, want, diffs

    for label, name in (("step", "j1j2_8x8_gcnn"),
                        ("r2_step", "j1j2_8x8_gcnn_r2")):
        cfg = configs.load(str(here / "configs" / f"{name}.yaml"), ())
        vmc, params, _ = build(cfg, device=dev)
        m = cfg.sampler.n_walkers
        key = prng_key(cfg.run.seed + 100)
        ids = torch.arange(m, device=dev)
        state = vmc.init_state(fold_in(key, 0), m, params, device=dev)
        state = vmc.thermalize(state, fold_in(key, 1), ids, 20)
        step = step_split(vmc, state, 3)
        rec.update({f"{label}_{k}_ms": v for k, v in step.items()})
        rec[f"{label}_total_ms"] = sum(step.values())
    return rec


def _run_tree(tree: Path, script: Path, mark: str) -> dict:
    """``_worker`` of the module file ``script`` in a subprocess that
    imports ``qmcnn_tpu_torch`` from ``tree``; returns its record."""
    code = ("import sys, importlib.util as u; sys.path.insert(0, sys.argv[1]);"
            " s = u.spec_from_file_location('_ab_worker', sys.argv[2]);"
            " m = u.module_from_spec(s); s.loader.exec_module(m);"
            " print(m.MARK + m.json.dumps(m._worker(sys.argv[1])))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tree), str(script)],
        cwd=tree, env=env, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(mark):
            return json.loads(line[len(mark):])
    raise RuntimeError(f"run in {tree} failed ({proc.returncode}):\n"
                       f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")


def run_ab(argv, script: Path, mark: str, description: str) -> int:
    """The command line of an A/B script whose module file ``script``
    defines ``MARK`` (= ``mark``), ``json`` and ``_worker(root) -> dict``:
    one worker run per ``--tree``, in order, then the means per tree."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--tree", action="append", required=True,
                   help="a source tree holding qmcnn_tpu_torch/ (repeat, in "
                        "the order to run, e.g. A B B A)")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    runs = []
    for tree in args.tree:
        rec = _run_tree(Path(tree).resolve(), script, mark)
        runs.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    means = {}
    for rec in runs:
        keys = [k for k, v in rec.items() if isinstance(v, float)]
        agg = means.setdefault(rec["tree"], {k: [] for k in keys})
        for k in keys:
            agg[k].append(rec[k])
    print(json.dumps({"mean": {t: {k: sum(v) / len(v) for k, v in d.items()}
                               for t, d in means.items()}}))
    return 0


def main(argv=None) -> int:
    return run_ab(argv, Path(__file__).resolve(), MARK,
                  __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
