"""pcg's stopping margins under walker sharding, 1 rank against n.

  python tests/torch_pcg_margins.py [--device cpu|cuda:0] [--walkers M]
      [--sweeps S] [--steps K] [--ranks N]

Trains heis10x10_sr from ``runs/ab_cnn_float32.csv.params.npz``, tempered
at (1.0, 0.7, 0.45), for S thermalization sweeps and K steps with M
physical walkers (pcg, cg_tol 1e-4), once in this process on all walkers
and once in N gloo ranks (``tests/torch_dist_ranks.py ... pcg``; on a
card every rank shares it), and prints per step and pcg iteration the
residual rr = ||r||^2 and the stopping threshold atol2 = (tol ||b||)^2
that each run's loop test read, with the relative margin (rr - atol2) /
atol2, the iteration counts, and whether the walkers and params are
bitwise equal; with ``--split-mean`` the same for a third run in this
process whose S matvec takes its walker mean as two half-means (the
summation order of 2 ranks, with no collective), and whether a repeat of
the 1-rank run is bitwise the same. It also holds step 1's gradient
difference b_n - b_1 against -dE <O>, the shift that the energy's
rounding dE makes through the uncentered scores O. The last line is one
JSON object with the same numbers.

The loop values come from ``qmcnn_tpu_torch.sr._agreed``, wrapped in the
rank processes (``run_pcg_trace``); ``sr.py`` itself is unchanged.
Imports torch and the port only, never JAX.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tests import torch_dist_ranks as R  # noqa: E402

FIXTURE = os.path.join(ROOT, "runs", "ab_cnn_float32.csv.params.npz")
BETAS = "[1.0,0.7,0.45]"


def overrides(walkers: int, sweeps: int, steps: int) -> list:
    return [f"run.init_from={FIXTURE}", f"sampler.tempering_betas={BETAS}",
            f"sampler.n_walkers={walkers}", f"sampler.n_therm_sweeps={sweeps}",
            f"run.n_steps={steps}", "run.csv_path=null"]


def iterations(trace: torch.Tensor) -> list:
    """[(k, rr, atol2)] for k = 0 (before the loop) and each iteration."""
    atol2 = float(trace[0, 0])
    return [(k, float(row[1]), atol2) for k, row in enumerate(trace)]


def gradient_shift(ref: dict, ranks: list, device) -> dict:
    """Step 1's gradient b = Re mean(O* (E_loc - E)) against the energy's
    rounding: the n-rank run's E differs from the 1-rank run's by dE (a
    mean of means rounds otherwise), which moves b by -dE <O> since O is
    not centered. Returns |b_n - b_1| / |b_1|, and the cosine and norm
    ratio of b_n - b_1 against -dE <O> (<O> of the 1-rank run's model on
    step 1's walkers, before the update)."""
    from qmcnn_tpu_torch import builder as tb
    from qmcnn_tpu_torch import configs as tcfg
    from qmcnn_tpu_torch.sr import materialize_jacobian, ravel

    cfg = tcfg.load(R.HEIS, tuple(ref["overrides"]))
    vmc, _, _ = tb.build(cfg, device=device)
    want, got = ref["steps"][0], ranks[0]["steps"][0]
    r = vmc.sampler.n_replicas
    params = {k: v.to(device) for k, v in ref["params0"].items()}
    s = want["s"][::r].to(device)
    j_re, _, _ = materialize_jacobian(vmc.log_psi_fn, params, s,
                                      chunk_size=256)
    o_bar = j_re.mean(dim=0).double().cpu()
    d_e = got["energy_re"] - want["energy_re"]
    diff = (got["b"] - want["b"]).double()
    pred = -d_e * o_bar
    return {"energy_diff": d_e,
            "b_rel_diff": float(diff.norm() / want["b"].double().norm()),
            "o_bar_norm": float(o_bar.norm()),
            "cosine": float(diff @ pred / (diff.norm() * pred.norm())),
            "norm_ratio": float(diff.norm() / pred.norm())}


def compare(ref: dict, ranks: list) -> dict:
    """Per step: both runs' iteration counts and loop values, the margins,
    and whether walkers and params agree bitwise."""
    steps = []
    for i, want in enumerate(ref["steps"]):
        got = [rk["steps"][i] for rk in ranks]
        one, many = iterations(want["trace"]), iterations(got[0]["trace"])
        rows = []
        for k in range(max(len(one), len(many))):
            row = {"k": k}
            for name, it in (("1rank", one), ("nrank", many)):
                if k < len(it):
                    _, rr, atol2 = it[k]
                    row[name] = {"rr": rr, "atol2": atol2,
                                 "margin": (rr - atol2) / atol2}
            rows.append(row)
        first = next((k for k, (a, b) in enumerate(zip(one, many))
                      if a[1] != b[1]), None)
        s_eq = torch.equal(torch.cat([g["s"] for g in got]), want["s"])
        p_eq = all(torch.equal(got[0]["params"][k], v)
                   for k, v in want["params"].items())
        p_diff = max(float((got[0]["params"][k] - v).abs().max())
                     for k, v in want["params"].items())
        steps.append({"step": i + 1, "sr_iters_1rank": want["sr_iters"],
                      "sr_iters_nrank": got[0]["sr_iters"],
                      "walkers_bitwise": s_eq, "params_bitwise": p_eq,
                      "params_max_abs_diff": p_diff,
                      "first_differing_k": first,
                      "energy_1rank": want["energy_re"],
                      "energy_nrank": got[0]["energy_re"], "loop": rows})
    therm_eq = torch.equal(torch.cat([rk["s_therm"] for rk in ranks]),
                           ref["s_therm"])
    return {"walkers_bitwise_after_therm": therm_eq, "steps": steps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--walkers", type=int, default=256)
    p.add_argument("--sweeps", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--split-mean", action="store_true",
                   help="also run 1 rank with the S matvec's walker mean "
                        "taken as two half-means (2 ranks' summation order, "
                        "no collective) and print its counts and margins")
    args = p.parse_args(argv)
    spec = {"overrides": overrides(args.walkers, args.sweeps, args.steps),
            "device": args.device}
    work = tempfile.mkdtemp(prefix="pcg_margins_")
    try:
        torch.save(spec, os.path.join(work, "spec.pt"))
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"),
             str(r), str(args.ranks), work, "pcg"], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(args.ranks)]
        try:
            ref = dict(R.run_pcg_trace(spec, None),
                       overrides=spec["overrides"])
            for r, proc in enumerate(procs):
                log, _ = proc.communicate(timeout=3000)
                if proc.returncode != 0:
                    print(f"rank {r} failed (rc {proc.returncode}):\n"
                          f"{log[-3000:]}", file=sys.stderr)
                    return 1
        finally:  # no rank outlives a failure
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=True) for r in range(args.ranks)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = compare(ref, ranks)
    out["gradient_shift"] = gradient_shift(ref, ranks, args.device)
    if args.split_mean:
        split = R.run_pcg_trace(dict(spec, split_mean=True), None)
        out["split_mean"] = compare(ref, [split])
        again = compare(ref, [R.run_pcg_trace(spec, None)])
        out["repeat_bitwise"] = all(
            st["first_differing_k"] is None and st["params_bitwise"]
            for st in again["steps"])
    out.update(device=args.device, walkers=args.walkers, sweeps=args.sweeps,
               ranks=args.ranks)
    print(f"heis10x10_sr tempered {BETAS}, M={args.walkers}, {args.sweeps} "
          f"sweeps, 1 rank against {args.ranks} on {args.device}; walkers "
          f"bitwise after thermalization: {out['walkers_bitwise_after_therm']}")
    g = out["gradient_shift"]
    print(f"step 1's gradient b: {args.ranks} ranks against 1 differ by "
          f"{g['b_rel_diff']:.3e} of |b|; E differs by {g['energy_diff']!r}, "
          f"|<O>| {g['o_bar_norm']:.4g}; b_n - b_1 against -dE <O>: cosine "
          f"{g['cosine']:.6f}, norm ratio {g['norm_ratio']:.6f}")
    report(out, f"{args.ranks} ranks")
    if args.split_mean:
        print(f"1 rank repeated: loop values and params bitwise "
              f"{out['repeat_bitwise']}")
        print("1 rank against 1 rank with the matvec mean as two half-means:")
        report(out["split_mean"], "split mean")
    print(json.dumps(out))
    return 0


def report(out: dict, label: str) -> None:
    for st in out["steps"]:
        print(f"step {st['step']}: sr_iters {st['sr_iters_1rank']} / "
              f"{st['sr_iters_nrank']}, walkers bitwise "
              f"{st['walkers_bitwise']}, params bitwise "
              f"{st['params_bitwise']} (max abs diff "
              f"{st['params_max_abs_diff']:.3e}), E {st['energy_1rank']!r} / "
              f"{st['energy_nrank']!r}, rr first differs at k "
              f"{st['first_differing_k']}")
        for row in st["loop"]:
            cells = []
            for name in ("1rank", "nrank"):
                c = row.get(name)
                cells.append("-" if c is None else
                             f"rr {c['rr']:.9e} atol2 {c['atol2']:.9e} "
                             f"margin {c['margin']:+.3e}")
            print(f"  k {row['k']:3d}  1 rank: {cells[0]}  |  "
                  f"{label}: {cells[1]}")


if __name__ == "__main__":
    sys.exit(main())
