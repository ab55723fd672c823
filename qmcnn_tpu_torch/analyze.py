"""Post-run analysis CLI over metrics CSVs (run.csv_path), the port of
``qmcnn_tpu/analyze.py`` (host numpy only; no device):

  python -m qmcnn_tpu_torch.analyze runs/exp.csv [--tail 0.25] \
      [--n-sites 100]
  python -m qmcnn_tpu_torch.analyze runs/a.csv runs/b.csv ... --extrapolate

Single CSV: tail-mean energy with an autocorrelation-aware (binned)
error bar, the integrated autocorrelation time, and run health
aggregates. Complements the live logger (utils/metrics.py), which prints
the same tail estimate at run end — this works offline on any saved CSV.

Multiple CSVs + --extrapolate: zero-variance extrapolation. For a family
of ansaetze of increasing quality on the SAME system (wider/deeper nets),
E is asymptotically linear in the energy variance as var -> 0 (the exact
state has zero variance), so a weighted linear fit of the runs'
(var, E) tail means gives a better ground-state estimate than the best
single run — the standard NQS reporting trick.

--quench-spectrum: the CSVs are instead ``evolve --corr-csv`` artifacts;
extract the quench-spectroscopy omega(q) table (time-FFT of S(q, t) with
sub-bin peak refinement — ops/spectroscopy.py). --shape gives the
lattice torus (e.g. --shape 8,8); default: a chain over all columns.

  python -m qmcnn_tpu_torch.analyze runs/quench_corr.csv \
      --quench-spectrum --shape 8,8
"""
from __future__ import annotations

import argparse
import csv

import numpy as np

from qmcnn_tpu_torch.utils.metrics import (binned_stderr,
                                           integrated_autocorr_time)


def read_csv(path: str) -> dict:
    """Load a metrics CSV, dropping rows that don't parse in full.

    Killed writers leave truncated trailing lines (observed: a lone "5" —
    the first byte of a buffered row — at the end of a salvaged hero CSV),
    and resumed runs may repeat the header mid-file. Accepting a partial
    row into only the columns that happened to parse would silently
    misalign columns against each other, so a row is all-or-nothing.
    """
    cols: dict[str, list[float]] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            try:
                vals = {k: float(v) for k, v in row.items()}
            except (TypeError, ValueError):
                continue
            for k, v in vals.items():
                cols.setdefault(k, []).append(v)
    return {k: np.asarray(v) for k, v in cols.items()}


def _excursion_mask(x: np.ndarray, nsig: float = 5.0) -> np.ndarray:
    """True for rows within nsig robust-sigmas (1.4826*MAD) of the median.

    Transient excursions — a walker cloud briefly leaving the typical set,
    an SR blow-up the next steps recover from — inflate tail means and
    especially tail variances; a median/MAD gate removes them without
    touching equilibrium fluctuations (for Gaussian noise nsig=5 keeps
    ~99.99994% of honest rows)."""
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    if mad == 0.0:
        return np.ones(x.shape, dtype=bool)
    return np.abs(x - med) <= nsig * 1.4826 * mad


def analyze(cols: dict, tail: float = 0.25, n_sites: int | None = None,
            robust: bool = False) -> dict:
    e = cols.get("energy_re")
    if e is None or e.size == 0:
        raise ValueError("CSV has no energy_re column")
    lo = int(e.size * (1.0 - tail))
    t = e[lo:]
    keep = np.ones(t.shape, dtype=bool)
    if robust:
        # variance-matched tail: gate on BOTH energy and its variance so
        # the (var, E) point fed to --extrapolate reflects the same
        # equilibrium window in each coordinate
        keep &= _excursion_mask(t)
        if "energy_var" in cols and cols["energy_var"].size >= e.size:
            keep &= _excursion_mask(cols["energy_var"][lo:])
    out = {
        "steps": int(cols["step"][-1]) if "step" in cols else e.size,
        "rows": int(e.size),
        "tail_rows": int(keep.sum()),
        "tail_excluded": int(t.size - keep.sum()),
        "energy": float(t[keep].mean()),
        "energy_err": binned_stderr(t[keep]),
        "tau_int": integrated_autocorr_time(t[keep]),
    }
    if n_sites:
        out["e_per_site"] = out["energy"] / n_sites
        out["e_per_site_err"] = out["energy_err"] / n_sites
    for k in ("accept", "sweeps_per_sec", "energy_var"):
        if k in cols and cols[k].size:
            v = cols[k][-t.size:]
            out[f"{k}_mean"] = float(v[keep].mean() if v.size == t.size
                                     else v.mean())
    return out


def extrapolate_zero_variance(results: list) -> dict:
    """Weighted linear fit E(var) over per-run tail means; E at var = 0.

    Weights are 1/stderr^2. Returns intercept (the extrapolated energy),
    its fit standard error, and the slope. Needs >= 2 runs with distinct
    variances and valid 'energy_var_mean'.
    """
    pts = [(r["energy_var_mean"], r["energy"], r["energy_err"])
           for r in results if "energy_var_mean" in r]
    if len(pts) < 2:
        raise ValueError("--extrapolate needs >= 2 CSVs with energy_var")
    v, e, se = (np.asarray(x, dtype=np.float64) for x in zip(*pts))
    if np.ptp(v) <= 0:
        raise ValueError("variances are identical; nothing to extrapolate")
    w = 1.0 / np.clip(se, 1e-12, None) ** 2
    if len(pts) == 2:
        # exactly-determined line: polyfit(cov=True) needs n > order+1,
        # so propagate the two points' stderrs through the intercept
        # E0 = (e0*v1 - e1*v0) / (v1 - v0) analytically
        dv = v[1] - v[0]
        intercept = (e[0] * v[1] - e[1] * v[0]) / dv
        slope = (e[1] - e[0]) / dv
        err = float(np.hypot(se[0] * v[1] / dv, se[1] * v[0] / dv))
    else:
        (slope, intercept), cov = np.polyfit(v, e, 1, w=np.sqrt(w), cov=True)
        err = float(np.sqrt(cov[1, 1]))
    return {"energy0": float(intercept),
            "energy0_err": err,
            "slope": float(slope), "n_runs": len(pts)}


def quench_spectrum_cli(args) -> list:
    """--quench-spectrum: per corr CSV, print the omega(q) table."""
    from qmcnn_tpu_torch.ops.spectroscopy import (dominant_frequencies,
                                                  read_corr_csv)

    all_tables = []
    for path in args.csv_paths:
        times, corr = read_corr_csv(path)
        shape = (tuple(int(x) for x in args.shape.split(","))
                 if args.shape else (corr.shape[1],))
        table = dominant_frequencies(times, corr, shape, pad=args.pad)
        all_tables.append(table)
        if len(args.csv_paths) > 1:
            print(f"--- {path}")
        t_total = times[-1] - times[0]
        print(f"rows={times.size}  T={t_total:.3f}  "
              f"d_omega={2 * np.pi / t_total:.4f} "
              f"(pad x{args.pad})")
        shown = table if args.top is None else table[:args.top]
        print(f"{'k':>12}  {'q/pi':>18}  {'omega':>10}  {'power':>12}")
        for row in shown:
            qs = ",".join(f"{q / np.pi:.3f}" for q in row["q"])
            ks = ",".join(str(k) for k in row["k"])
            print(f"{ks:>12}  {qs:>18}  {row['omega']:>10.4f}  "
                  f"{row['power']:>12.4g}")
    return all_tables[0] if len(all_tables) == 1 else all_tables


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csv_paths", nargs="+")
    p.add_argument("--tail", type=float, default=0.25,
                   help="fraction of the trace to average (default 0.25)")
    p.add_argument("--n-sites", type=int, default=None,
                   help="report per-site energy too")
    p.add_argument("--extrapolate", action="store_true",
                   help="zero-variance extrapolation across the CSVs")
    p.add_argument("--robust-tail", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="median/MAD-gate transient excursions out of the "
                        "tail window (default: on with --extrapolate)")
    p.add_argument("--quench-spectrum", action="store_true",
                   help="treat the CSVs as evolve --corr-csv artifacts and "
                        "extract the omega(q) quench-spectroscopy table")
    p.add_argument("--shape", type=str, default=None,
                   help="lattice torus for --quench-spectrum, e.g. 8,8 "
                        "(default: chain over all columns)")
    p.add_argument("--pad", type=int, default=8,
                   help="FFT zero-padding factor for --quench-spectrum")
    p.add_argument("--top", type=int, default=None,
                   help="print only the N loudest modes (--quench-spectrum)")
    args = p.parse_args(argv)
    if args.quench_spectrum:
        return quench_spectrum_cli(args)
    robust = args.extrapolate if args.robust_tail is None else args.robust_tail
    results = []
    for path in args.csv_paths:
        r = analyze(read_csv(path), tail=args.tail, n_sites=args.n_sites,
                    robust=robust)
        results.append(r)
        if len(args.csv_paths) > 1:
            print(f"--- {path}")
        excl = (f", {r['tail_excluded']} excursion rows excluded"
                if r.get("tail_excluded") else "")
        print(f"rows={r['rows']} (tail {r['tail_rows']}{excl}), "
              f"last step {r['steps']}")
        print(f"energy = {r['energy']:.6f} +- {r['energy_err']:.6f}"
              f"  (tau_int ~ {r['tau_int']:.1f} logged steps)")
        if "e_per_site" in r:
            print(f"e/site = {r['e_per_site']:.6f} "
                  f"+- {r['e_per_site_err']:.6f}")
        extras = [f"{k[:-5]}={r[k]:.4g}" for k in
                  ("accept_mean", "sweeps_per_sec_mean", "energy_var_mean")
                  if k in r]
        if extras:
            print("tail means: " + "  ".join(extras))
    if args.extrapolate:
        x = extrapolate_zero_variance(results)
        print(f"zero-variance extrapolation over {x['n_runs']} runs: "
              f"E(var->0) = {x['energy0']:.6f} +- {x['energy0_err']:.6f} "
              f"(slope {x['slope']:.4g})")
        if args.n_sites:
            print(f"e/site(var->0) = {x['energy0'] / args.n_sites:.6f} "
                  f"+- {x['energy0_err'] / args.n_sites:.6f}")
        return results, x
    return results[0] if len(results) == 1 else results


if __name__ == "__main__":
    main()
