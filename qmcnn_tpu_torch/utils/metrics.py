"""Metrics: autocorrelation-aware error bars and CSV/stdout logging (a copy
of ``qmcnn_tpu/utils/metrics.py``, same CSV columns)
(SURVEY.md R13 / N11, section 5 "Metrics / logging / observability").

MC energy traces are autocorrelated (walkers decorrelate over a few sweeps;
parameters move every step), so the naive stderr sqrt(var/M) underestimates
the error. ``binned_stderr`` implements the standard binning analysis: group
the series into bins of growing size until the stderr estimate plateaus.
"""
from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


def binned_stderr(series: np.ndarray, min_bins: int = 16) -> float:
    """Autocorrelation-aware standard error of the mean of a 1D series.

    Doubles the bin size while at least ``min_bins`` bins remain and returns
    the largest (i.e. most conservative, plateau) stderr seen.
    """
    x = np.asarray(series, dtype=np.float64)
    n = x.size
    if n < 2:
        return float("nan")
    best = x.std(ddof=1) / np.sqrt(n)
    size = 1
    while n // (2 * size) >= min_bins:
        size *= 2
        nb = n // size
        binned = x[: nb * size].reshape(nb, size).mean(axis=1)
        best = max(best, binned.std(ddof=1) / np.sqrt(nb))
    return float(best)


def integrated_autocorr_time(series: np.ndarray) -> float:
    """tau_int estimate via the binning ratio (stderr_binned/stderr_naive)^2."""
    x = np.asarray(series, dtype=np.float64)
    if x.size < 4 or x.std() == 0:
        return 1.0
    naive = x.std(ddof=1) / np.sqrt(x.size)
    return float((binned_stderr(x) / naive) ** 2)


class MetricsLogger:
    """Streams per-step metric dicts to stdout, CSV, and (optionally)
    TensorBoard (guarded import — tensorflow is present in this image but
    the dependency stays optional)."""

    def __init__(self, csv_path: Optional[str] = None,
                 print_every: int = 10, stream=None,
                 tensorboard_dir: Optional[str] = None,
                 append: bool = False):
        self.csv_path = csv_path
        #: continue an existing CSV instead of truncating it — set on
        #: checkpoint resume so a supervisor restart doesn't discard the
        #: earlier attempt's rows (columns follow the existing header)
        self.append = append
        self.print_every = print_every
        self.stream = stream or sys.stdout
        self._writer = None
        self._file = None
        self._fields = None
        self._t0 = time.perf_counter()
        self.history: Dict[str, list] = {}
        self._tb = None
        if tensorboard_dir:
            try:
                import tensorflow as tf  # noqa: PLC0415

                self._tb = tf.summary.create_file_writer(tensorboard_dir)
            except Exception as e:  # pragma: no cover - optional dep
                print(f"# tensorboard unavailable: {e}", file=self.stream)

    def log(self, step: int, metrics: Dict[str, float]):
        row = {"step": step,
               "wall_time": round(time.perf_counter() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        for k, v in row.items():
            self.history.setdefault(k, []).append(v)
        if self.csv_path:
            if self._writer is None:
                os.makedirs(os.path.dirname(self.csv_path) or ".",
                            exist_ok=True)
                prior_fields = None
                if self.append and os.path.exists(self.csv_path):
                    with open(self.csv_path, newline="") as f:
                        header = f.readline().strip()
                    if header:
                        prior_fields = header.split(",")
                self._file = open(self.csv_path,
                                  "a" if prior_fields else "w", newline="")
                self._fields = prior_fields or list(row)
                self._writer = csv.DictWriter(self._file,
                                              fieldnames=self._fields)
                if not prior_fields:
                    self._writer.writeheader()
            self._writer.writerow({k: row.get(k) for k in self._fields})
            self._file.flush()
        if self._tb is not None:
            import tensorflow as tf  # noqa: PLC0415

            with self._tb.as_default():
                for k, v in row.items():
                    if k != "step":
                        tf.summary.scalar(k, v, step=step)
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(
                f"{k}={v:+.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k not in ("wall_time",)
            )
            print(parts, file=self.stream, flush=True)

    def tail_energy(self, frac: float = 0.25) -> tuple[float, float]:
        """(mean, binned stderr) of the last ``frac`` of the energy trace."""
        e = np.asarray(self.history.get("energy_re", []))
        if e.size == 0:
            return float("nan"), float("nan")
        # keep >= 2 points when the trace has them, so the stderr is finite
        start = min(int(e.size * (1 - frac)), max(e.size - 2, 0))
        tail = e[start:]
        return float(tail.mean()), binned_stderr(tail)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None
