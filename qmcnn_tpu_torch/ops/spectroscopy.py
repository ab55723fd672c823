"""Quench spectroscopy: excitation frequencies omega(q) from the
equal-time correlation history C(r, t) logged by ``evolve --corr-csv`` (the
port's own copy of ``qmcnn_tpu/ops/spectroscopy.py``; numpy only).

After a sudden quench the equal-time structure factor

    S(q, t) = sum_r e^{-i q.r} C(r, t)

oscillates at the energy differences E_m - E_n of post-quench eigenstates
connected by the momentum-q density operator; for dilute quasiparticle
pairs the dominant line sits at the pair-creation frequency 2*eps(q).
Reading dispersions off this time series is standard "quench
spectroscopy" — it turns the t-VMC module into a spectroscope and
complements ``measure --sma`` (Feynman upper bounds at measurement time)
with real-time frequencies.

This is the host-side post-processor: demeaned, Hann-windowed,
zero-padded time FFT of S(q, t) per momentum, with parabolic (sub-bin)
peak refinement. Input: the ``--corr-csv`` artifact (header ``t,c0..``,
one translation-averaged C(r, t) row per logged step, row-major r over
``lattice.shape`` — evolve.py ``weighted_corr``).
"""
from __future__ import annotations

import csv
import warnings

import numpy as np


def read_corr_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a --corr-csv file -> (times [T], corr [T, N]).

    All-or-nothing per row (killed writers leave truncated trailing
    lines — same posture as analyze.read_csv).
    """
    times, rows = [], []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        n = len(header) - 1
        for row in reader:
            if len(row) != n + 1:
                continue
            try:
                vals = [float(v) for v in row]
            except ValueError:
                continue
            times.append(vals[0])
            rows.append(vals[1:])
    if not rows:
        raise ValueError(f"{path}: no complete correlation rows")
    t, c = np.asarray(times), np.asarray(rows)
    # a t-VMC run that hits its capacity limit NaNs from some step on
    # (e.g. the chain-12 full-sum quench blew up at t~1.8); the history
    # BEFORE the blowup is valid dynamics — keep it, drop the rest.
    finite = np.isfinite(c).all(axis=1) & np.isfinite(t)
    if not finite.all():
        cut = int(np.argmin(finite))  # first bad row
        if cut == 0:
            raise ValueError(f"{path}: correlation history is non-finite "
                             "from the first row")
        n_dropped = len(t) - cut
        n_later_finite = int(finite[cut:].sum())
        # a terminal blowup has no finite rows after the cut; a transient
        # glitch (e.g. one torn concurrent-write row) DOES — say which,
        # so a valid later history being discarded is visible
        glitch = ("; looks like a transient glitch, not a terminal blowup"
                  if n_later_finite else "")
        warnings.warn(
            f"{path}: non-finite correlation row at t={t[cut]:.6g} — "
            f"keeping the {cut} rows before it, dropping {n_dropped} "
            f"({n_later_finite} of the dropped rows are finite{glitch})",
            stacklevel=2)
        t, c = t[:cut], c[:cut]
    return t, c


def structure_factor_qt(corr: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """S(q, t) = sum_r e^{-i q.r} C(r, t) over the lattice torus.

    corr: [T, N] with r row-major over ``shape``. C(r) = C(-r) by
    construction (it is translation-averaged), so S(q, t) is real; the
    imaginary part is fp noise and is dropped.
    Returns [T, *shape] indexed by integer momentum k (q = 2*pi*k/L).
    """
    t_len = corr.shape[0]
    if int(np.prod(shape)) != corr.shape[1]:
        raise ValueError(f"shape {shape} does not match {corr.shape[1]} sites")
    grid = corr.reshape(t_len, *shape)
    axes = tuple(range(1, 1 + len(shape)))
    return np.real(np.fft.fftn(grid, axes=axes))


def quench_spectrum(times: np.ndarray, s_qt: np.ndarray, pad: int = 8,
                    min_omega: float | None = None) -> dict:
    """Windowed time-FFT of S(q, t) with sub-bin peak refinement.

    times must be uniform (the evolve logger writes every log_every
    steps). Each momentum trace is demeaned (the connected, oscillating
    part is the signal; the time mean is the diagonal ensemble value),
    Hann-windowed against leakage from the finite window, and zero-padded
    ``pad``-fold for dense peak interpolation; the per-q peak is then
    refined with a 3-point parabola on log power.

    min_omega guards the peak search against residual low-frequency
    leakage; default = 2.5 frequency-resolution elements 2*pi/T_total.

    Returns dict with omegas [W], power [*qshape, W], peak_omega
    [*qshape], peak_power [*qshape].
    """
    times = np.asarray(times, dtype=np.float64)
    if times.size < 8:
        raise ValueError("need >= 8 time samples for a spectrum")
    dts = np.diff(times)
    dt = float(np.median(dts))
    if not np.allclose(dts, dt, rtol=1e-3, atol=1e-9):
        # evolve force-writes the final row at it+1 == n_steps even when
        # it falls off the log_every grid — trim ONE off-grid trailing
        # row before giving up
        if times.size > 8 and np.allclose(dts[:-1], dt, rtol=1e-3,
                                          atol=1e-9):
            times = times[:-1]
            s_qt = s_qt[:-1]
        else:
            raise ValueError("time grid is not uniform; re-log with "
                             "fixed log_every")
    t_len = times.size
    qshape = s_qt.shape[1:]
    sig = s_qt - s_qt.mean(axis=0, keepdims=True)
    window = np.hanning(t_len)
    sig = sig * window.reshape((t_len,) + (1,) * len(qshape))
    n_fft = pad * t_len
    spec = np.fft.rfft(sig, n=n_fft, axis=0)
    power = np.moveaxis(np.abs(spec) ** 2, 0, -1)  # [*qshape, W]
    omegas = 2.0 * np.pi * np.fft.rfftfreq(n_fft, d=dt)
    if min_omega is None:
        min_omega = 2.5 * 2.0 * np.pi / (t_len * dt)
    k0 = int(np.searchsorted(omegas, min_omega))
    k0 = min(max(k0, 1), power.shape[-1] - 2)

    flat = power.reshape(-1, power.shape[-1])
    peak_w = np.empty(flat.shape[0])
    peak_p = np.empty(flat.shape[0])
    d_omega = omegas[1] - omegas[0]
    for i, p in enumerate(flat):
        k = k0 + int(np.argmax(p[k0:-1]))
        # parabolic refinement on log power (exact for a Gaussian line,
        # excellent for the Hann main lobe)
        lp = np.log(np.maximum(p[k - 1:k + 2], 1e-300))
        denom = lp[0] - 2.0 * lp[1] + lp[2]
        frac = 0.5 * (lp[0] - lp[2]) / denom if denom < 0 else 0.0
        peak_w[i] = omegas[k] + np.clip(frac, -0.5, 0.5) * d_omega
        peak_p[i] = p[k]
    return {
        "omegas": omegas,
        "power": power,
        "peak_omega": peak_w.reshape(qshape),
        "peak_power": peak_p.reshape(qshape),
    }


def dominant_frequencies(times: np.ndarray, corr: np.ndarray,
                         shape: tuple[int, ...], pad: int = 8,
                         min_omega: float | None = None) -> list[dict]:
    """End-to-end: corr history -> per-momentum dominant frequency table.

    Momenta come in +-q pairs with identical real spectra (C(r) = C(-r));
    one representative per {k, -k} pair is reported (the lexicographically
    smaller index tuple). ``q`` components are mapped to the symmetric
    zone (-pi, pi]. Entries are sorted by peak power so the physically
    loudest modes lead.
    """
    s_qt = structure_factor_qt(corr, shape)
    spec = quench_spectrum(times, s_qt, pad=pad, min_omega=min_omega)
    out = []
    seen = set()
    for k_idx in np.ndindex(*shape):
        neg = tuple((L - k) % L for k, L in zip(k_idx, shape))
        canon = min(k_idx, neg)
        if canon in seen:
            continue
        seen.add(canon)
        q = tuple(2.0 * np.pi * (k - L if k > L // 2 else k) / L
                  for k, L in zip(canon, shape))
        out.append({
            "k": canon,
            "q": q,
            "omega": float(spec["peak_omega"][canon]),
            "power": float(spec["peak_power"][canon]),
        })
    out.sort(key=lambda d: -d["power"])
    return out
