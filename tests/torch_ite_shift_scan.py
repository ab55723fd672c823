"""Imaginary-time TDVP of tfim16_sgd at full width (N = 16, C = [12, 12],
k = 5; a full sum over the 65,536 states, the dense solve, Heun) from the
fresh init, at several diag_shifts: the energy by step and its largest
rise, in the port and, with ``--jax``, in the JAX package on the CPU
(from its own init; E_loc and the Jacobian in chunks of 8,192 rows to
bound the host memory, the same sums).

  python tests/torch_ite_shift_scan.py --device cuda [--shifts 1e-4 1e-3]
      [--dt 0.05] [--steps 40]
  JAX_PLATFORMS=cpu python tests/torch_ite_shift_scan.py --jax --steps 6

A diagnostic, not a test: the first Heun step from a near-product state
meets a nearly singular S, and whether it overshoots depends on the
shift and on the init (chip_smoke.py's leg (b) runs at the shift where
both packages descend every step). The port run takes ~2 s a shift on an
H100; the JAX run ~12 s a step on one busy CPU.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFIG = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")


def report(label: str, e) -> None:
    e = np.asarray(e, np.float64)
    rise = np.diff(e)
    k = int(rise.argmax())
    print(f"{label}: E {e[0]:.6f} -> {e[-1]:.6f} in {e.size} steps, "
          f"largest change {rise[k]:+.4e} (step {k + 1} -> {k + 2}), "
          f"rises {int((rise > 1e-6 * np.abs(e[1:])).sum())}; E by step "
          f"{np.round(e[:8], 4).tolist()}", flush=True)


def port_run(shift: float, dt: float, steps: int, device: str) -> list:
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.evolve import evolve

    cfg = configs.load(CONFIG)
    with contextlib.redirect_stdout(io.StringIO()):
        _, logger = evolve(cfg, mode="imag", dt=dt, n_steps=steps,
                           solver="dense", diag_shift=shift,
                           integrator="heun", sampling="fullsum",
                           device=device)
    return logger.history["energy_re"]


def jax_run(shift: float, dt: float, steps: int) -> list:
    import csv

    import jax

    jax.config.update("jax_platforms", "cpu")
    from qmcnn_tpu import configs
    from qmcnn_tpu.evolve import evolve

    cfg = configs.load(CONFIG, ("run.chunk_size=8192",
                                "sr.jacobian_chunk=8192"))
    path = os.path.join(tempfile.mkdtemp(), "ite.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        evolve(cfg, mode="imag", dt=dt, n_steps=steps, solver="dense",
               diag_shift=shift, integrator="heun", sampling="fullsum",
               csv_path=path, log_every=1)
    with open(path, newline="") as f:
        return [float(r["energy_re"]) for r in csv.DictReader(f)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shifts", type=float, nargs="+",
                   default=[1e-4, 1e-3, 1e-2])
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default="cuda")
    p.add_argument("--jax", action="store_true",
                   help="run the JAX package on the CPU instead")
    args = p.parse_args(argv)
    for shift in args.shifts:
        if args.jax:
            report(f"JAX (CPU) diag_shift {shift:g}, dt {args.dt:g}",
                   jax_run(shift, args.dt, args.steps))
        else:
            report(f"port ({args.device}) diag_shift {shift:g}, dt "
                   f"{args.dt:g}", port_run(shift, args.dt, args.steps,
                                            args.device))


if __name__ == "__main__":
    main()
