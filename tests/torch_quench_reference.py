"""The chain-12 quench's references side by side: the exact Schrodinger
evolution of the snapshot's state (``chip_smoke.chain12_exact``), the JAX
run written on the TPU (runs/tvmc_chain12_quench.csv), the JAX package run
again on the CPU, and any port CSV (chip_smoke.py's leg (a) writes one to
``.runs/chip_smoke/tvmc_chain12_quench.csv``).

  JAX_PLATFORMS=cpu python tests/torch_quench_reference.py \\
      [--jax-steps 200] [--port-csv PATH ...]

prints, for each pair, the largest |d sx| and |d szsz_nn| over the rows to
t = 1.0 that both hold, and row 1's energy. ``--jax-steps N`` runs
``qmcnn_tpu.evolve`` on the CPU for N steps with scripts/r2_pipeline37.sh's
flags (about 2 s a step on one busy CPU; 0 skips it). A diagnostic, not a
test: it imports JAX only for that run.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

DT = 0.005


def exact_run() -> dict:
    """The exact evolution as a run logged every step."""
    ex = chip_smoke.chain12_exact(chip_smoke.CHAIN12_STEPS)
    ex["t"] = DT * np.arange(1, chip_smoke.CHAIN12_STEPS + 1)
    return ex


def jax_cpu_run(steps: int, path: str) -> None:
    """The JAX package's evolve on the CPU with the JAX run's flags."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qmcnn_tpu import configs
    from qmcnn_tpu.evolve import evolve

    cfg = configs.load(str(chip_smoke.TFIM16_CONFIG),
                       chip_smoke.CHAIN12_OVERRIDES)
    evolve(cfg, mode="real", dt=DT, n_steps=steps, solver="dense",
           diag_shift=1e-4, sampling="fullsum",
           init_from=str(chip_smoke.TFIM12_FIXTURE), csv_path=path,
           log_every=1)


def compare(a: dict, b: dict) -> tuple:
    """(rows, max |d sx|, max |d szsz_nn|) over the rows at t <= 1.0
    that both runs logged."""
    ka = {int(round(t / DT)): i for i, t in enumerate(a["t"])}
    kb = {int(round(t / DT)): i for i, t in enumerate(b["t"])}
    steps = sorted(k for k in ka.keys() & kb.keys() if k <= 200)
    ia, ib = [ka[k] for k in steps], [kb[k] for k in steps]
    return (len(steps),
            float(np.abs(a["sx"][ia] - b["sx"][ib]).max()),
            float(np.abs(a["szsz_nn"][ia] - b["szsz_nn"][ib]).max()))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--jax-steps", type=int, default=200)
    p.add_argument("--port-csv", action="append", default=[])
    args = p.parse_args(argv)
    runs = {"exact": exact_run(),
            "jax_tpu": chip_smoke.csv_columns(chip_smoke.CHAIN12_QUENCH)}
    if args.jax_steps:
        path = os.path.join(tempfile.mkdtemp(), "jax_cpu.csv")
        jax_cpu_run(args.jax_steps, path)
        runs["jax_cpu"] = chip_smoke.csv_columns(path)
    for i, path in enumerate(args.port_csv):
        runs[f"port{i}"] = chip_smoke.csv_columns(path)
    names = list(runs)
    out = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            rows, d_sx, d_zz = compare(runs[a], runs[b])
            out[(a, b)] = (rows, d_sx, d_zz)
            print(f"{a} vs {b}: {rows} rows to t = 1.0, max |d sx| "
                  f"{d_sx:.3e}, |d szsz_nn| {d_zz:.3e}; row 1 energy "
                  f"{runs[a]['energy_re'][0]:.7f} vs "
                  f"{runs[b]['energy_re'][0]:.7f}")
    return out


if __name__ == "__main__":
    main()
