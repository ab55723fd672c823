"""Export trained parameters as a git-committable .npz snapshot (port of
``qmcnn_tpu/export.py``).

  python -m qmcnn_tpu_torch.export --ckpt-dir runs/hero_ckpt \
      --out runs/hero_params.npz [--step N] [--field ema]

The source is a port checkpoint directory (``utils/checkpoint.py``, one
``torch.save`` file per step; git-ignored, it dies with the machine) or an
existing ``.npz`` to re-export. The output is the JAX package's flat
{key-path: array} npz (``utils/transfer.params_to_jax``), a few hundred KB
for the largest model in the suite, so it can be committed; either
package's ``run.init_from`` accepts it directly.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from qmcnn_tpu_torch.utils.transfer import load_checkpoint_params


def export_params(source: str, out: str, step: Optional[int] = None,
                  field: str = "params") -> dict:
    """Read the ``field`` params of ``source`` and savez them flat."""
    if not out.endswith(".npz"):
        raise ValueError(f"--out must end in .npz, got {out!r}")
    flat = load_checkpoint_params(source, step=step, field=field)
    if not flat:
        raise ValueError(f"no parameter leaves found in {source}")
    np.savez(out, **flat)
    n_bytes = sum(v.nbytes for v in flat.values())
    print(f"exported {len(flat)} leaves ({n_bytes / 1e6:.2f} MB of "
          f"{field!r}) from {source} -> {out}")
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint directory (or an existing .npz to "
                        "re-export)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--field", default="params", choices=["params", "ema"],
                   help="subtree to export (ema = the Polyak average of "
                        "an optimizer.ema_decay run)")
    args = p.parse_args(argv)
    export_params(args.ckpt_dir, args.out, step=args.step, field=args.field)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
