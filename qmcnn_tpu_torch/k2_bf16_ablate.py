"""Where the mma.sync bf16 GCNN kernel spent its time, by ablation, on one
CUDA card:

  git archive d995dc0 qmcnn_tpu_torch | tar -x -C .runs/parent
  python -m qmcnn_tpu_torch.k2_bf16_ablate --tree .runs/parent

Imports ``qmcnn_tpu_torch`` from ``--tree`` (a tree holding the
``mma.sync`` bf16 route that ``wgmma`` replaced), writes variants of its
``csrc/gcnn_forward.cu`` with parts of ``gcnn_forward_bf16_kernel`` removed
into the git-ignored ``.runs/k2_bf16_ablate/``, builds them together and
times each at the j1j2_8x8_gcnn_r2 E_loc chunk (131,072 configurations)
and sweep (2,048) shapes, twice in turns, in a subprocess that imports
the tree (as ``gcnn_ab``). A variant computes wrong sums (only its time
means anything); its saving against the kernel as it is is what the
removed part costs. Prints one JSON line: each round's ms and the means.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

MARK = "K2_BF16_ABLATE "

#: (old, new) text edits of the bf16 kernel, per variant
_EPILOGUE = [("""                activate<CPLX, ACT>(zr0, zi0);
                activate<CPLX, ACT>(zr1, zi1);
                zr0 = bf16_round(zr0);""", "                "),
             ("if (skip) {", "if (false) {")]
_STEP_SUMS = [("""              float pr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              float pi[4] = {0.0f, 0.0f, 0.0f, 0.0f};""",
               """              float (&pr)[4] = acc_re[r][c];
              float (&pi)[4] = acc_im[r][c];"""),
              ("""                acc_re[r][c][j] += pr[j];
                if (CPLX) acc_im[r][c][j] += pi[j];""", "")]
_B_LOADS = [("""          const size_t step =
              static_cast<size_t>(t * k_steps + ks) * n_col_tiles * 32;""",
             "          const size_t step = 0;")]
VARIANTS = {
    "as_it_is": [],
    "no_epilogue": _EPILOGUE,
    "no_step_sums": _STEP_SUMS,
    "b_hoisted": _B_LOADS,
    "no_layer_sync": [("""    }
    __syncthreads();
  }

  readout""", """    }
  }
  __syncthreads();

  readout""")],
    "mma_issue_only": _EPILOGUE + _STEP_SUMS + _B_LOADS,
    "lift_readout_only": [("for (int l = 1; l < n_layers; ++l) {",
                           "for (int l = 1; l < 1; ++l) {")],
}


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
    """The ablation run; ``qmcnn_tpu_torch`` must resolve to ``root``."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels.nvcc import build_library
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    tree = Path(root).resolve()
    if Path(k2.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {k2.__file__}, not the tree {tree}")
    source = k2.SOURCE.read_text()
    start = source.index("gcnn_forward_bf16_kernel(\n")
    end = source.index("template <bool CPLX, int ACT, int DT>")
    out = Path(__file__).resolve().parents[1] / ".runs" / "k2_bf16_ablate"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        body = source[start:end]
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{name}: the tree's bf16 kernel has no "
                                   f"{old.strip()[:60]!r}")
            body = body.replace(old, new)
        paths[name] = out / f"gcnn_{name}.cu"
        paths[name].write_text(source[:start] + body + source[end:])
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, (path for path, _ in
                                pool.map(build_library, paths.values()))))

    dev = "cuda"
    kw = dict(lattice_shape=(8, 8), channels=(10,) * 8, complex_params=True,
              activation="selu", residual=True, param_scale=1.0,
              init_mode="fan_in")
    shapes = {}
    for label, batch, seed, reps in (("e_loc_chunk", 131072, 45, 3),
                                     ("sweep", 2048, 46, 30)):
        params = LogPsiGCNN(**kw).init(seed, device=dev)
        gen = torch.Generator().manual_seed(seed + 1)
        params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
                  if "bias" in k else v for k, v in params.items()}
        ws = k2.expand_gcnn_params(params, 3, True)
        x = init_walkers(prng_key(seed + 2), batch, 64, sector="sz0",
                         device=dev)
        shapes[label] = (ws, x, reps)
    call = dict(lattice_shape=(8, 8), channels=(10,) * 8, kernel_size=3,
                activation="selu", residual=True, compute_dtype="bfloat16")
    runs = {}
    for _ in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.gcnn_forward_launch.argtypes = [vp] * 9 + [ci] * 13 + [vp]
            lib.gcnn_forward_launch.restype = ci
            k2._LIB["gcnn"] = lib
            for label, (ws, x, reps) in shapes.items():
                runs.setdefault(f"{name}/{label}_ms", []).append(_cuda_ms(
                    lambda: k2.gcnn_group_sums(x, ws, **call), reps))
    return {"tree": root, "device": torch.cuda.get_device_name(0),
            "rounds": runs,
            "mean": {k: sum(v) / len(v) for k, v in runs.items()}}


def main(argv=None) -> int:
    from qmcnn_tpu_torch.gcnn_ab import _run_tree

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", required=True,
                   help="a source tree holding the mma.sync bf16 route's "
                        "qmcnn_tpu_torch/ (e.g. commit d995dc0)")
    args = p.parse_args(argv)
    print(json.dumps(_run_tree(Path(args.tree).resolve(),
                               Path(__file__).resolve(), MARK)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
