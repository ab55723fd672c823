"""Nothing a run loads has jax, jaxlib, flax or the JAX package qmcnn_tpu as
its top-level name (compared whole: qmcnn_tpu_torch is the port), and the
reference loads nothing of the port."""
import os
import subprocess
import sys
import textwrap

from benchmark import run as bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_are_compared_whole():
    assert bench.forbidden_modules(["qmcnn_tpu_torch", "qmcnn_tpu_torch.vmc",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert bench.forbidden_modules(["qmcnn_tpu.vmc", "jax.numpy", "jaxlib",
                                    "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                       "qmcnn_tpu"]


def _modules_after(code: str) -> set:
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        {code}
        print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program():
    kinds = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "benchmark", "reference", "kinds")) if f.endswith(".py"))
    lattices = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "benchmark", "reference", "lattices")) if f.endswith(".py"))
    assert "cnn" in kinds and "gcnn" in kinds
    assert "hypercubic" in lattices and "triangular" in lattices
    mods = _modules_after(
        "import benchmark.reference.models, benchmark.reference.vmc, "
        "benchmark.reference.estimators, benchmark.reference.hamiltonian, "
        "benchmark.counts.flops, benchmark.counts.peaks, "
        "benchmark.counts.idle; "
        f"[benchmark.reference.models.kind(k) for k in {kinds!r}]; "
        "[benchmark.reference.hamiltonian._lattice_file(g) for g in "
        f"{lattices!r}]")
    assert not mods & {"qmcnn_tpu_torch", "qmcnn_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_run_loads_no_jax():
    mods = _modules_after(textwrap.dedent("""
        import copy
        import torch
        torch.set_num_threads(1)
        from benchmark import run as bench, spec
        cell = copy.deepcopy(spec.cell("heis10x10_sr.train"))
        cell["config"]["lattice"]["shape"] = [4, 4]
        cell["config"]["model"]["channels"] = [2, 2]
        cell["config"]["sampler"].update(n_walkers=16, n_therm_sweeps=2)
        cell["config"]["run"]["steps_per_dispatch"] = 2
        cell["weight_std"] = None
        class A:
            seed, seconds, trace = 3, 0.1, 0
        bench.run_cell(A(), cell, device="cpu")
    """).replace("\n", "\n        "))
    assert "qmcnn_tpu_torch" in mods
    assert not mods & {"qmcnn_tpu", "jax", "jaxlib", "flax"}
