"""A model kind is one file of the harness, ``reference/kinds/<kind>.py``,
or ``<kind>_<geometry>.py`` off the hypercubic lattice (its weight layout,
reference forward and work count): a configuration of a new kind, or of a
kind on a new lattice, enters as new files and entries with no edit to the
harness's code, a kind or a lattice with no file is refused when the cell
is read, and the two kinds the benchmark runs draw the weights they drew
before they were files of their own.

  python -m pytest -p no:cacheprovider benchmark/tests/test_bench_kinds.py
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import spec
from benchmark.reference import models

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: a toy kind: log psi = sum_j lncosh(sum_i s_i W_ij + b_j)
DENSE = '''\
"""A dense lncosh layer (``model.kind: dense``)."""
import math

import torch

from benchmark.reference.models import _lncosh, precision


def layout(cfg):
    n = math.prod(cfg["lattice"]["shape"])
    h = int(cfg["model"]["hidden"])
    return {"params/Dense_0/bias": ((h,), 0.0),
            "params/Dense_0/kernel": ((n, h),
                                      float(cfg["model"]["param_scale"]))}


def log_psi(cfg, params, s, prec="f32"):
    with precision(prec):
        x = s.to(torch.float32) @ params["params/Dense_0/kernel"]
    re = _lncosh(x + params["params/Dense_0/bias"]).sum(-1)
    return re, torch.zeros_like(re)


def forward_flop(cfg):
    return 2.0 * math.prod(cfg["lattice"]["shape"]) * cfg["model"]["hidden"]
'''


def checkout(tmp_path, kind: str, geometries=("hypercubic",),
             **model) -> str:
    """A copy of the benchmark with one more configuration on each of
    ``geometries`` (the flagship's with ``model.kind`` = ``kind``;
    ``heis10x10_<kind>`` on the square lattice, ``<geometry>10x10_<kind>``
    on another, without Marshall signs) and its training cell, all added
    as new files and entries."""
    root = tmp_path / "checkout"
    if not root.exists():
        shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    for geometry in geometries:
        with open(root / "benchmark/configs/heis10x10_sr.json") as f:
            conf = json.load(f)
        conf["config"]["model"].update(kind=kind, **model)
        conf.pop("weight_std", None)
        name = f"heis10x10_{kind}"
        if geometry != "hypercubic":
            conf["config"]["lattice"]["geometry"] = geometry
            conf["config"]["hamiltonian"]["marshall"] = False
            name = f"{geometry}10x10_{kind}"
        with open(root / f"benchmark/configs/{name}.json", "w") as f:
            json.dump(conf, f)
        bench["configs"].append(dict(bench["configs"][0], name=name,
                                     file=f"benchmark/configs/{name}.json"))
        bench["workloads"].append({"name": f"{name}.train", "config": name,
                                   "traffic": "train", "chips": 1,
                                   "why": f"a {kind} model"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(root)


def tree(root: str) -> dict:
    """{path under benchmark/: sha256} of the files a checkout holds."""
    out = {}
    for d, dirs, files in os.walk(os.path.join(root, "benchmark")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_kind_is_one_new_file(tmp_path):
    root = checkout(tmp_path, "dense", hidden=24, param_scale=0.05)
    with open(os.path.join(root, "benchmark/reference/kinds/dense.py"),
              "w") as f:
        f.write(DENSE)
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {root!r})
        import torch
        torch.set_num_threads(1)
        from benchmark import spec
        from benchmark.counts import flops
        from benchmark.reference import models
        cell = spec.cell("heis10x10_dense.train")
        cfg = cell["config"]
        layout = models.param_layout(cfg)
        params = models.make_params(cfg, 2 ** 31 + 5, "cpu")
        s = torch.randint(0, 2, (10, 100),
                          generator=torch.Generator().manual_seed(1)) * 2.0 - 1
        re, im = models.log_psi_blocks(cfg, params, s, block=4)
        print(json.dumps({{
            "models": models.__file__,
            "layout": {{k: list(v[0]) for k, v in layout.items()}},
            "params": {{k: list(v.shape) for k, v in params.items()}},
            "finite": bool(torch.isfinite(re).all() and torch.isfinite(im).all()),
            "rows": re.shape[0],
            "n_params": flops.n_params(cfg),
            "forward_flop": flops.forward_flop(cfg),
            "step_flop": flops.step_flop(cfg, 64, 1000.0, 3000.0, 20),
        }}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["models"].startswith(root)
    shapes = {"params/Dense_0/bias": [24], "params/Dense_0/kernel": [100, 24]}
    assert got["layout"] == shapes
    assert got["params"] == shapes
    assert got["finite"] and got["rows"] == 10
    assert got["n_params"] == 100 * 24 + 24
    fwd = 2 * 100 * 24
    assert got["forward_flop"] == fwd
    # the flagship's traffic: pcg, a real log psi
    assert got["step_flop"] == ((64 + 1000 + 3000) * fwd + 3 * 64 * fwd
                                + 3 * 64 * fwd + 20 * 4 * 64 * 2424)
    # no file the benchmark had was edited
    mine, theirs = tree(root), tree(ROOT)
    assert {k: mine[k] for k in theirs} == theirs


def test_a_kind_with_no_file_is_refused(tmp_path):
    root = checkout(tmp_path, "nosuch")
    with pytest.raises(FileNotFoundError,
                       match="benchmark/reference/kinds/nosuch.py"):
        spec.cell("heis10x10_nosuch.train", root=root)


def test_a_kind_on_another_lattice_is_one_new_file(tmp_path):
    """A triangular configuration of the toy kind takes
    ``kinds/dense_triangular.py``; the square one keeps ``kinds/dense.py``;
    both enter as new files and entries only."""
    root = checkout(tmp_path, "dense", ("hypercubic", "triangular"),
                    hidden=24, param_scale=0.05)
    kinds = os.path.join(root, "benchmark/reference/kinds")
    with open(os.path.join(kinds, "dense.py"), "w") as f:
        f.write(DENSE)
    # the triangular file: the same toy, with twice the hidden units
    with open(os.path.join(kinds, "dense_triangular.py"), "w") as f:
        f.write(DENSE.replace('cfg["model"]["hidden"]',
                              '2 * cfg["model"]["hidden"]'))
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {root!r})
        import torch
        torch.set_num_threads(1)
        from benchmark import spec
        from benchmark.counts import flops
        from benchmark.reference import files, models
        out = {{}}
        for name in ("heis10x10_dense", "triangular10x10_dense"):
            cfg = spec.cell(name + ".train")["config"]
            params = models.make_params(cfg, 2 ** 31 + 5, "cpu")
            s = torch.randint(0, 2, (10, 100), generator=torch.Generator()
                              .manual_seed(1)) * 2.0 - 1
            re, _ = models.log_psi(cfg, params, s)
            out[name] = {{
                "path": files.kind_path(cfg),
                "file": models.kind_of(cfg).__file__,
                "kernel": list(params["params/Dense_0/kernel"].shape),
                "rows": re.shape[0],
                "n_sites": flops.n_sites(cfg),
                "forward_flop": flops.forward_flop(cfg),
            }}
        print(json.dumps(out))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    for name, stem, hidden in (("heis10x10_dense", "dense", 24),
                               ("triangular10x10_dense", "dense_triangular",
                                48)):
        assert got[name]["path"] == f"benchmark/reference/kinds/{stem}.py"
        assert got[name]["file"] == os.path.join(kinds, f"{stem}.py")
        assert got[name]["kernel"] == [100, hidden]
        assert got[name]["rows"] == 10 and got[name]["n_sites"] == 100
        assert got[name]["forward_flop"] == 2 * 100 * hidden
    # no file the benchmark had was edited
    mine, theirs = tree(root), tree(ROOT)
    assert {k: mine[k] for k in theirs} == theirs


def test_a_kind_with_no_file_on_another_lattice_is_refused(tmp_path):
    root = checkout(tmp_path, "dense", ("hypercubic", "triangular"),
                    hidden=24, param_scale=0.05)
    with open(os.path.join(root, "benchmark/reference/kinds/dense.py"),
              "w") as f:
        f.write(DENSE)
    spec.cell("heis10x10_dense.train", root=root)
    with pytest.raises(FileNotFoundError,
                       match="benchmark/reference/kinds/dense_triangular.py"):
        spec.cell("triangular10x10_dense.train", root=root)


def test_a_lattice_with_no_file_is_refused(tmp_path):
    root = checkout(tmp_path, "cnn", ("kagome",))
    with pytest.raises(FileNotFoundError,
                       match="benchmark/reference/lattices/kagome.py"):
        spec.cell("kagome10x10_cnn.train", root=root)


#: the layouts as the benchmark drew them before each kind was a file
HEIS = {
    "params/RealConv_0/bias": ((16,), 0.0),
    "params/RealConv_0/kernel": ((3, 3, 1, 16), 0.05),
    "params/RealConv_1/bias": ((16,), 0.0),
    "params/RealConv_1/kernel": ((3, 3, 16, 16), 0.05),
    "params/RealConv_2/bias": ((16,), 0.0),
    "params/RealConv_2/kernel": ((3, 3, 16, 16), 0.05),
}
GCNN = {}
for _i in range(8):
    for _p in ("im", "re"):
        GCNN[f"params/inner/GroupConv_{_i}/bias_{_p}"] = ((10,), 0.0)
        GCNN[f"params/inner/GroupConv_{_i}/kernel_{_p}"] = (
            ((3, 3, 1, 10), 0.23570226039551587) if _i == 0 else
            ((8, 3, 3, 10, 10), 0.026352313834736494) if _i < 7 else
            ((8, 3, 3, 10, 10), 3.682847818679935e-05))


@pytest.mark.parametrize("cell_name, layout, init, table", [
    ("heis10x10_sr.train", HEIS,
     "80eb7d99b9cb84af3d3426729cbf12f45b46ef17635f4278ddeb41fc6523b58f",
     "81919924dfe14bacfb06e5f359521d18a095d9a96cb5118d838bf7e482b83633"),
    ("j1j2_8x8_gcnn_r2.train", GCNN,
     "2676a71d9bf73b320edb3db4eec1f5c14a17a88664f0b14deaa7c9f3c03ae689",
     None),
])
def test_layouts_and_weights_are_as_before(cell_name, layout, init, table):
    cell = spec.cell(cell_name)
    cfg = cell["config"]
    assert models.param_layout(cfg) == layout
    assert list(models.param_layout(cfg)) == sorted(layout)
    # the sha256 of every leaf's key and float32 bytes in layout order, as
    # drawn on the CPU for one seed: by the init rule, and by the cell's
    # table of per-leaf deviations where it has one
    for std, expected in ((None, init), (cell["weight_std"], table)):
        if expected is None:
            assert std is None
            continue
        params = models.make_params(cfg, 2 ** 31 + 12345, "cpu", std)
        digest = hashlib.sha256()
        for key, value in params.items():
            digest.update(key.encode())
            digest.update(value.numpy().tobytes())
        assert digest.hexdigest() == expected
