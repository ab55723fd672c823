"""The harness is driven by data: a new configuration, traffic mix, cell,
limits and per-layer metric are new files and entries, found by name with
no edit to the harness's code."""
import json
import os
import shutil

from benchmark import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_every_cell_of_the_benchmark_resolves():
    bench = spec.benchmark()
    for work in bench["workloads"]:
        cell = spec.cell(work["name"])
        assert cell["traffic"]["driver"] in ("train", "measure")
        assert cell["limits"], work["name"]
        names = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.reader(m["name"]))


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    # a new configuration, traffic mix and cell
    with open(root / "benchmark/configs/heis10x10_sr.json") as f:
        conf = json.load(f)
    conf["config"]["sampler"]["n_walkers"] = 8192
    with open(root / "benchmark/configs/heis10x10_m8192.json", "w") as f:
        json.dump(conf, f)
    with open(root / "benchmark/traffic/train-long.json", "w") as f:
        json.dump({"driver": "train", "start_step": 400, "check_steps": 2},
                  f)
    with open(root / "benchmark/limits/heis10x10_m8192.train-long.json",
              "w") as f:
        json.dump({"limits": {"loss": 1e-5}}, f)
    (root / "benchmark/metrics/walkers_k.train.py").write_text(
        "def read(run):\n    return run['m'] / 1000.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="heis10x10_m8192",
                                 file="benchmark/configs/heis10x10_m8192.json"))
    bench["workloads"].append({"name": "heis10x10_m8192.train-long",
                               "config": "heis10x10_m8192",
                               "traffic": "train-long", "chips": 1,
                               "why": "weak scaling"})
    bench["per_layer"].append({"name": "walkers_k.train", "unit": "k",
                               "better": "higher", "source": "host_clock",
                               "layer": "sampler", "moves": "step_ms",
                               "workloads": ["heis10x10_m8192.train-long"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = spec.cell("heis10x10_m8192.train-long", root=str(root))
    assert cell["config"]["sampler"]["n_walkers"] == 8192
    assert cell["traffic"]["start_step"] == 400
    assert cell["limits"] == {"loss": 1e-5}
    assert [m["name"] for m in cell["per_layer"]] == ["walkers_k.train"]
    got = spec.read_metrics(cell["per_layer"], {"m": 8192}, str(root))
    assert got == {"walkers_k.train": {"value": 8.192, "unit": "k"}}
    # a metric whose reader finds nothing is left out
    assert spec.read_metrics(
        [m for m in bench["per_layer"] if m["name"] == "k1_roofline.train"],
        {"steps": 1}, str(root)) == {}
