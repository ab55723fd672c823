"""The ARNN configuration (``configs/j1j2_10x10_arnn.json``) and its
reference (``reference/kinds/arnn.py``) on the CPU: the cell, the layout
against the program's init at the published widths, the parameter and
work counts, the kind's imports, and the readers of the trunk's and the
direct pass's spans. The port against the reference at small sizes is
``tests/test_torch_arnn_pixelcnn.py``.

  python -m pytest -p no:cacheprovider benchmark/tests/test_bench_arnn.py
"""
import os

import pytest
import torch

from benchmark import calibrate, check, spec
from benchmark.counts import flops, peaks
from benchmark.reference import models
from benchmark.tests.test_bench_imports import _modules_after

CELL = "j1j2_10x10_arnn.train"
#: the per-layer metrics this configuration brings, each read from the
#: program's spans
NEW = ("direct_ms.train", "arnn_ms.train", "arnn_roofline.train")
#: a forward's least work: the taps that read inside the 10 x 10 lattice,
#: 442 of a mask-B layer's 500 (the row above misses 10 sites on each of
#: its 3 taps, its corner taps and the left tap 9 or 10 more) for 9 layers
#: at 48 x 48, 342 of the mask-A layer's 400 at 1 x 48, and the head's
#: 48 x 3 at 100 sites
FORWARD_FLOP = 2 * (9 * 442 * 48 * 48 + 342 * 48 + 100 * 48 * 3)


def test_published_widths():
    """The layout is the program's init at the recipe's widths (ten
    layers of 48 channels, 3x3 kernels, three heads), and the counts are
    those worked out by hand: 187,683 parameters (480 + 9 x 20,784 +
    147), 18,392,256 FLOPs a configuration."""
    from benchmark.drivers import common
    from qmcnn_tpu_torch.builder import build_lattice, build_model

    cfg = spec.cell(CELL)["config"]
    m = cfg["model"]
    assert m["channels"] == [48] * 10 and m["arnn_conv_kernel"] == 3
    assert (m["activation"], m["complex_params"], m["arnn_sector"]) == (
        "selu", True, "sz0")
    assert cfg["lattice"]["shape"] == [10, 10]
    assert (cfg["sampler"]["kind"], cfg["sampler"]["n_walkers"]) == (
        "direct", 2048)
    layout = models.param_layout(cfg)
    program = common.program_config(cfg)
    model = build_model(program, build_lattice(program))
    init = model.init(0)
    assert list(layout) == sorted(init)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: shape for k, (shape, _) in layout.items()}
    # the init rule: each kernel at 1 / sqrt(its unmasked fan in)
    assert layout["params/conv0"][1] == pytest.approx(0.5)
    assert layout["params/conv1"][1] == pytest.approx(240 ** -0.5)
    assert layout["params/conv_out"][1] == pytest.approx(48 ** -0.5)
    for key, (_, std) in layout.items():
        if "/cb" in key:
            assert std == 0.0
        else:
            assert float(init[key].std()) == pytest.approx(std, rel=0.1)
    assert flops.n_params(cfg) == 187_683
    assert flops.forward_flop(cfg) == FORWARD_FLOP == 18_392_256


def test_the_cell_resolves():
    cell = spec.cell(CELL)
    assert cell["workload"]["chips"] == 1
    assert cell["traffic"]["driver"] == "train"
    assert cell["config"]["model"]["kind"] == "arnn"
    assert cell["weight_std"] is None
    assert cell["limits"]
    per_layer = {m["name"] for m in cell["per_layer"]}
    assert set(NEW) <= per_layer
    assert {"mfu.train", "device_idle.train", "e_loc_ms.train",
            "jacobian_ms.train", "sampler_ms.train", "sr_ms.train",
            "gradient_ms.train"} <= per_layer
    assert {m["name"] for m in cell["end_to_end"]} == {"step_ms", "setup_s"}
    meta = cell["config_meta"]
    assert meta["reduced"] == []
    assert any(a.startswith("model.channels") for a in meta["assumed"])


def test_reference_kind_imports_nothing_of_the_program():
    assert os.path.exists(os.path.join(os.path.dirname(models.__file__),
                                       "kinds", "arnn.py"))
    mods = _modules_after("import benchmark.reference.models as m; "
                          "m.kind('arnn')")
    assert not mods & {"qmcnn_tpu_torch", "qmcnn_tpu", "jax", "jaxlib",
                       "flax"}


def test_reference_sector_and_normalization():
    """On a 2x4 lattice at the cell's other settings: every configuration
    outside S^z = 0 reads a forbidden branch, and sum |psi|^2 over the
    sector is 1."""
    import copy
    import itertools

    cfg = copy.deepcopy(spec.cell(CELL)["config"])
    cfg["lattice"]["shape"] = [2, 4]
    cfg["model"]["channels"] = [6, 6]
    params = models.make_params(cfg, 2 ** 31 + 5, "cpu")
    s = torch.tensor(list(itertools.product([-1.0, 1.0], repeat=8)))
    re, _ = models.log_psi(cfg, params, s)
    inside = s.sum(-1) == 0
    assert float(torch.exp(2 * re[inside].double()).sum()) == pytest.approx(
        1.0, abs=1e-5)
    assert bool((re[~inside] <= models.kind("arnn").FORBIDDEN / 2).all())


class FakeSpan:
    def __init__(self, name, ms):
        self.name, self._ms = name, ms

    def device_ms(self):
        return self._ms


def test_readers(monkeypatch):
    """The readers over recorded spans: ms per traced step, and the
    roofline share from the inputs' rows less the pass's m N conditional
    rows, plus 2 m; nothing where the program records no such span (a
    program older than the spans)."""
    from benchmark import program_spans

    cfg = spec.cell(CELL)["config"]
    m = 2048
    run = {"steps": 10, "traced_steps": [2, 4], "m": m, "cfg": cfg,
           "eval_rows": [m + m * 100 + 4e5] * 10}
    spans = [FakeSpan("sampler.direct", 300.0), FakeSpan("arnn.cond", 2.0),
             FakeSpan("arnn", 40.0), FakeSpan("sampler.direct", 500.0),
             FakeSpan("arnn", 800.0), FakeSpan("e_loc", 99.0)]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    read = {name: spec.reader(name) for name in NEW}
    assert read["direct_ms.train"](run) == 400.0
    assert read["arnn_ms.train"](run) == 420.0
    rows = 2 * (m + 4e5 + 2 * m)
    bound = peaks.roofline_seconds(rows * FORWARD_FLOP,
                                   rows * flops.forward_bytes(cfg),
                                   "float32")
    assert read["arnn_roofline.train"](run) == pytest.approx(
        100 * bound / 0.84)
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: [FakeSpan("e_loc", 99.0)])
    assert all(read[name](run) is None for name in NEW)
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert all(read[name](run) is None for name in NEW)
    assert all(read[name]({"samples": 3}) is None for name in NEW)


@pytest.mark.cuda
def test_control_is_not_correct():
    """On the card: the TF32 control fails the cell's limits, the program
    at the same seed passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    cell = spec.cell(CELL)
    got = calibrate.readings(cell, 2 ** 31 + 103, 0.5)
    limits = cell["limits"]
    assert check.verdict(got["program"], limits), got["program"]
    assert not check.verdict(dict(got["program"], **got["control"]),
                             limits), got["control"]
