"""The ViT configuration (``configs/j1j2_10x10_vit.json``) and its
reference (``reference/kinds/vit.py``) against the program's
``LogPsiViT`` on the CPU: the forward at a small size, the layout, the
parameter and work counts at the published widths, the cell, and the
readers of the trunk's spans.

  python -m pytest -p no:cacheprovider benchmark/tests/test_bench_vit.py
"""
import copy
import math
import os

import pytest
import torch

from benchmark import calibrate, check, spec
from benchmark.counts import flops, peaks
from benchmark.reference import models
from benchmark.tests.test_bench_imports import _modules_after

CELL = "j1j2_10x10_vit.train"
#: the trunk's per-layer metrics, each read from the program's spans
TRUNK = ("vit_ms.train", "vit_attn_ms.train", "vit_mlp_ms.train",
         "vit_roofline.train")
#: float32 with TF32 off on both sides: the port and the reference run the
#: same arithmetic in other orders (the value projection as one [d, d]
#: product or as [d, H, hd], the attention as an einsum or as one product
#: per head, the layer norm's division or rsqrt), so each sum of the
#: 2 blocks, 4 tokens and 4 copies rounds differently by a few float32
#: ulps of |log psi| (10 to 30 at these weights): the two read at most a
#: fifteenth of rtol 1e-5 / atol 1e-6, and bfloat16 operands miss it by
#: orders of magnitude
RTOL, ATOL = 1e-5, 1e-6


def small_cfg() -> dict:
    cfg = copy.deepcopy(spec.cell(CELL)["config"])
    cfg["lattice"]["shape"] = [4, 4]
    cfg["model"].update(channels=[12, 12], vit_heads=3)
    cfg["sampler"].update(n_walkers=16, n_therm_sweeps=2)
    return cfg


def small_std(cfg: dict) -> dict:
    """Every leaf drawn away from its init: the layer-norm scales and
    biases included, so no term of the block is left at a trivial
    value."""
    out = {}
    for key in models.param_layout(cfg):
        out[key] = (1.0 if key.endswith("/scale") else
                    0.5 if "relpos" in key else
                    0.2 if key.endswith("/bias") else
                    0.3 if "head" in key else 0.4)
    return out


def spins(batch: int, n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, (batch, n), generator=gen) * 2.0 - 1.0


def phase_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b + math.pi) % (2 * math.pi) - math.pi).abs()


def within(re, im, ref_re, ref_im) -> bool:
    """re to RTOL / ATOL, and the phase modulo 2 pi to ATOL + RTOL |log
    psi| (its rounding scales with the terms summed, as re's does)."""
    scale = ATOL + RTOL * ref_re.abs()
    return bool(((re - ref_re).abs() <= scale).all()
                and (phase_gap(im, ref_im) <= scale).all())


@pytest.fixture(scope="module")
def small():
    from benchmark.drivers import common

    cfg = small_cfg()
    vmc, _, params, _ = common.build(cfg, 2 ** 31 + 17, "cpu",
                                     small_std(cfg))
    s = spins(64, 16, 3)
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, s)
    return cfg, params, s, lp


def test_reference_matches_the_port(small):
    cfg, params, s, lp = small
    re, im = models.log_psi(cfg, params, s)
    assert float(lp.re.abs().max()) > 1.0
    assert within(lp.re, lp.im, re, im), (
        float((lp.re - re).abs().max()), float(phase_gap(lp.im, im).max()))


@pytest.mark.parametrize("prec", ["bf16", "fp8"])
def test_lower_precision_fails_the_tolerance(small, prec):
    cfg, params, s, _ = small
    re, im = models.log_psi(cfg, params, s)
    low_re, low_im = models.log_psi(cfg, params, s, prec)
    assert not within(low_re, low_im, re, im)


def test_spin_flip_projection_matches_the_port():
    """psi(s) + psi(-s) as amplitudes, each over the batch's largest: the
    sum's log amplifies its rounding where the two terms nearly cancel,
    its amplitude does not."""
    from benchmark.drivers import common

    cfg = small_cfg()
    cfg["model"]["spin_flip_sector"] = 1
    vmc, _, params, _ = common.build(cfg, 2 ** 31 + 23, "cpu",
                                     small_std(cfg))
    assert all(k.startswith("params/inner/") for k in params)
    s = spins(32, 16, 4)
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, s)
    re, im = models.log_psi(cfg, params, s)
    top = re.max()
    port = torch.exp(lp.re - top) * torch.exp(1j * lp.im)
    ref = torch.exp(re - top) * torch.exp(1j * im)
    assert float((port - ref).abs().max()) <= RTOL


def test_published_widths():
    """The layout is the program's init at the published widths, and the
    counts are those worked out from the widths by hand: 267,432
    parameters, 54,777,600 FLOPs a configuration (four rolled copies of
    13,694,400)."""
    from benchmark.drivers import common
    from qmcnn_tpu_torch.builder import build_lattice, build_model

    cell = spec.cell(CELL)
    cfg = cell["config"]
    assert cfg["model"]["channels"] == [72] * 8
    assert (cfg["model"]["vit_heads"], cfg["model"]["vit_patch"],
            cfg["lattice"]["shape"]) == (12, 2, [10, 10])
    layout = models.param_layout(cfg)
    program = common.program_config(cfg)
    model = build_model(program, build_lattice(program))
    init = model.init(0)
    assert list(layout) == sorted(init)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: shape for k, (shape, _) in layout.items()}
    assert flops.n_params(cfg) == 267_432
    assert flops.forward_flop(cfg) == 54_777_600
    flip = copy.deepcopy(cfg)
    flip["model"]["spin_flip_sector"] = 1
    assert flops.forward_flop(flip) == 2 * 54_777_600


def test_the_cell_resolves():
    cell = spec.cell(CELL)
    assert cell["workload"]["chips"] == 1
    assert cell["traffic"]["driver"] == "train"
    assert cell["config"]["model"]["kind"] == "vit"
    assert sorted(cell["weight_std"]) == sorted(
        models.param_layout(cell["config"]))
    assert cell["limits"]
    per_layer = {m["name"] for m in cell["per_layer"]}
    assert set(TRUNK) <= per_layer
    assert {"mfu.train", "device_idle.train", "e_loc_ms.train",
            "jacobian_ms.train", "sampler_ms.train", "sr_ms.train",
            "gradient_ms.train"} <= per_layer
    assert {m["name"] for m in cell["end_to_end"]} == {"step_ms", "setup_s"}
    meta = cell["config_meta"]
    assert meta["reduced"] == ["sampler.n_therm_sweeps"]
    assert meta["published"] == {"sampler.n_therm_sweeps": 100}


def test_reference_kind_imports_nothing_of_the_program():
    assert os.path.exists(os.path.join(os.path.dirname(models.__file__),
                                       "kinds", "vit.py"))
    mods = _modules_after("import benchmark.reference.models as m; "
                          "m.kind('vit')")
    assert not mods & {"qmcnn_tpu_torch", "qmcnn_tpu", "jax", "jaxlib",
                       "flax"}


class FakeSpan:
    def __init__(self, name, ms):
        self.name, self._ms = name, ms

    def device_ms(self):
        return self._ms


def test_trunk_readers(monkeypatch):
    """The trunk's readers over recorded spans: ms per traced step, and
    the roofline share from the inputs' rows; nothing where the program
    records no ``vit`` span (a program older than the spans)."""
    from benchmark import program_spans

    cfg = spec.cell(CELL)["config"]
    run = {"steps": 10, "traced_steps": [2, 4], "m": 256, "cfg": cfg,
           "eval_rows": [1e5] * 10}
    spans = [FakeSpan("vit", 300.0), FakeSpan("vit.attn", 10.0),
             FakeSpan("vit", 500.0), FakeSpan("vit.mlp", 20.0),
             FakeSpan("e_loc", 99.0)]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    read = {m: spec.reader(m) for m in TRUNK}
    assert read["vit_ms.train"](run) == 400.0
    assert read["vit_attn_ms.train"](run) == 5.0
    assert read["vit_mlp_ms.train"](run) == 10.0
    rows = 2 * 1e5 + 2 * 2 * 256
    bound = peaks.roofline_seconds(rows * 54_777_600,
                                   rows * flops.forward_bytes(cfg),
                                   "float32")
    assert read["vit_roofline.train"](run) == pytest.approx(
        100 * bound / 0.8)
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: [FakeSpan("e_loc", 99.0)])
    assert all(read[m](run) is None for m in TRUNK)
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert all(read[m](run) is None for m in TRUNK)
    assert all(read[m]({"samples": 3}) is None for m in TRUNK)


@pytest.mark.cuda
def test_control_is_not_correct():
    """On the card: the TF32 control fails the cell's limits, the program
    at the same seed passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    cell = spec.cell(CELL)
    got = calibrate.readings(cell, 2 ** 31 + 101, 0.5)
    limits = cell["limits"]
    assert check.verdict(got["program"], limits), got["program"]
    assert not check.verdict(dict(got["program"], **got["control"]),
                             limits), got["control"]
