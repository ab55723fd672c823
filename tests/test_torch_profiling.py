"""The program's spans and counters (``qmcnn_tpu_torch/utils/profiling``):
off outside a profiler and a recording window, with the step bitwise the
same either way; the span tree of one training step with pcg and with
minSR; one ``sr.pcg.wait`` per loop-flag read, one a block of pcg's
masked iterations (``sr.pcg.blocks``); the ``--timings`` lines of
``measure`` and ``evolve`` read from the spans; the kernel build
counter; the rule that puts each idle moment of a trace down to the
innermost open span, on synthetic intervals and on a host trace; and, on
the card (``-m cuda``), a span's host start against its kernel on the
trace's clock. JAX-free."""
import contextlib
import io
import json
import subprocess
import time
from pathlib import Path

import pytest
import torch

from qmcnn_tpu_torch import configs
from qmcnn_tpu_torch.builder import build
from qmcnn_tpu_torch.kernels import nvcc
from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
from qmcnn_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TINY = {
    "heis_pcg": ("heis10x10_sr.yaml", ("lattice.shape=[4,4]",
                                       "model.channels=[4,4]",
                                       "sampler.n_walkers=32")),
    "gcnn_minsr": ("j1j2_8x8_gcnn.yaml", ("lattice.shape=[4,4]",
                                          "model.channels=[2,2]",
                                          "sampler.n_walkers=32")),
    "arnn_direct": ("j1j2_4x4_arnn.yaml", ("model.channels=[4,4]",
                                           "sampler.n_walkers=32")),
}
#: (name, parent) of each span one step records, in order of opening
STEP_TREE = {
    "heis_pcg": [("sampler", None), ("sampler.refresh", "sampler"),
                 ("sampler.noise", "sampler"), ("sampler.sweep", "sampler"),
                 ("e_loc", None), ("gradient", None), ("sr", None),
                 ("sr.jacobian", "sr"), ("sr.pcg", "sr"), ("update", None)],
    "gcnn_minsr": [("sampler", None), ("sampler.refresh", "sampler"),
                   ("sampler.noise", "sampler"), ("sampler.sweep", "sampler"),
                   ("e_loc", None), ("gradient", None), ("sr", None),
                   ("sr.jacobian", "sr"), ("sr.minsr", "sr"),
                   ("update", None)],
    # the direct pass: one cached conditional a site of the 4x4 lattice,
    # then its closing log psi; a log-psi forward each for E_loc and the
    # gradient, one a part for the complex score Jacobian
    "arnn_direct": [("sampler", None), ("sampler.refresh", "sampler"),
                    ("sampler.direct", "sampler")]
    + [("arnn.cond", "sampler.direct")] * 16
    + [("arnn", "sampler.direct"), ("e_loc", None), ("arnn", "e_loc"),
       ("gradient", None), ("arnn", "gradient"), ("sr", None),
       ("sr.jacobian", "sr"), ("arnn", "sr.jacobian"),
       ("arnn", "sr.jacobian"), ("sr.minsr", "sr"), ("update", None)],
}


@pytest.fixture(scope="module")
def cases():
    """{name: (vmc, thermalized state, walker ids)} at tiny sizes."""
    out = {}
    for name, (yaml, overrides) in TINY.items():
        cfg = configs.load(str(ROOT / "configs" / yaml),
                           overrides + ("sampler.n_therm_sweeps=2",))
        vmc, params, _ = build(cfg, device="cpu")
        key = prng_key(cfg.run.seed)
        ids = torch.arange(cfg.sampler.n_walkers)
        state = vmc.init_state(fold_in(key, 0), cfg.sampler.n_walkers,
                               params)
        state = vmc.thermalize(state, fold_in(key, 1), ids, 2)
        out[name] = (vmc, state._replace(step=5), ids)
    return out


def one_step(case):
    vmc, state, ids = case
    return vmc.step(state, fold_in(prng_key(3), state.step), ids)


def flat(tree) -> list:
    """Every tensor of a state or metrics tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in flat(x)]
    return [torch.tensor(tree)] if isinstance(tree, (int, float)) else []


@pytest.mark.parametrize("name", sorted(TINY))
def test_off_records_nothing_and_the_step_is_bitwise_the_same(cases, name):
    profiling.clear()
    off_state, off_metrics = one_step(cases[name])
    assert profiling.spans() == []
    assert profiling.annotate("x") is profiling.annotate("y")
    with profiling.recording() as window:
        on_state, on_metrics = one_step(cases[name])
    assert window.spans and profiling.spans() == []
    assert off_metrics.sr_iters == on_metrics.sr_iters
    for a, b in zip(flat((off_state, off_metrics)),
                    flat((on_state, on_metrics))):
        assert torch.equal(a, b)


def pcg_blocks_since(before: dict) -> float:
    """The blocks of pcg's masked iterations run since ``before``."""
    return (profiling.counters().get("sr.pcg.blocks", 0.0)
            - before.get("sr.pcg.blocks", 0.0))


@pytest.mark.parametrize("name", sorted(TINY))
def test_one_step_gives_the_span_tree(cases, name):
    before = profiling.counters()
    with profiling.recording() as window:
        _, metrics = one_step(cases[name])
    spans = window.spans
    tree = [(sp.name, sp.parent.name if sp.parent else None) for sp in spans
            if sp.name != "sr.pcg.wait"]
    assert tree == STEP_TREE[name]
    assert {sp.unit for sp in spans} == {cases[name][1].step}
    for sp in spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent is not None:
            assert sp.parent.start_ns <= sp.start_ns
            assert sp.end_ns <= sp.parent.end_ns
        assert sp.device_ms() is None and sp.ms() == sp.host_ms()
    waits = [sp for sp in spans if sp.name == "sr.pcg.wait"]
    assert all(sp.parent.name == "sr.pcg" for sp in waits)
    if name == "heis_pcg":
        assert metrics.sr_iters > 0
        assert len(waits) == pcg_blocks_since(before) > 0
    else:
        assert waits == [] and metrics.sr_iters == 0


def test_direct_pass_spans_and_counters(cases):
    """One step of the direct sampler: one ``sampler.direct`` span holding
    N ``arnn.cond`` spans and the closing ``arnn``; ``sampler.direct.sites``
    and ``sampler.direct.cached_sites`` count the N sites, all drawn
    through the PixelCNN's cache, and ``arnn.rows`` every row of a full
    trunk forward: the closing M, E_loc's compacted rows (``e_loc.rows``),
    the gradient's M and the Jacobian's M per part (a cached site adds
    none)."""
    vmc, state, _ = cases["arnn_direct"]
    m, n = state.walkers.s.shape
    before = profiling.counters()
    with profiling.recording() as window:
        one_step(cases["arnn_direct"])
    after = profiling.counters()

    def added(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    passes = [sp for sp in window.spans if sp.name == "sampler.direct"]
    assert len(passes) == 1 and passes[0].parent.name == "sampler"
    inside = [sp.name for sp in window.spans if sp.parent is passes[0]]
    assert inside == ["arnn.cond"] * n + ["arnn"]
    assert added("sampler.direct.sites") == n
    assert added("sampler.direct.cached_sites") == n
    assert added("e_loc.rows") > 0
    assert added("arnn.rows") == m + added("e_loc.rows") + m + 2 * m


def test_spans_record_under_a_profiler_and_stay_until_cleared(cases):
    profiling.clear()
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        one_step(cases["heis_pcg"])
    held = profiling.spans()
    assert [sp.name for sp in held].count("sr.pcg.wait") == \
        pcg_blocks_since(before) > 0
    assert profiling.spans() == held
    # a recording window inside a profiler leaves the profiler's spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.recording() as window:
            with profiling.annotate("outer"):
                with profiling.recording() as inner:
                    with profiling.annotate("inner"):
                        pass
    assert [sp.name for sp in inner.spans] == ["inner"]
    assert [sp.name for sp in window.spans] == ["outer", "inner"]
    assert [sp.name for sp in profiling.spans()[len(held):]] == [
        "outer", "inner"]
    profiling.clear()
    assert profiling.spans() == []


def test_window_seconds_totals_by_name():
    with profiling.recording() as window:
        for _ in range(3):
            with profiling.annotate("a"):
                with profiling.annotate("b"):
                    torch.ones(8).sum()
    got = window.seconds(["b", "a", "c"])
    assert list(got) == ["a", "b"] and got["a"] >= got["b"] > 0
    assert list(window.seconds(["b", "c"])) == ["b"]
    assert profiling.spans() == []


def test_paused_records_no_span():
    """Inside ``paused()`` no span records, in a window or under a
    profiler; outside it recording goes on."""
    with profiling.recording() as window:
        with profiling.paused():
            with profiling.annotate("captured"):
                torch.ones(4).sum()
        with profiling.annotate("after"):
            torch.ones(4).sum()
    assert [sp.name for sp in window.spans] == ["after"]
    held = profiling.spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.paused():
            with profiling.annotate("captured"):
                torch.ones(4).sum()
    assert profiling.spans() == held


def test_step_split_reads_the_phases(cases):
    vmc, state, _ = cases["heis_pcg"]
    split = profiling.step_split(vmc, state, n_steps=2)
    assert list(split) == ["sample", "e_loc", "gradient", "sr", "update"]
    assert all(v > 0 for v in split.values())


def test_measure_timings_keys(tmp_path):
    from qmcnn_tpu_torch import measure

    meta = json.loads((ROOT / "runs" / "j1j2_4x4_ground.csv.meta.json")
                      .read_text())
    yaml_path = tmp_path / "g4.yaml"
    yaml_path.write_text(meta["config"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        measure.main(["--config", str(yaml_path), "--ckpt-dir",
                      str(ROOT / "runs" / "j1j2_4x4_ground.csv.params.npz"),
                      "--device", "cpu", "--n-samples", "2", "--timings",
                      "--override", "sampler.n_walkers=16",
                      "--override", "run.heartbeat_path=null"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    timings = line["timings_s"]
    assert list(timings) == ["therm", "sweeps", "e_loc", "nn_ss",
                             "diagonal"]
    assert all(v > 0 for v in timings.values())
    assert line["n_samples"] == 2 and set(line["launches"]) == {
        "k1", "k2_f32", "k2_bf16"}


def test_evolve_timings_keys(tmp_path):
    from qmcnn_tpu_torch import evolve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evolve.main(["--config", str(ROOT / "configs" / "tfim16_sgd.yaml"),
                     "--override", "lattice.shape=[6]", "--mode", "imag",
                     "--dt", "0.05", "--steps", "2", "--solver", "dense",
                     "--diag-shift", "1e-2", "--sampling", "fullsum",
                     "--device", "cpu", "--timings"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line["timings_s"]) == ["weights", "forward", "jacobian",
                                       "solve", "observables"]
    assert line["n_steps"] == 2


def test_nvcc_counts_a_compile_and_not_a_cache_hit(tmp_path, monkeypatch):
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nvcc, "nvcc", lambda: "nvcc")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(nvcc.subprocess, "run", fake_run)
    before = profiling.counters()
    out, log = nvcc.build_library(source)
    after = profiling.counters()
    assert out.exists() and log == "ptxas info" and len(calls) == 1
    assert after["kernel_build_s"] > before.get("kernel_build_s", 0.0)
    assert nvcc.build_library(source) == (out, "")
    assert len(calls) == 1 and profiling.counters() == after


def test_idle_pieces_are_the_window_less_the_busy_union():
    busy = [(0, 10), (5, 20), (30, 40), (35, 38), (90, 120)]
    assert profiling._idle_pieces(busy, (2, 100)) == [(20, 30), (40, 90)]
    assert profiling._idle_pieces([], (2, 100)) == [(2, 100)]
    assert profiling._idle_pieces([(0, 200)], (2, 100)) == []


def host_span(name, start, end, parent=None):
    span = profiling.Span(name, parent, 0)
    span.start_ns, span.end_ns = start, end
    return span


def test_innermost_parts_are_disjoint_and_cover_the_top_spans():
    root = host_span("e_loc", 0, 100)
    kids = [host_span("e_loc.deflation", 10, 40, root),
            host_span("e_loc.deflation", 40, 70, root)]
    assert profiling._innermost([root] + kids) == [
        (0, 10, "e_loc"), (10, 40, "e_loc.deflation"),
        (40, 70, "e_loc.deflation"), (70, 100, "e_loc")]


def test_each_idle_moment_goes_to_the_innermost_open_span():
    sr = host_span("sr", 100, 200)
    pcg = host_span("sr.pcg", 120, 190, sr)
    waits = [host_span("sr.pcg.wait", 130, 140, pcg),
             host_span("sr.pcg.wait", 170, 180, pcg)]
    sampler = host_span("sampler", 10, 60)
    sweep = host_span("sampler.sweep", 30, 50, sampler)
    spans = [sampler, sweep, sr, pcg] + waits
    # gaps: [0, 20) (untraced to 10, sampler after), [40, 45) (sweep),
    # [55, 135) crossing sampler -> untraced -> sr -> sr.pcg -> wait,
    # [175, 230) crossing a wait, sr.pcg, sr and untraced
    busy = [(20, 40), (45, 55), (135, 175)]
    parts, untraced = profiling.attribute(spans, busy, (0, 230))
    assert parts == {"sampler": 10 + 5, "sampler.sweep": 5,
                     "sr": 20 + 10, "sr.pcg": 10 + 10,
                     "sr.pcg.wait": 5 + 5}
    assert untraced == 10 + 40 + 30
    idle = sum(b - a for a, b in profiling._idle_pieces(busy, (0, 230)))
    assert sum(parts.values()) + untraced == idle == 20 + 5 + 80 + 55


def test_idle_by_span_of_a_trace_sums_to_its_idle_share(cases, tmp_path):
    """On the host's own trace (a CPU run has no device): the step's spans
    put on the trace's clock, every idle moment given to one of them or to
    "untraced", and the parts summing to ``idle_share``."""
    profiling.clear()
    with profiling.trace(str(tmp_path)) as prof:
        one_step(cases["heis_pcg"])
        time.sleep(0.002)   # idle with no span open
    spans = profiling.spans()
    profiling.clear()
    busy = profiling.device_intervals(prof, "cpu")
    t0 = prof.profiler.kineto_results.trace_start_ns()
    assert busy and all(t0 <= a < b for a, b in busy)
    # the spans' own profiler ranges lie inside their host intervals
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "sr.pcg")
    (pcg,) = [sp for sp in spans if sp.name == "sr.pcg"]
    a, b = (t0 + round(x * 1e3) for x in ranges[0])
    assert len(ranges) == 1 and pcg.start_ns <= a <= b <= pcg.end_ns
    parts, untraced = profiling.idle_by_span(prof, spans, "cpu")
    assert untraced > 0 and set(parts) <= {sp.name for sp in spans}
    assert sum(parts.values()) + untraced == pytest.approx(
        profiling.idle_share(prof, "cpu"), abs=1e-6)
    assert profiling.idle_by_span(prof, spans, "cuda") is None


@pytest.mark.cuda
def test_a_span_and_its_kernel_share_the_trace_clock(tmp_path, capsys):
    """20 spans, each opened on a synchronized, idle card around one kernel
    and a synchronize: on the trace's clock each kernel starts after the
    host's launch call, ends before the synchronize returns, and starts
    after its span's host start. A span's device time is read once, and
    its events serve the spans recorded after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace's device clock")
    x = torch.ones(1, device="cuda")
    with profiling.trace(str(tmp_path / "warmup")):  # the profiler's start
        x.add_(1.0)
    profiling.clear()
    hosts = []
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(20):
            torch.cuda.synchronize()
            with profiling.annotate("probe"):
                launch = time.time_ns()
                x.add_(1.0)
                torch.cuda.synchronize()
                hosts.append((launch, time.time_ns()))
    probes = [sp for sp in profiling.spans() if sp.name == "probe"]
    profiling.clear()
    kernels = profiling.device_intervals(prof)
    assert len(probes) == len(kernels) == 20
    rows = [((a - sp.start_ns) / 1e3, (a - launch) / 1e3, (done - b) / 1e3)
            for sp, (launch, done), (a, b) in zip(probes, hosts, kernels)]
    with capsys.disabled():
        for name, col in (("span start -> kernel start", 0),
                          ("launch call -> kernel start", 1),
                          ("kernel end -> synchronize returned", 2)):
            print(f"\n{name}, us: {sorted(round(r[col], 1) for r in rows)}")
    assert all(r[0] >= 0 and r[1] >= 0 and r[2] >= 0 for r in rows), rows
    events = {id(e) for e in probes[0].events}
    ms = probes[0].device_ms()
    assert probes[0].events is None and probes[0].device_ms() == ms > 0
    with profiling.recording() as window:
        with profiling.annotate("again"):
            x.add_(1.0)
    assert {id(e) for e in window.spans[0].events} == events
    assert window.spans[0].device_ms() > 0
