"""The readers of the program's spans and counters
(``program_spans.py``): the new per-layer metrics on a training and a
measurement run with spans, and silent on a program without them.

  python -m pytest -p no:cacheprovider benchmark/tests/test_bench_spans.py
"""
from types import SimpleNamespace

import pytest

from benchmark import program_spans, spec

#: the per-layer metrics that read the program's spans and counters
NEW = ("e_loc_ms.train", "gradient_ms.train", "jacobian_ms.train",
       "pcg_wait_ms.train", "e_loc_ms.measure", "nn_ss_ms.measure",
       "kernel_build_s")


def span(name, start, end, parent=None, ms=None):
    """A recorded span as the program's recorder keeps it (``ms``: its
    device time; None for a host-only span)."""
    return SimpleNamespace(
        name=name, parent=parent, start_ns=start, end_ns=end,
        host_ms=lambda: (end - start) / 1e6, device_ms=lambda: ms)


def traced_run(unit):
    """The keys the readers take of a run record as the training (``unit``
    "steps") or measurement ("samples") driver gives it: 12 units, units
    4..7 traced."""
    return {unit: 12, "traced_steps": [4, 7]}


def step_spans(t):
    """The spans of one flagship-like training step starting at ``t`` ns:
    21 flag reads of 0.2 ms inside pcg."""
    sampler = span("sampler", t, t + 9_000_000, ms=8.5)
    e_loc = span("e_loc", t + 9_000_000, t + 12_000_000, ms=3.0)
    sr = span("sr", t + 12_000_000, t + 39_000_000, ms=27.0)
    jac = span("sr.jacobian", t + 12_000_000, t + 14_000_000, sr, 2.0)
    pcg = span("sr.pcg", t + 14_000_000, t + 39_000_000, sr, 25.0)
    waits = [span("sr.pcg.wait", t + 15_000_000 + 1_000_000 * i,
                  t + 15_000_000 + 1_000_000 * i + 200_000, pcg)
             for i in range(21)]
    return [sampler, e_loc, sr, jac, pcg] + waits


def use(monkeypatch, spans, counters):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    monkeypatch.setattr(program_spans, "counter", counters.get)


def test_training_readers_read_the_program_spans(monkeypatch):
    spans = [sp for i in range(3) for sp in step_spans(40_000_000 * i)]
    use(monkeypatch, spans, {"kernel_build_s": 6.5})
    got = {name: spec.reader(name)(traced_run("steps")) for name in NEW}
    assert got["e_loc_ms.train"] == pytest.approx(3.0)
    assert got["jacobian_ms.train"] == pytest.approx(2.0)
    assert got["pcg_wait_ms.train"] == pytest.approx(21 * 0.2)
    assert got["gradient_ms.train"] is None   # no such span recorded
    assert got["kernel_build_s"] == 6.5
    assert got["e_loc_ms.measure"] is None
    assert got["nn_ss_ms.measure"] is None


def test_measurement_readers_read_the_program_spans(monkeypatch):
    spans = []
    for i in range(3):
        t = 50_000_000 * i
        spans += [span("sampler", t, t + 15_000_000, ms=14.0),
                  span("e_loc", t + 15_000_000, t + 32_000_000, ms=16.9),
                  span("nn_ss", t + 32_000_000, t + 41_000_000, ms=8.9)]
    use(monkeypatch, spans, {"kernel_build_s": 0.0})
    got = {name: spec.reader(name)(traced_run("samples")) for name in NEW}
    assert got["e_loc_ms.measure"] == pytest.approx(16.9)
    assert got["nn_ss_ms.measure"] == pytest.approx(8.9)
    assert got["kernel_build_s"] == 0.0   # every kernel built before
    for name in ("e_loc_ms.train", "gradient_ms.train", "jacobian_ms.train",
                 "pcg_wait_ms.train"):
        assert got[name] is None, name


def test_readers_read_nothing_without_a_traced_unit(monkeypatch):
    use(monkeypatch, step_spans(0), {})
    run = {"steps": 12, "traced_steps": [0, 0]}
    for name in ("e_loc_ms.train", "jacobian_ms.train", "pcg_wait_ms.train"):
        assert spec.reader(name)(run) is None, name


def test_new_readers_are_silent_without_the_program_spans(monkeypatch):
    from qmcnn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert program_spans.recorded() is None
    for unit in ("steps", "samples"):
        for name in NEW:
            assert spec.reader(name)(traced_run(unit)) is None, name
