"""The yardstick's counts against hand-worked values for both
configurations."""
import json
import os

import pytest
import torch

from benchmark import readers
from benchmark.counts import flops, idle, peaks
from benchmark.reference import hamiltonian

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


HEIS, GCNN = config("heis10x10_sr"), config("j1j2_8x8_gcnn_r2")


def test_forward_flop_of_the_cnn():
    # 2 x 100 sites x 9 taps x (1*16 + 16*16 + 16*16)
    assert flops.forward_flop(HEIS) == 2 * 100 * 9 * 528 == 950_400


def test_forward_flop_of_the_gcnn():
    lift = 9 * 64 * 80 * 2 * 2
    group = 9 * 64 * 80 * 80 * 2 * 3 + 4 * 64 * 80
    # 7 group layers after the lift, doubled by the spin-flip projection
    assert flops.forward_flop(GCNN) == 2 * (lift + 7 * group) == 310_312_960


@pytest.mark.parametrize("cfg, expected", [(HEIS, 4_800), (GCNN, 101_140)])
def test_parameter_count(cfg, expected):
    assert flops.n_params(cfg) == expected


def test_nonzero_rows_of_a_neel_state():
    # every nearest-neighbour bond of a Neel state is anti-aligned, every
    # next-nearest one aligned
    for cfg, expected in ((HEIS, 200), (GCNN, 128)):
        lx, ly = cfg["lattice"]["shape"]
        x = torch.arange(lx)[:, None]
        y = torch.arange(ly)[None, :]
        neel = (1.0 - 2.0 * ((x + y) % 2)).reshape(1, -1).float()
        assert int(hamiltonian.nonzero_rows(cfg, neel)) == expected


def test_nonzero_rows_of_a_striped_state():
    # columns alike, alternating rows: the +x bonds anti-aligned, the +y
    # bonds aligned; the diagonals all anti-aligned
    for cfg, expected in ((HEIS, 100), (GCNN, 64 + 128)):
        lx, ly = cfg["lattice"]["shape"]
        x = torch.arange(lx)[:, None].expand(lx, ly)
        stripes = (1.0 - 2.0 * (x % 2)).reshape(1, -1).float()
        assert int(hamiltonian.nonzero_rows(cfg, stripes)) == expected


def test_step_flop_with_pcg():
    m, fwd, p = 2048, 950_400, 4_800
    sweep, e_loc, iters = 100_000.0, 200_000.0, 50
    expected = ((m + sweep + e_loc) * fwd + 3 * m * fwd + 3 * m * fwd
                + iters * 4 * m * p)
    assert flops.step_flop(HEIS, m, sweep, e_loc, iters) == expected


def test_step_flop_with_minsr():
    m, fwd, p = 1024, 310_312_960, 101_140
    r = 2 * m
    expected = ((m + 65536 + 131072) * fwd + 3 * m * fwd + 5 * m * fwd
                + 2 * r * r * p + r ** 3 / 3 + 2 * r * p)
    assert flops.step_flop(GCNN, m, 65536, 131072, 0) == pytest.approx(
        expected, rel=1e-12)


def test_roofline_and_idle():
    # 1.65e11 FLOP at 165 TFLOP/s is 1 ms; 3.35 GB at 3.35 TB/s also 1 ms
    assert peaks.roofline_seconds(1.65e11, 1.0, "float32") == pytest.approx(
        1e-3)
    assert peaks.roofline_seconds(1.0, 3.35e9, "bfloat16") == pytest.approx(
        1e-3)
    assert idle.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert idle.gaps([(0, 2, "a"), (1, 3, "b"), (5, 6, "c")]) == [(2, "c")]
    run = {"cfg": HEIS, "traced_steps": [1, 2], "eval_rows": [0, 1000, 0],
           "devtrace": {"kernels": {"sweep_kernel": [1e-3, 3]}}}
    bound = 1000 * 950_400 / (495e12 / 3)
    assert readers.kernel_roofline(run, "sweep_kernel", "float32") == \
        pytest.approx(100 * bound / 1e-3)
    assert readers.percentile(list(range(1, 101)), 90) == 90
