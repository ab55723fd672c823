"""The control of each one-card cell on the card: the reference put in the
program's place in the precision below the configuration's (TF32 under a
float32 config, float8 under bf16) must come out not correct by the cell's
limits, while the program at the same seed comes out correct. At the
cell's own size, one seed each (``calibrate.py`` reads a dozen):

  python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""
import pytest
import torch

from benchmark import calibrate, check, spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heis10x10_sr.train",
                                  "j1j2_8x8_gcnn_r2.train",
                                  "heis10x10_sr.measure"])
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port's kernels")
    cell = spec.cell(name)
    got = calibrate.readings(cell, 2 ** 31 + 101, 0.5)
    limits = cell["limits"]
    assert check.verdict(got["program"], limits), got["program"]
    assert not check.verdict(dict(got["program"], **got["control"]),
                             limits), got["control"]
