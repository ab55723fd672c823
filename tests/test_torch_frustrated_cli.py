"""PyTorch port, slice 8: each config this slice opens trains 2 steps through
the CLI on the CPU at a tiny size (two channels, 16 walkers), with finite
energies, minSR (and SPRING where the config sets it), and a snapshot
under its config's parameter names."""
import csv
import os

import numpy as np
import pytest

from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import train as ttrain
from qmcnn_tpu_torch.utils.transfer import load_checkpoint_params
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPENED = {
    "tri6x6_heis": (),
    "tri6x3_j1j2": ("model.jastrow=true", "model.jastrow_phase=true",
                    "run.validate_against_ed=true"),
    "kagome2x3_heis": (),
    "kagome3x3_heis": (),
    "kagome3x3_phasenet": ("model.phase_net_channels=[2,2,2]",),
    "tri6x6_tgcnn": (),
    "kagome3x3_kgcnn": (),
}
TINY = ("model.channels=[2,2]", "sampler.n_walkers=16",
        "sampler.n_therm_sweeps=1", "run.n_steps=2", "run.log_every=1")


@pytest.mark.parametrize("config", sorted(OPENED))
def test_opened_config_trains_on_cpu(config, tmp_path, capsys):
    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    out = str(tmp_path / f"{config}.csv")
    over = TINY + OPENED[config] + (f"run.csv_path={out}",)
    ttrain.main(["--config", path, "--device", "cpu",
                 *[x for ov in over for x in ("--override", ov)]])
    text = capsys.readouterr().out
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(float(r["energy_re"]))
        assert 0.0 < float(r["accept"]) <= 1.0
        assert float(r["sr_iters"]) == 0.0  # minSR: a direct solve
    if "validate_against_ed=true" in " ".join(over):
        assert "relative error" in text
    cfg = tcfg.load(path, over)
    flat = load_checkpoint_params(out + ".params.npz")
    assert all(k.startswith("params/inner/") for k in flat)  # a phase prior
    assert any(k.endswith("/gate") for k in flat) == bool(
        cfg.model.phase_net_channels)
    assert ("params/inner/u" in flat) == cfg.model.jastrow_phase
