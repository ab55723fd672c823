"""The plain reference against the program at tiny sizes on the CPU: the
forwards, the local energy, a training step (pcg and minSR) and the
measured estimators. The reference itself imports nothing of the program;
only these tests put the two side by side."""
import copy
import json
import os

import pytest
import torch

from benchmark import check
from benchmark.reference import estimators, hamiltonian, models
from benchmark.reference import vmc as rvmc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMALL = {
    "heis10x10_sr": {"lattice": {"shape": [4, 4]},
                     "model": {"channels": [4, 4]},
                     "sampler": {"n_walkers": 32, "n_therm_sweeps": 4}},
    "j1j2_8x8_gcnn_r2": {"lattice": {"shape": [4, 4]},
                         "model": {"channels": [2, 2, 2, 2],
                                   "compute_dtype": "float32"},
                         "sampler": {"n_walkers": 16, "n_therm_sweeps": 4}},
}


def small(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)["config"]
    cfg = copy.deepcopy(cfg)
    for sec, kv in SMALL[name].items():
        cfg[sec].update(kv)
    return cfg


def program(cfg):
    from benchmark.drivers import common

    vmc, _, params, _ = common.build(cfg, 5, "cpu")
    params = {k: v + (0.05 * torch.randn(v.shape, generator=torch.Generator()
                                         .manual_seed(9)) if "bias" in k
                      else 0.0) for k, v in params.items()}
    return vmc, params


@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_and_local_energy(name):
    from qmcnn_tpu_torch.ops.local_energy import local_energy

    cfg = small(name)
    vmc, params = program(cfg)
    state = vmc.init_state(123, cfg["sampler"]["n_walkers"], params)
    s = state.walkers.s
    lp = vmc.log_psi_fn(params, s)
    re, im = models.log_psi(cfg, params, s)
    assert torch.allclose(lp.re, re, atol=1e-5)
    assert float(check._phase_gap(lp.im, im).max()) < 1e-5
    e = local_energy(vmc.log_psi_fn, params, vmc.ham, s, lp)
    e_re, e_im = hamiltonian.local_energy(
        cfg, lambda x: models.log_psi(cfg, params, x), s, (re, im))
    assert torch.allclose(e.re, e_re, atol=1e-4)
    assert torch.allclose(e.im, e_im, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_training_step(name):
    cfg = small(name)
    vmc, params = program(cfg)
    m = cfg["sampler"]["n_walkers"]
    state = vmc.init_state(77, m, params)
    state = state._replace(step=100,
                           opt_state=dict(state.opt_state, count=100))
    new, metrics = vmc.step(state, 4242, torch.arange(m))
    traj = rvmc.follow(cfg, params, [new.walkers.s], 100, 100, system=True)
    assert abs(float(metrics.energy_re) - traj["losses"][0]) < 1e-4
    for k in params:
        assert torch.allclose(new.params[k], traj["params_out"][k],
                              atol=1e-4, rtol=1e-3), k
    # the program's direction solves the reference's SR system as closely
    # as pcg's tolerance asks (minSR's direct solve: to rounding)
    g = rvmc.flat(params) - rvmc.flat(new.params)
    assert traj["residual"](g) < 2 * float(cfg["sr"]["cg_tol"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sr_residual_tells_a_wrong_direction(name):
    cfg = small(name)
    _, params = program(cfg)
    m = cfg["sampler"]["n_walkers"]
    s = models_walkers(cfg, m)
    ref = rvmc.follow(cfg, params, [s], 100, 100, system=True)
    own = ref["residual"](rvmc.flat(ref["g1"]))
    assert own <= float(cfg["sr"]["cg_tol"])
    # its length does not count: the clip rescales a direction
    assert ref["residual"](3.0 * rvmc.flat(ref["g1"])) == pytest.approx(
        own, rel=1e-2)
    half = rvmc.follow(cfg, params, [s], 100, 100, keep=slice(0, m // 2))
    assert ref["residual"](rvmc.flat(half["g1"])) > 0.05
    if cfg["sr"]["solver"] == "pcg":
        # pcg's direction lies within its tolerance of the dense solve's
        assert ref["residual"](rvmc.flat(ref["g1_exact"])) < 1e-5
        assert check.leaf_gap(ref["g1"], ref["g1_exact"],
                              sorted(params)) < 0.05


def models_walkers(cfg, m):
    """m random walkers at S^z = 0."""
    n = cfg["lattice"]["shape"][0] * cfg["lattice"]["shape"][1]
    gen = torch.Generator().manual_seed(3)
    half = torch.cat([torch.ones(n // 2), -torch.ones(n - n // 2)])
    return torch.stack([half[torch.randperm(n, generator=gen)]
                        for _ in range(m)])


def test_bf16_witness_rounds_the_operands():
    cfg = small("j1j2_8x8_gcnn_r2")
    _, params = program(cfg)
    s = models_walkers(cfg, 8)
    a = models.log_psi(cfg, params, s, "f32")[0]
    b = models.log_psi(cfg, params, s, "bf16")[0]
    gap = float((a - b).abs().max())
    assert 0.0 < gap < 0.1


def test_estimators():
    from qmcnn_tpu_torch.builder import build_lattice
    from qmcnn_tpu_torch.measure import sample_estimators

    from benchmark.drivers import common

    cfg = small("heis10x10_sr")
    vmc, params = program(cfg)
    state = vmc.init_state(31, 32, params)
    est = sample_estimators(vmc.eval_log_psi_fn, params, state.walkers,
                            vmc.ham, build_lattice(
                                common.program_config(cfg)),
                            marshall=True)
    ref = estimators.sample(cfg, params, state.walkers.s)
    for key in ("energy", "magnetization", "mst2", "mst4", "corr", "ss_nn"):
        assert torch.allclose(est[key].double(), ref[key].double(),
                              atol=1e-5), key
