"""A lattice is one file of the harness, ``reference/lattices/<geometry>.py``
(its sites, bonds and sublattices): the square lattice's bonds are what
they were before it was a file, and the triangular lattice's, written from
its definition, are the program's and give its local energy and its exact
ground energy. These tests may import the program: it is the yardstick
here, as in ``test_bench_reference.py``.

  python -m pytest -p no:cacheprovider benchmark/tests/test_bench_lattices.py
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers import measure
from benchmark.reference import estimators, hamiltonian
from benchmark.spans import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


def program_config(name):
    """The program's YAML ``configs/<name>.yaml`` as the program reads it:
    (its Config, its sections as a dict)."""
    from qmcnn_tpu_torch import configs

    cfg = configs.load(os.path.join(ROOT, "configs", f"{name}.yaml"))
    return cfg, dataclasses.asdict(cfg)


def triangular(l1, l2, **ham):
    return {"lattice": {"shape": [l1, l2], "pbc": True,
                        "geometry": "triangular"},
            "hamiltonian": dict({"kind": "heisenberg", "j": 1.0,
                                 "marshall": False, "delta": 1.0}, **ham)}


#: the sha256 of bonds(cfg)'s three arrays (each array's dtype, shape and
#: bytes), as the square reference gave them before the lattice was a file
DIGESTS = {
    "heis10x10_sr":
        "c679964f6d217528b9a95a79ab40b032d73693545c2586886a00927fdb8351f1",
    "j1j2_8x8_gcnn_r2":
        "ca9cef38c3f071de315042d8fbf01731767d868ce7f32bcc5656851b04a056da",
    "j1j2_10x10_vit":
        "5ba220a424f7d6547f777fd95f0461e7dfe2625f9efa769bfa32218e09111808",
    "j1j2_10x10_arnn":
        "5ba220a424f7d6547f777fd95f0461e7dfe2625f9efa769bfa32218e09111808",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_square_bonds_are_as_before(name):
    digest = hashlib.sha256()
    for a in hamiltonian.bonds(config(name)):
        digest.update(a.dtype.str.encode())
        digest.update(str(a.shape).encode())
        digest.update(a.tobytes())
    assert digest.hexdigest() == DIGESTS[name]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_recorders_nearest_neighbours_are_as_before(name):
    """``spans.Recorder`` took the first 2 N bonds as the nearest
    neighbours; it now takes the geometry file's, the same pairs."""
    cfg = config(name)
    n = hamiltonian.lattice(cfg).n_sites(cfg)
    rec = Recorder(cfg, "cpu")
    assert torch.equal(rec._nn, torch.as_tensor(
        hamiltonian.bonds(cfg)[0][:2 * n]))


def pairs(bonds):
    return {(min(i, j), max(i, j)) for i, j in np.asarray(bonds).tolist()}


@pytest.mark.parametrize("shape", [(6, 6), (6, 3), (4, 4)])
def test_triangular_bonds_are_the_programs(shape):
    from qmcnn_tpu_torch.lattice import Lattice

    cfg = triangular(*shape)
    geo = hamiltonian.lattice(cfg)
    lat = Lattice(shape, geometry="triangular")
    assert geo.n_sites(cfg) == lat.n_sites
    assert geo.sublattice(cfg) is None
    for mine, theirs in ((geo.nn(cfg), lat.nn_bonds),
                         (geo.nnn(cfg), lat.nnn_bonds)):
        assert mine.dtype == np.int64 and mine.shape[1] == 2
        # each pair once: on a side of 3 two vectors of the sqrt(3) shell
        # reach the same site, and a pair listed twice would count twice
        assert len(pairs(mine)) == len(mine) == len(theirs)
        assert pairs(mine) == pairs(theirs)


@pytest.mark.parametrize("shape", [(4, 4), (10, 10)])
def test_square_bonds_are_the_programs(shape):
    from qmcnn_tpu_torch.lattice import Lattice

    cfg = {"lattice": {"shape": list(shape), "pbc": True}}
    geo = hamiltonian.lattice(cfg)
    lat = Lattice(shape)
    assert np.array_equal(geo.nn(cfg), lat.nn_bonds)
    assert np.array_equal(geo.nnn(cfg), lat.nnn_bonds)
    assert np.array_equal(geo.sublattice(cfg), lat.sublattice_mask)


def toy_log_psi(n, seed):
    """A seeded complex log psi of s [B, N] (float32): the real part a
    layer of lncosh, the phase linear in the spins."""
    gen = torch.Generator().manual_seed(seed)
    w = 0.3 * torch.randn(n, 8, generator=gen)
    v = 0.5 * torch.randn(n, generator=gen)

    def fn(s):
        x = (s @ w).abs()
        re = 0.25 * (x + torch.log1p(torch.exp(-2.0 * x))).sum(-1)
        return re, s @ v

    return fn


def walkers(n, m, seed):
    """m S^z = 0 configurations [m, n] of a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    half = torch.cat([torch.ones(n // 2), -torch.ones(n - n // 2)])
    return torch.stack([half[torch.randperm(n, generator=gen)]
                        for _ in range(m)])


@pytest.mark.parametrize("name", ["tri6x6_tgcnn", "tri6x3_j1j2"])
def test_triangular_local_energy_is_the_programs(name):
    from qmcnn_tpu_torch.builder import build_hamiltonian, build_lattice
    from qmcnn_tpu_torch.ops.cplx import C
    from qmcnn_tpu_torch.ops.local_energy import local_energy

    pcfg, cfg = program_config(name)
    assert cfg["lattice"]["geometry"] == "triangular"
    assert not cfg["hamiltonian"]["marshall"]
    ham = build_hamiltonian(pcfg, build_lattice(pcfg))
    n = hamiltonian.lattice(cfg).n_sites(cfg)
    fn = toy_log_psi(n, 7)
    s = walkers(n, 64, 11)
    lp = fn(s)
    re, im = hamiltonian.local_energy(cfg, fn, s, lp)
    theirs = local_energy(lambda p, x: C(*fn(x)), None, ham, s, C(*lp))
    # both sum ~100 float32 terms a walker, in other orders (the reference
    # bond by bond into each walker, the program along a [M, K] row): they
    # agree to float32 rounding, ~1e-6 of the largest |E_loc|
    scale = float(theirs.re.abs().max())
    assert float((re - theirs.re).abs().max()) <= 1e-5 * scale
    assert float((im - theirs.im).abs().max()) <= 1e-5 * scale
    if cfg["hamiltonian"]["kind"] == "j1j2":
        assert float(cfg["hamiltonian"]["j2"]) == 0.12
        assert len(hamiltonian.bonds(cfg)[0]) == ham.n_conn


def test_triangular_ground_energy_is_the_programs():
    """The dense H of the 12-site triangular cluster (4 x 3) from the
    reference's bonds, in the S^z = 0 sector (H keeps S^z, and the singlet
    ground state has a member there), against the program's sparse H over
    all 4,096 states."""
    from qmcnn_tpu_torch.lattice import Lattice
    from qmcnn_tpu_torch.ops.exact import ground_energy, sparse_heisenberg

    cfg = triangular(4, 3)
    n = 12
    bond, diag_c, mel = hamiltonian.bonds(cfg)
    states = [x for x in range(1 << n) if bin(x).count("1") == n // 2]
    index = {x: k for k, x in enumerate(states)}
    h = np.zeros((len(states), len(states)))
    for k, x in enumerate(states):
        s = np.array([1.0 if x >> i & 1 else -1.0 for i in range(n)])
        zz = s[bond[:, 0]] * s[bond[:, 1]]
        h[k, k] = float((diag_c * zz).sum())
        for b in np.nonzero(zz < 0)[0]:
            y = x ^ (1 << int(bond[b, 0])) ^ (1 << int(bond[b, 1]))
            h[index[y], k] += float(mel[b])
    assert np.array_equal(h, h.T)
    mine = float(np.linalg.eigvalsh(h)[0])
    theirs = ground_energy(sparse_heisenberg(
        n, Lattice((4, 3), geometry="triangular").nn_bonds))
    assert abs(mine - theirs) < 1e-9


def test_marshall_needs_two_sublattices():
    with pytest.raises(ValueError, match="'triangular'"):
        hamiltonian.bonds(triangular(6, 6, marshall=True))


def test_a_geometry_with_no_file_is_refused():
    cfg = triangular(3, 3)
    cfg["lattice"]["geometry"] = "kagome"
    with pytest.raises(FileNotFoundError,
                       match="benchmark/reference/lattices/kagome.py"):
        hamiltonian.bonds(cfg)


@pytest.mark.parametrize("where", ["estimators", "measure_driver"])
def test_the_measured_estimators_are_the_square_lattices(where):
    cfg = dict(config("heis10x10_sr"), **triangular(6, 6))
    with pytest.raises(NotImplementedError, match="'triangular'"):
        if where == "estimators":
            estimators.sample(cfg, {}, walkers(36, 4, 1))
        else:
            measure.run({"config": cfg}, 1, 1.0, False, "cpu", 0.0)
