"""PyTorch port, slice 1: the config schema, the lattice tables and the ED
oracle equal the JAX package's (qmcnn_tpu_torch.configs / .lattice /
.ops.exact against their qmcnn_tpu counterparts)."""
import dataclasses
import glob
import os

import numpy as np
import pytest

from qmcnn_tpu import configs as jcfg
from qmcnn_tpu import lattice as jlat
from qmcnn_tpu.ops import exact as jexact
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import lattice as tlat
from qmcnn_tpu_torch.ops import exact as texact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_loads_equal(path):
    j = jcfg.load(path)
    t = tcfg.load(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.to_yaml(t) == jcfg.to_yaml(j)


def test_overrides_equal_and_errors():
    path = os.path.join(ROOT, "configs", "heis10x10_sr.yaml")
    ovs = ("lattice.shape=[4,4]", "model.channels=[4,2]", "sr.solver=dense",
           "optimizer.lr=0.01")
    assert (dataclasses.asdict(tcfg.load(path, ovs))
            == dataclasses.asdict(jcfg.load(path, ovs)))
    with pytest.raises(KeyError):
        tcfg.load(path, ("model.nope=1",))
    with pytest.raises(ValueError):
        tcfg.load(path, ("model.kind",))


GEOMETRIES = [
    ("chain", dict(shape=(16,))),
    ("chain_open", dict(shape=(7,), pbc=False)),
    ("square", dict(shape=(4, 4))),
    ("rect_open", dict(shape=(3, 4), pbc=False)),
    ("triangular", dict(shape=(3, 3), geometry="triangular")),
    ("honeycomb", dict(shape=(2, 3), geometry="honeycomb")),
    ("kagome", dict(shape=(3, 3), geometry="kagome")),
]


@pytest.mark.parametrize("kw", [g[1] for g in GEOMETRIES],
                         ids=[g[0] for g in GEOMETRIES])
def test_lattice_tables_equal(kw):
    j = jlat.Lattice(**kw)
    t = tlat.Lattice(**kw)
    assert t.n_sites == j.n_sites and t.basis == j.basis
    for name in ("coords", "nn_bonds", "nnn_bonds", "sublattice_mask",
                 "site_positions"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.is_bipartite_compatible == j.is_bipartite_compatible
    if kw.get("geometry") in ("triangular", "kagome"):
        np.testing.assert_array_equal(t.triangles, j.triangles)
        np.testing.assert_array_equal(t.three_coloring, j.three_coloring)


def test_ed_energies_equal():
    lat = tlat.chain(10)
    b = lat.nn_bonds
    for t_sp, j_sp in (
            (texact.sparse_tfim(10, b, h=0.7, hz=0.2),
             jexact.sparse_tfim(10, b, h=0.7, hz=0.2)),
            (texact.sparse_heisenberg(10, b, nnn_bonds=lat.nnn_bonds,
                                      j2=0.4, delta=0.8),
             jexact.sparse_heisenberg(10, b, nnn_bonds=lat.nnn_bonds,
                                      j2=0.4, delta=0.8))):
        assert (t_sp != j_sp).nnz == 0
        assert texact.ground_energy(t_sp) == pytest.approx(
            jexact.ground_energy(j_sp), rel=1e-9)
