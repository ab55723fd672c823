"""The PixelCNN ARNN of the 10x10 benchmark cell (``j1j2_10x10_arnn``: 3x3
masked convolutions of 48 channels, SELU, complex per-site phase heads,
the S^z = 0 sector forced) against the benchmark's plain reference
(``benchmark/reference/kinds/arnn.py``) on the CPU, its autoregressive
property at the cell's depth, the harness's training run through its
sampler proxy at a tiny size, and the direct sampler's cached
pass (``models/arnn.SiteCache``) against the full forward per site: at
the cell's widths, with a 5x5 kernel and lncosh, on a non-square lattice,
inside the Jastrow phase wrapper, and not taken by the MADE trunk.

Tolerance: every compared value a (log psi's real and imaginary parts, and
both conditionals log p(+-1 | s_<i) at every site) within TOL max(|b|, 1)
of the reference's b. Both sides run the same float32 convolutions on the
same masked kernels; they differ in SELU and log sigmoid, which each
writes in its own form (a float32 ulp of each activation), and the ten
layers carry that rounding on: at the weights below the two read at most
2.1e-6 relative, while bfloat16 operands in the reference miss by 3.4e-3
or more (the CPU has no TF32, the card's control)."""
import copy
import dataclasses
import os

import pytest
import torch

from benchmark import run as bench
from benchmark import spec
from benchmark.drivers import common
from benchmark.reference import models
from qmcnn_tpu_torch import builder as tb
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.models.arnn import LogPsiARNN, conditional_fn
from qmcnn_tpu_torch.models.cnn import log_psi_apply
from qmcnn_tpu_torch.sampler.direct import DirectSampler, site_uniforms
from qmcnn_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

CELL = "j1j2_10x10_arnn.train"
TOL = 1e-5
#: the kernels' standard deviations over the init rule's, so that the
#: logits reach a few units and each layer's SELU works on both branches
GAIN = 1.5


def small_cfg(shape, layers: int) -> dict:
    cfg = copy.deepcopy(spec.cell(CELL)["config"])
    cfg["lattice"]["shape"] = list(shape)
    cfg["model"]["channels"] = [48] * layers
    cfg["sampler"]["n_walkers"] = 16
    return cfg


def sector_spins(batch: int, n: int, seed: int) -> torch.Tensor:
    """Configurations of S^z = 0, the ones the sampler draws."""
    gen = torch.Generator().manual_seed(seed)
    order = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(batch)])
    return torch.where(order < n // 2, 1.0, -1.0)


def within(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(((a - b).abs() <= TOL * b.abs().clamp(min=1.0)).all())


@pytest.fixture(scope="module", params=[((4, 4), 10), ((6, 6), 4)],
                ids=["4x4_10_layers", "6x6_4_layers"])
def small(request):
    """The port built by the benchmark's driver with the benchmark's
    seeded weights (biases drawn too), its log psi and conditionals."""
    shape, layers = request.param
    cfg = small_cfg(shape, layers)
    std = {k: (0.2 if "/cb" in k else GAIN * s)
           for k, (_, s) in models.param_layout(cfg).items()}
    vmc, _, params, _ = common.build(cfg, 2 ** 31 + 17, "cpu", std)
    s = sector_spins(64, shape[0] * shape[1], 3)
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, s)
        cond = vmc.sampler.conditional_fn(params, s)
    return cfg, params, s, lp, cond


def test_reference_matches_the_port(small):
    cfg, params, s, lp, (up, dn) = small
    kind = models.kind("arnn")
    re, im = models.log_psi(cfg, params, s)
    ref_up, ref_dn = kind.conditionals(cfg, params, s)
    assert float(lp.re.abs().max()) > 5.0 and float(im.abs().max()) > 5.0
    # the sector is forced at some sites of every configuration
    forced = (ref_up == kind.FORBIDDEN) | (ref_dn == kind.FORBIDDEN)
    assert bool(forced.any(-1).all())
    assert within(lp.re, re) and within(lp.im, im), (
        float((lp.re - re).abs().max()), float((lp.im - im).abs().max()))
    assert within(up, ref_up) and within(dn, ref_dn), (
        float((up - ref_up).abs().max()), float((dn - ref_dn).abs().max()))


def test_bf16_operands_fail_the_tolerance(small):
    cfg, params, s, _, _ = small
    kind = models.kind("arnn")
    re, im = models.log_psi(cfg, params, s)
    low_re, low_im = models.log_psi(cfg, params, s, "bf16")
    assert not within(low_re, re) and not within(low_im, im)
    ref_up, _ = kind.conditionals(cfg, params, s)
    low_up, _ = kind.conditionals(cfg, params, s, "bf16")
    assert not within(low_up, ref_up)


def test_ten_layer_trunk_is_autoregressive():
    """Changing s_j for every j >= i leaves conditional i as it was, at
    the cell's depth and width (the 4x4 lattice)."""
    cfg = small_cfg((4, 4), 10)
    cfg["model"]["arnn_sector"] = "none"
    vmc, _, params, _ = common.build(cfg, 2 ** 31 + 29, "cpu")
    cond = vmc.sampler.conditional_fn
    gen = torch.Generator().manual_seed(5)
    s = torch.randint(0, 2, (8, 16), generator=gen) * 2.0 - 1.0
    with torch.no_grad():
        base_up, base_dn = cond(params, s)
        for j in range(16):
            other = s.clone()
            other[:, j:] = torch.randint(0, 2, (8, 16 - j),
                                         generator=gen) * 2.0 - 1.0
            up, dn = cond(params, other)
            assert torch.equal(up[:, :j + 1], base_up[:, :j + 1])
            assert torch.equal(dn[:, :j + 1], base_dn[:, :j + 1])


class Args:
    seed = 2 ** 31 + 41
    seconds = 0.3
    trace = 0


def test_harness_train_driver_runs_the_direct_sampler():
    """The benchmark's training driver, through its sampler proxy (which
    reads the sampler's ``sweep_size``), on the cell at a tiny size: the
    checked steps are sampled exactly in the sector, their cached log psi
    is the reference's, and every walker is drawn anew."""
    cell = copy.deepcopy(spec.cell(CELL))
    cfg = cell["config"]
    cfg["lattice"]["shape"] = [4, 4]
    cfg["model"]["channels"] = [4, 4, 4]
    cfg["sampler"]["n_walkers"] = 32
    run = bench.run_cell(Args(), cell, device="cpu")
    numbers = run["numbers"]
    assert run["steps"] >= 2 and len(run["stash"]["s_out"]) == 3
    assert numbers["sz"] == 0.0
    assert numbers["log_psi"] <= 1e-5
    assert numbers["unmoved"] < 0.5
    assert all(abs(e) < 1e6 for e in run["energies"])


#: the cached pass's models (``LogPsiARNN`` settings over complex sz0 3x3
#: ones): the cell's own widths, a 5x5 kernel with a non-SELU activation
#: (``builder.py`` maps an ARNN's lncosh to SELU, so the model is built
#: directly), a non-square lattice
CACHED = {
    "cell_10x10": dict(lattice_shape=(10, 10), hidden=(48,) * 10),
    "k5_lncosh": dict(lattice_shape=(6, 6), hidden=(48,) * 3,
                      conv_kernel=5, activation="lncosh"),
    "nonsquare_4x6": dict(lattice_shape=(4, 6), hidden=(48,) * 4),
}


def pixelcnn_sampler(name: str, device="cpu"):
    """A direct sampler over the ``CACHED`` model ``name``, and its init's
    kernels at GAIN times their std with seeded biases."""
    kw = {"conv_kernel": 3, "complex_params": True, "sz_zero": True,
          **CACHED[name]}
    h, w = kw["lattice_shape"]
    model = LogPsiARNN(n_sites=h * w, **kw)
    gen = torch.Generator().manual_seed(13)
    params = {k: (0.2 * torch.randn(v.shape, generator=gen)
                  if "/cb" in k else GAIN * v).to(device)
              for k, v in model.init(2 ** 31 + 53).items()}
    samp = DirectSampler(lambda p, s: log_psi_apply(model, p, s),
                         conditional_fn(model), n_sites=h * w, sz_zero=True)
    return samp, params


@pytest.fixture(scope="module", params=sorted(CACHED))
def cached(request):
    return pixelcnn_sampler(request.param)


def added_by(fn, *names):
    """fn()'s result and what it added to each program counter."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, [after.get(k, 0.0) - before.get(k, 0.0) for k in names]


def assert_cached_pass_is_the_full_pass(samp, params, m: int, seed: int):
    """Given the same uniforms the cached pass draws bitwise the walkers
    of the full forward per site (no draw within 1e-6 of its p_up, as in
    ``tests/test_torch_arnn.py``), in the S^z = 0 sector, with the same
    closing log psi; the cache engages at every site and its sites add no
    trunk rows."""
    n = samp.n_sites
    assert hasattr(samp.conditional_fn, "site_cache")
    full = dataclasses.replace(
        samp, conditional_fn=lambda p, s: samp.conditional_fn(p, s))
    ids = torch.arange(m)
    u = site_uniforms(seed, ids, n)
    state = samp.init_state(params, 3, m)
    out, (sites, cached_sites, rows) = added_by(
        lambda: samp.sample(params, state, 0, ids, noise=u),
        "sampler.direct.sites", "sampler.direct.cached_sites", "arnn.rows")
    want = full.sample(params, state, 0, ids, noise=u)
    with torch.no_grad():
        log_up, _ = samp.conditional_fn(params, want.s)
    assert int(((u - torch.exp(log_up.double()).T).abs() < 1e-6).sum()) == 0
    assert torch.equal(out.s, want.s)
    assert bool((out.s.sum(-1) == 0).all())
    assert torch.equal(out.log_psi.re, want.log_psi.re)
    assert torch.equal(out.log_psi.im, want.log_psi.im)
    assert (sites, cached_sites, rows) == (n, n, m)


def test_cached_site_conditionals_match_the_full_forward(cached):
    """Site by site through the cache, log p(+1 | s_<i) equals column i of
    the full conditional forward on the prefix drawn (TOL), the sector's
    forced sites included."""
    samp, params = cached
    n, m = samp.n_sites, 4
    u = site_uniforms(2 ** 31 + 3, torch.arange(m), n)
    s = -torch.ones(m, n)
    got = torch.empty(m, n)
    with torch.no_grad():
        cache = samp.conditional_fn.site_cache(params, m, "cpu")
        for i in range(n):
            got[:, i] = cache.log_p_up(i)
            s[:, i] = torch.where(u[i] < torch.exp(got[:, i]).double(),
                                  1.0, -1.0)
            cache.place(i, s[:, i])
        want, want_dn = samp.conditional_fn(params, s)
    # the sector forces some sites of every walker (its last at least)
    assert bool(((want == -100.0) | (want_dn == -100.0)).any(-1).all())
    assert within(got, want), float((got - want).abs().max())
    assert bool((s.sum(-1) == 0).all())


def test_cached_pass_draws_the_full_pass_walkers(cached):
    samp, params = cached
    assert_cached_pass_is_the_full_pass(samp, params, 16, 2 ** 31 + 7)


@pytest.mark.cuda
def test_cached_pass_on_the_card():
    """On the card, at the cell's widths and walker count: the cached pass
    (cuBLAS products in true f32) draws the walkers of the full forward
    per site (cuDNN's), all but those with a draw within 1e-6 of its p_up,
    where the two roundings may part; the closing log psi agrees to TOL.
    On the card: ``python -m pytest --noconftest -p no:cacheprovider -m
    cuda tests/test_torch_arnn_pixelcnn.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    samp, params = pixelcnn_sampler("cell_10x10", "cuda")
    n, m = samp.n_sites, 2048
    full = dataclasses.replace(
        samp, conditional_fn=lambda p, s: samp.conditional_fn(p, s))
    ids = torch.arange(m, device="cuda")
    u = site_uniforms(2 ** 31 + 31, ids, n)
    state = samp.init_state(params, 3, m, device="cuda")
    out = samp.sample(params, state, 0, ids, noise=u)
    want = full.sample(params, state, 0, ids, noise=u)
    with torch.no_grad():
        log_up, _ = samp.conditional_fn(params, want.s)
    far = ((u - torch.exp(log_up.double()).T).abs() >= 1e-6).all(0)
    assert int(far.sum()) >= m - 8
    assert torch.equal(out.s[far], want.s[far])
    assert bool((out.s.sum(-1) == 0).all())
    assert within(out.log_psi.re[far], want.log_psi.re[far])
    assert within(out.log_psi.im[far], want.log_psi.im[far])


def program_sampler(*overrides):
    """The program's direct sampler for the 4x4 ARNN recipe with
    ``overrides``, and its own init's params with every leaf moved by
    seeded noise (so that no bias is zero)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "j1j2_4x4_arnn.yaml")
    cfg = tcfg.load(path, ("model.channels=[8,8,8]", "sampler.n_walkers=32")
                    + overrides)
    vmc, params, _ = tb.build(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    params = {k: GAIN * v + 0.2 * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    return vmc.sampler, params


def test_jastrow_wrapped_arnn_takes_the_cache():
    """The pure-phase Jastrow wrapper samples its inner ARNN, whose params
    sit under ``params/inner/``: the pass still takes the cache."""
    samp, params = program_sampler("model.jastrow_phase=true")
    assert any(k.startswith("params/inner/conv0") for k in params)
    assert_cached_pass_is_the_full_pass(samp, params, 32, 2 ** 31 + 19)


def test_made_arnn_keeps_the_full_forwards():
    """The MADE trunk has no cache: a full conditional forward per site,
    bitwise the loop it ran before the cache, counted as trunk rows."""
    samp, params = program_sampler("model.arnn_conv_kernel=0")
    cond = samp.conditional_fn
    assert not hasattr(cond, "site_cache")
    n, m = samp.n_sites, 32
    ids = torch.arange(m)
    u = site_uniforms(2 ** 31 + 23, ids, n)
    state = samp.init_state(params, 3, m)
    out, (sites, cached_sites, rows) = added_by(
        lambda: samp.sample(params, state, 0, ids, noise=u),
        "sampler.direct.sites", "sampler.direct.cached_sites", "arnn.rows")
    s = -torch.ones(m, n)
    with torch.no_grad():
        for i in range(n):
            log_p_up, _ = cond(params, s)
            p_up = torch.exp(log_p_up[:, i])
            s[:, i] = torch.where(u[i] < p_up.to(u.dtype), 1.0, -1.0)
    assert torch.equal(out.s, s)
    assert (sites, cached_sites, rows) == (n, 0, n * m + m)


def test_pixelcnn_footprint():
    """The memory preflight counts the PixelCNN ARNN's activations where
    they live: C channels at each of the N sites a layer (a MADE's
    footprint, one site of max(C, 3N), would count 300 floats). The 10x10
    trunk of ten 48-channel layers forwards 2 x 100 x 48 x 4 B = 38,400 B
    a configuration; at 80 GB E_loc's 2,048 x 401 configurations
    (31.5 GB) fit the budget beside the minSR buffers and run unchunked,
    at 40 GB in chunks of 512 walkers. The MADE trunk keeps its
    footprint."""
    import os

    from qmcnn_tpu_torch import builder as tb
    from qmcnn_tpu_torch import configs as tcfg
    from qmcnn_tpu_torch.utils import memory as tmem

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "j1j2_4x4_arnn.yaml")
    cfg = tcfg.load(path, ("lattice.shape=[10,10]",
                           "model.channels=[" + ",".join(["48"] * 10) + "]"))
    lat = tb.build_lattice(cfg)
    ham = tb.build_hamiltonian(cfg, lat)
    fp = tmem.model_footprint(cfg, lat.n_sites)
    assert (fp.n_sites, fp.max_width, fp.n_layers) == (100, 48, 11)
    assert fp.fwd_bytes() == 2 * 100 * 48 * 4
    n_params = 187_683
    assert tmem.auto_chunk_size(cfg, lat, ham, n_params,
                                mem_bytes=80 * 10**9) is None
    assert tmem.auto_chunk_size(cfg, lat, ham, n_params,
                                mem_bytes=40 * 10**9) == 512
    made = tcfg.load(path, ("lattice.shape=[10,10]",
                            "model.arnn_conv_kernel=0"))
    fp = tmem.model_footprint(made, 100)
    assert (fp.n_sites, fp.max_width) == (1, 300)
