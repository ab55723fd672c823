"""PyTorch port: the torch Metropolis loop replayed as a CUDA graph of one
sweep (``sampler/metropolis.py``: ``SweepGraph``, ``graphs_sweep``;
``utils/cuda_graph.py``).

On the CPU: the rule that picks the path (a CUDA device, the torch
backend, no tempering, a forward declared graph-safe, the checked mode
off), the graph cache of a sampler made by ``dataclasses.replace``, the
tallies a replay adds, and the fused GCNN forward on the inputs a graph
holds. On the card (``-m cuda``): the graphed sweep equals the eager loop
bit for bit, on the Deep ViT and on K2 bf16 at their cells' widths, and
counts and records what the eager loop does. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sweep_graph.py
"""
import dataclasses
import gc
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from qmcnn_tpu_torch import builder
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch.kernels import gcnn_forward as k2
from qmcnn_tpu_torch.lattice import Lattice
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.hamiltonians import Heisenberg
from qmcnn_tpu_torch.ops.lanczos import lanczos_wrap
from qmcnn_tpu_torch.sampler import metropolis as tsm
from qmcnn_tpu_torch.utils import cuda_graph, debug, profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LAT = Lattice((4, 4))


def plain_fn(params, s):
    return C(s.sum(-1) * params["w"], torch.zeros(s.shape[0]))


def declared(fn):
    """``fn`` wrapped and declared graph-safe."""
    def wrapped(params, s):
        return fn(params, s)

    wrapped.graph_safe = cuda_graph.GraphSafe()
    return wrapped


def sampler_of(fn, **kw):
    kw.setdefault("move", "exchange_anti")
    return tsm.MetropolisSampler(fn, n_sites=LAT.n_sites, bonds=LAT.nn_bonds,
                                 lattice_shape=(4, 4), **kw)


def load(config, *overrides):
    return tcfg.load(str(ROOT / "configs" / f"{config}.yaml"), overrides)


def small_gcnn():
    cfg = load("j1j2_8x8_gcnn", "lattice.shape=[4,4]", "model.channels=[2,2]")
    _, params, lattice = builder.build(cfg, device="cpu")
    return builder.fused_gcnn_log_psi(cfg, lattice), params


def rule_case(name):
    """(sampler, device) of each case of the rule."""
    fn = declared(plain_fn)
    if name == "engaged":
        return sampler_of(fn), "cuda"
    if name == "cpu":
        return sampler_of(fn), "cpu"
    if name == "undeclared":
        return sampler_of(plain_fn), "cuda"
    if name == "k1_backend":
        return sampler_of(fn, move="exchange", backend="cuda"), "cuda"
    if name == "tempering":
        return sampler_of(fn, betas=(1.0, 0.5)), "cuda"
    if name == "lanczos_wrap":
        ham = Heisenberg(LAT)
        return sampler_of(lanczos_wrap(fn, ham)), "cuda:0"
    if name == "fused_gcnn":
        return sampler_of(small_gcnn()[0]), "cuda"
    if name == "vit_builder":
        cfg = load("j1j2_4x4_vit", "model.channels=[8,8]",
                   "model.spin_flip_sector=0", "sampler.n_walkers=16")
        return builder.build(cfg, device="cpu")[0].sampler, "cuda"
    if name == "cnn_builder":
        cfg = load("heis10x10_sr", "lattice.shape=[4,4]",
                   "model.channels=[4,4]", "sampler.backend=xla")
        return builder.build(cfg, device="cpu")[0].sampler, "cuda"
    raise KeyError(name)


@pytest.mark.parametrize("name,engages", [
    ("engaged", True), ("fused_gcnn", True), ("vit_builder", True),
    ("cpu", False), ("undeclared", False), ("k1_backend", False),
    ("tempering", False), ("lanczos_wrap", False), ("cnn_builder", False),
    ("checked", False)])
def test_rule_picks_the_graph_path(name, engages):
    """The graph engages only on a CUDA device, with the torch backend, no
    tempering, a forward declared graph-safe (``builder.build``'s ViT
    forward and the fused GCNN forward are; lanczos_wrap's and the plain
    CNN's are not) and the checked mode off."""
    if name == "checked":
        sampler, dev = rule_case("engaged")
        got = debug.checked(lambda: sampler.graphs_sweep(dev))()
        assert sampler.graphs_sweep(dev)
    else:
        sampler, dev = rule_case(name)
        got = sampler.graphs_sweep(dev)
    assert got is engages


def test_cpu_sampling_takes_the_eager_loop():
    """On the CPU a declared forward samples as the loop does, and no
    graph counter moves."""
    graphed = sampler_of(declared(plain_fn))
    eager = sampler_of(plain_fn)
    params = {"w": torch.tensor(0.3)}
    before = profiling.counters()
    outs = []
    for smp in (graphed, eager):
        st = smp.init_state(params, tsm.prng_key(3), 8)
        outs.append(smp.sample(params, st, tsm.prng_key(4),
                               torch.arange(8), n_sweeps=2))
    for a, b in zip(outs[0], outs[1]):
        for x, y in zip(a if isinstance(a, C) else (a,),
                        b if isinstance(b, C) else (b,)):
            assert torch.equal(x, y)
    after = profiling.counters()
    assert not any(k.startswith("sampler.graph")
                   and after[k] != before.get(k, 0) for k in after)
    assert graphed._graphs == {}


def test_replace_starts_a_graph_cache_of_its_own():
    """``dataclasses.replace(sampler, log_psi_fn=...)`` (the frozen-state
    samplers) holds its own graph cache, not the source's."""
    first = sampler_of(declared(plain_fn))
    first._graphs["held"] = object()
    other = dataclasses.replace(first, log_psi_fn=declared(plain_fn))
    assert other._graphs == {} and other._graphs is not first._graphs
    assert "held" in first._graphs
    assert "_graphs" not in {f.name for f in dataclasses.fields(first)}


def test_sweep_graph_holds_no_reference_to_its_sampler():
    """A sampler's sweep graph takes the proposal step at each call and
    holds no reference back to the sampler, so reference counting frees it
    with the sampler, never the cycle collector, which may run in the
    middle of another graph's capture and would end it."""
    smp = sampler_of(declared(plain_fn))
    params = {"w": torch.tensor(0.3)}
    state = smp.init_state(params, tsm.prng_key(3), 8)
    noise = torch.zeros(smp._sweep_size, 8)
    smp._graphs["held"] = tsm.SweepGraph(smp.log_psi_fn, params, state,
                                         noise, noise, smp._bonds("cpu"))
    held = weakref.ref(smp)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del smp
        assert held() is None
    finally:
        if collecting:
            gc.enable()


def test_replay_adds_the_named_tallies():
    """A replay adds the tallies a forward's declaration names, a process
    counter by its name and a kernel's tally by its (holder, attribute)
    pair; a capture takes back its own change (times -1). The ViT forward
    of ``builder.build`` and the fused GCNN forward name theirs."""
    names = ("vit.sequences", (k2.gcnn_group_sums, "launches_bf16"),
             (k2.gcnn_group_sums, "rows_bf16"))
    before = cuda_graph.tallies(names)
    change = {"vit.sequences": 4.0,
              (k2.gcnn_group_sums, "launches_bf16"): 2,
              (k2.gcnn_group_sums, "rows_bf16"): 512}
    cuda_graph.add_tallies(change, 3)
    got = cuda_graph.tallies(names)
    assert {n: got[n] - before[n] for n in names} == {
        "vit.sequences": 12.0, (k2.gcnn_group_sums, "launches_bf16"): 6,
        (k2.gcnn_group_sums, "rows_bf16"): 1536}
    cuda_graph.add_tallies(change, -3)
    assert cuda_graph.tallies(names) == before
    vit = rule_case("vit_builder")[0].log_psi_fn.graph_safe
    assert vit == cuda_graph.GraphSafe(span="vit", tallies=("vit.sequences",))
    assert set(small_gcnn()[0].graph_safe.tallies) == {
        (k2.gcnn_group_sums, n)
        for n in ("launches", "rows", "launches_bf16", "rows_bf16")}


def test_fused_forward_takes_its_graph_inputs():
    """The fused GCNN forward gives the same log psi from the params and
    from its graph inputs (the expanded weights; nothing packed on the
    CPU)."""
    fwd, params = small_gcnn()
    s = tsm.init_walkers(tsm.prng_key(5), 6, LAT.n_sites, sector="sz0")
    inputs = fwd.graph_inputs(params)
    assert isinstance(inputs, k2.KernelInputs) and inputs.packed is None
    want, got = fwd(params, s), fwd(inputs, s)
    assert torch.equal(want.re, got.re) and torch.equal(want.im, got.im)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _cell(kind):
    """(sampler, params) at the cell's widths: the 10x10 Deep ViT (d 72, 12
    heads, 8 blocks, complex head, f32) at 256 walkers, or the depth-8
    residual bf16 GCNN with its spin-flip sector at 1,024 on K2 bf16."""
    if kind == "vit":
        cfg = load("j1j2_8x8_vit", "lattice.shape=[10,10]",
                   "model.channels=[72,72,72,72,72,72,72,72]",
                   "model.vit_heads=12", "model.spin_flip_sector=0",
                   "sampler.n_walkers=256")
    else:
        cfg = load("j1j2_8x8_gcnn_r2", "sampler.n_walkers=1024")
    vmc, params, _ = builder.build(cfg, device="cuda")
    return vmc.sampler, params, cfg.sampler.n_walkers


def _same(a: tsm.WalkerState, b: tsm.WalkerState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tsm._tensors(a),
                                                 tsm._tensors(b)))


_GRAPH = ("sampler.graph.captures", "sampler.graph.replays",
          "sampler.graph.eager")


def _sample(smp, *args, names=()):
    """``smp.sample(*args)``, the change of the tallies ``names`` and of
    ``sampler.graph.*`` it made, and the names of the spans it recorded."""
    before = cuda_graph.tallies(names + _GRAPH)
    with profiling.recording() as window:
        got = smp.sample(*args)
        torch.cuda.synchronize()
    after = cuda_graph.tallies(names + _GRAPH)
    change = {n: after[n] - before[n] for n in after}
    return got, change, [sp.name for sp in window.spans]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vit", "gcnn"])
def test_graphed_sweep_is_bitwise_the_eager_loop(kind):
    """The graphed sweep equals the eager loop bit for bit (walkers, both
    parts of log psi, both counters) at 1 and 20 sweeps, after the params
    changed (a replay on stale weights would differ) and on injected
    noise; the capture leaves the caller's state as it was; the first call
    runs its first sweep eagerly and captures it, later sweeps replay; the
    tallies the forward names (``vit.sequences``, K2's launches and rows)
    advance by the eager loop's counts; and the replays record one span of
    the forward's (``vit``) around them, so its time stays in that span."""
    dev = _card()
    graphed, params, m = _cell(kind)
    decl = graphed.log_psi_fn.graph_safe
    eager = dataclasses.replace(
        graphed, log_psi_fn=lambda p, s: graphed.log_psi_fn(p, s))
    assert graphed.graphs_sweep(dev) and not eager.graphs_sweep(dev)
    if kind == "gcnn":
        assert isinstance(graphed.log_psi_fn, k2.FusedLogPsi)
        assert graphed.log_psi_fn.compute_dtype == "bfloat16"
    gen = torch.Generator().manual_seed(17)
    moved = {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
             for k, v in params.items()}
    ids = torch.arange(m, device=dev)
    n_props = graphed._sweep_size
    noise = (torch.rand(n_props, m, generator=gen),
             torch.log(torch.rand(n_props, m, generator=gen)))
    state = graphed.init_state(params, tsm.prng_key(29), m, device=dev)
    cases = [(params, 1, None), (params, 20, None), (moved, 1, None),
             (moved, 1, noise)]
    for i, (p, n_sweeps, injected) in enumerate(cases):
        state = graphed.reset_counters(graphed.refresh(p, state))
        held = tsm.tree_map(tsm._clone, state)
        args = (p, state, tsm.fold_in(tsm.prng_key(31), i), ids, n_sweeps,
                injected)
        want, e_change, e_spans = _sample(eager, *args, names=decl.tallies)
        got, g_change, g_spans = _sample(graphed, *args, names=decl.tallies)
        assert _same(state, held), f"case {i}: the input state changed"
        assert _same(got, want), f"case {i}: graph and eager differ"
        assert int(got.n_prop[0]) == n_sweeps * n_props
        assert {n: g_change[n] for n in decl.tallies} == {
            n: e_change[n] for n in decl.tallies}, i
        assert any(e_change[n] > 0 for n in decl.tallies)
        replays = n_sweeps - (i == 0)
        assert e_change["sampler.graph.eager"] == n_sweeps
        assert (g_change["sampler.graph.captures"],
                g_change["sampler.graph.replays"],
                g_change["sampler.graph.eager"]) == (i == 0, replays, 0)
        if kind == "vit":
            assert e_spans.count("vit") == n_sweeps * n_props
            # the first call's eager sweep records its forwards; every
            # call with a replay, one span around its replays
            assert g_spans.count("vit") == (n_props if i == 0 else 1)
        else:
            assert "vit" not in g_spans
        state = got
    if kind == "vit":
        assert g_change["vit.sequences"] == 4 * m * n_props
    else:
        launches = (k2.gcnn_group_sums, "launches_bf16")
        rows = (k2.gcnn_group_sums, "rows_bf16")
        assert (g_change[launches], g_change[rows]) == (n_props,
                                                        2 * m * n_props)
    assert len(graphed._graphs) == 1
    assert float(np.mean(got.n_accept.cpu().numpy())) > 0
