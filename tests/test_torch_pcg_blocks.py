"""pcg as blocks of masked iterations (``qmcnn_tpu_torch/sr.py``:
``pcg_blocks``): on the CPU the eager blocks equal a copy of the
per-iteration loop bitwise (x, iters, the residual) for every block size,
at a stop by convergence, by maxiter inside a block and at its edge, by
the non-finite guard, at b = 0 and at maxiter = 0, on a real and a complex
operator, with the counters ``sr.pcg.blocks`` and ``sr.pcg.overrun``;
``make_jacobian_s(out=)`` centers into the given buffers bitwise as into
new ones; and, on the card (``-m cuda``), the CUDA graph replay equals the
eager blocks and follows new matrices written into its static buffers.
JAX-free."""
import math

import pytest
import torch

from qmcnn_tpu_torch import sr as srmod
from qmcnn_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

BLOCKS = (1, 3, 8, 16)
CASES = ("converge", "maxiter_mid", "maxiter_edge", "nonfinite", "b_zero",
         "maxiter_zero")
#: the matvec call (0: the start's, i: iteration i's) the nonfinite case
#: poisons with NaN
POISON_CALL = 5


def reference_pcg(matvec, b, inv_diag, tol, maxiter) -> srmod.CGResult:
    """The per-iteration loop with no walker group, as ``sr._pcg_loop``
    runs it: a blocking read of its flags after every iteration."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = inv_diag * r
    p = z
    rz = torch.dot(r, z)
    b_norm = torch.linalg.norm(b)
    eps = 1e-30
    atol2, rr = torch.stack([(tol * b_norm) ** 2,
                             torch.dot(r, r)]).tolist()
    k = 0
    more = maxiter > 0 and rr > atol2
    while more:
        ap = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=eps)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = inv_diag * r_new
        rz_new = torch.dot(r_new, z_new)
        k += 1
        good = torch.isfinite(rz_new) & torch.isfinite(alpha)
        bad, rr = torch.stack([(~good).to(b.dtype),
                               torch.dot(r_new, r_new)]).tolist()
        if bad:
            break
        beta = rz_new / torch.clamp(rz, min=eps)
        p = z_new + beta * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
        more = k < maxiter and rr > atol2
    res = torch.linalg.norm(r) / torch.clamp(b_norm, min=eps)
    return srmod.CGResult(x=x, iters=k, residual=res)


class Poisoned:
    """An operator whose matvec returns NaN at one call."""

    def __init__(self, op, at: int):
        self.op, self.at, self.calls = op, at, 0

    def matvec(self, v, shift):
        out = self.op.matvec(v, shift)
        self.calls += 1
        return out * float("nan") if self.calls - 1 == self.at else out


def operator(kind: str, m: int = 24, n: int = 40, seed: int = 0,
             device="cpu"):
    """A centered score operator (real, or with an imaginary block), its
    diag(S) and a right-hand side."""
    g = torch.Generator().manual_seed(seed)
    mats = [torch.randn(m, n, generator=g)
            for _ in range(1 if kind == "real" else 2)]
    mats = [(o - o.mean(dim=0)).to(device) for o in mats]
    diag = sum((o * o).mean(dim=0) for o in mats)
    b = torch.randn(n, generator=g).to(device)
    op = srmod.JacobianSOperator(oc_re=mats[0], oc_im=mats[1] if len(mats) > 1
                                 else None, diag_s=diag, m_local=m)
    return op, b


def case_args(case: str, block: int):
    """(tol, maxiter, poison call or None, zero b) of a case."""
    return {"converge": (2e-3, 200, None, False),
            "maxiter_mid": (1e-12, 2 * block + 1, None, False),
            "maxiter_edge": (1e-12, 2 * block, None, False),
            "nonfinite": (1e-12, 200, POISON_CALL, False),
            "b_zero": (1e-3, 200, None, True),
            "maxiter_zero": (1e-3, 0, None, False)}[case]


def delta(before: dict, name: str) -> float:
    return profiling.counters().get(name, 0.0) - before.get(name, 0.0)


@pytest.mark.parametrize("kind", ("real", "complex"))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block", BLOCKS)
def test_blocks_equal_the_per_iteration_loop(block, case, kind):
    op, b = operator(kind)
    tol, maxiter, poison, zero_b = case_args(case, block)
    if zero_b:
        b = torch.zeros_like(b)
    shift = torch.tensor(0.01)
    inv_diag = 1.0 / (op.diag_s + shift)
    ref_op = op if poison is None else Poisoned(op, poison)
    want = reference_pcg(lambda v: ref_op.matvec(v, shift), b, inv_diag,
                         tol, maxiter)
    got_op = op if poison is None else Poisoned(op, poison)
    before = profiling.counters()
    got = srmod.pcg_blocks(got_op, shift, b, inv_diag, tol=tol,
                           maxiter=maxiter, block=block)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual, want.residual)
    # the case stops where it says
    used = max(1, min(block, maxiter))
    stop = {"converge": lambda k: 0 < k < maxiter and (
                used == 1 or k % used != 0),
            "maxiter_mid": lambda k: k == maxiter and (
                used == 1 or k % used != 0),
            "maxiter_edge": lambda k: k == maxiter and k % used == 0,
            "nonfinite": lambda k: k == POISON_CALL,
            "b_zero": lambda k: k == 0,
            "maxiter_zero": lambda k: k == 0}[case]
    assert stop(want.iters), want.iters
    if zero_b:
        assert not got.x.any()
    # one block per flag read, a block for the entry test when maxiter > 0
    blocks = delta(before, "sr.pcg.blocks")
    want_blocks = 0 if maxiter == 0 else max(1, math.ceil(
        want.iters / used))
    assert blocks == want_blocks
    assert delta(before, "sr.pcg.overrun") == blocks * used - got.iters


@pytest.mark.parametrize("kind", ("real", "complex"))
@pytest.mark.parametrize("chunk", (None, 4))
def test_jacobian_centers_into_the_given_buffers(kind, chunk):
    """``make_jacobian_s(out=)`` writes the centered matrices into the
    buffers, bitwise the matrices it makes without them."""
    torch.manual_seed(1)
    params = {"a": torch.randn(3, 2), "w": torch.randn(2)}
    s = torch.randn(8, 3)

    class Out:
        def __init__(self, re, im):
            self.re, self.im = re, im

    def log_psi_fn(p, s_):
        h = torch.tanh(s_ @ p["a"])
        return Out(h @ p["w"], torch.sin(h).sum(-1) * p["w"][0])

    with_im = kind == "complex"
    want = srmod.make_jacobian_s(log_psi_fn, params, s, chunk_size=chunk,
                                 with_im=with_im)
    bufs = (torch.full((8, 8), float("nan")),
            torch.full((8, 8), float("nan")) if with_im else None)
    got = srmod.make_jacobian_s(log_psi_fn, params, s, chunk_size=chunk,
                                with_im=with_im, out=bufs)
    assert got.oc_re is bufs[0] and got.oc_im is bufs[1]
    assert torch.equal(got.oc_re, want.oc_re)
    assert torch.equal(got.diag_s, want.diag_s)
    if with_im:
        assert torch.equal(got.oc_im, want.oc_im)


def test_graph_refuses_an_operator_off_its_buffers():
    op, b = operator("real")
    graph = srmod.PCGGraph("cpu", 24, 40, torch.float32, False)
    with pytest.raises(ValueError, match="static matrices"):
        srmod.pcg_blocks(op, torch.tensor(0.01), b, 1.0 / op.diag_s,
                         graph=graph)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("real", "complex"))
def test_graph_replay_equals_eager_blocks_on_the_card(kind, capsys):
    """At the flagship's operator shape ([2048, 4800], shift 0.01, tol 1e-4,
    maxiter 200) and on a complex operator of the same shape: three solves
    with new matrices, each written into the graph's static buffers. The
    replay gives the eager blocks' x, iters and residual bitwise (the same
    kernels in the same order on the same stream), its answers follow the
    new matrices, and ``sr.pcg.captures`` goes up once for the shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs")
    dev = torch.device("cuda")
    m, n = 2048, 4800
    graphs = srmod.PCGGraphs()
    before = profiling.counters()
    previous = None
    for trial in range(3):
        op, b = operator(kind, m, n, seed=100 + trial, device=dev)
        op = op._replace(oc_re=op.oc_re / math.sqrt(2.0),
                         oc_im=None if op.oc_im is None
                         else op.oc_im / math.sqrt(2.0))
        graph = graphs.get(dev, m, n, torch.float32, kind == "complex")
        graph.oc_re.copy_(op.oc_re)
        if op.oc_im is not None:
            graph.oc_im.copy_(op.oc_im)
        static = op._replace(oc_re=graph.oc_re, oc_im=graph.oc_im)
        shift = torch.tensor(0.01, device=dev)
        inv_diag = 1.0 / (op.diag_s + shift)
        eager = srmod.pcg_blocks(op, shift, b, inv_diag, tol=1e-4,
                                 maxiter=200)
        replay = srmod.pcg_blocks(static, shift, b, inv_diag, tol=1e-4,
                                  maxiter=200, graph=graph)
        with capsys.disabled():
            print(f"\n{kind} trial {trial}: iters {replay.iters}, "
                  f"residual {float(replay.residual):.3e}")
        assert replay.iters == eager.iters > 0
        assert torch.equal(replay.x, eager.x)
        assert torch.equal(replay.residual, eager.residual)
        if previous is not None:
            assert not torch.equal(replay.x, previous)
        previous = replay.x
    assert delta(before, "sr.pcg.captures") == 1
