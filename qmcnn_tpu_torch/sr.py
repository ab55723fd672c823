"""Stochastic reconfiguration (natural gradient), port of ``qmcnn_tpu/sr.py``.

Solves (S + lambda I) delta = F where
  S_kk' = Re[<O_k* O_k'> - <O_k*><O_k'>],   O_k = d log psi / d theta_k,
for real parameters, with F the covariance gradient from
``vmc.energy_and_grad``.

  * ``solver='cg'`` — matrix-free: S v is one ``torch.func.jvp`` and one
    ``torch.func.vjp`` of the model per iteration; O(P) memory. f32 CG can
    diverge on an ill-conditioned S, so the loop keeps its last finite
    iterate and stops (the JAX ``while_loop``'s guard).
  * ``solver='pcg'`` — materializes the centered score matrices
    (J_re, J_im) [M, P] with one ``torch.func.vmap`` of ``torch.func.grad``
    per component (chunked over samples by ``jacobian_chunk``) and runs
    Jacobi-preconditioned CG whose matvec is two [M, P] matmuls. With no
    walker group the loop runs as blocks of ``PCG_BLOCK`` masked
    iterations with one flag read to the host per block
    (:func:`pcg_blocks`, the JAX ``while_loop``'s ``where`` updates); on a
    card each block is a CUDA graph replayed over static buffers
    (:class:`PCGGraphs`).
  * ``solver='dense'`` — builds S [P, P] and solves by Cholesky, with an
    eigh fallback when f32 Cholesky fails.
  * ``solver='minsr'`` — the sample-space form for P >> M: with the
    stacked centered scores O~ = [O_re; O_im] [2M, P] (real models drop
    O_im) and the centered local energies eps, the push-through identity
    gives delta = O~^T (O~ O~^T / M + shift)^-1 eps / M, the same delta as
    'dense' from a [2M, 2M] Cholesky (Rende et al., arXiv:2310.05715).
  * ``SR.solve_spring`` — minSR with SPRING momentum: the previous step's
    delta is the regularization point, carried by the train state.

Under walker sharding (``group``, a ``parallel.mesh.WalkerGroup``) every
mean is a mean all-reduce, at the JAX package's ``_pmean`` sites, so each
solve is the exact global one: the score column means and diag(S), every
S v, the minSR residual means and the dense S. Distributed minSR assembles
the global Gram by ``minsr_assembly``: 'gather' (all-gather the score rows)
or 'ring' (each rank's score shard broadcast in turn, the [2M_tot, P]
matrix never held). A loop test or a fallback that decides the next
collective is taken from values the ranks agree on.

Flat parameter order equals ``jax.flatten_util.ravel_pytree``'s: keys
sorted (``bias`` before ``kernel``, ``RealConv_10`` before ``RealConv_2``).

Diagonal shift schedule: lambda(p) = max(lambda0 * b^p, lambda_min).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, jvp, vjp, vmap

from qmcnn_tpu_torch.models.cnn import true_f32
from qmcnn_tpu_torch.utils import cuda_graph, debug
from qmcnn_tpu_torch.utils.profiling import annotate, count
from qmcnn_tpu_torch.vmc import pmean as _pmean
from qmcnn_tpu_torch.vmc import pmean_all as _pmean_all

Params = Dict[str, torch.Tensor]


def ravel(params: Params) -> Tuple[torch.Tensor, Callable]:
    """(flat [P] vector in sorted-key order, unravel fn)."""
    keys = sorted(params)
    shapes = [params[k].shape for k in keys]
    sizes = [params[k].numel() for k in keys]
    flat = torch.cat([params[k].reshape(-1) for k in keys])

    def unravel(v: torch.Tensor) -> Params:
        parts = torch.split(v, sizes)
        return {k: p.reshape(sh) for k, p, sh in zip(keys, parts, shapes)}

    return flat, unravel


def _agreed(values: torch.Tensor, group) -> list:
    """Host copies of the 1-D ``values`` that every rank takes its loop
    decisions from: their max over the walker group (one host sync). The
    wait is the span ``sr.pcg.wait``, on the host clock alone."""
    with annotate("sr.pcg.wait", device=False):
        if group is not None:
            values = group.agree(values)
        return values.tolist()


# ---------------------------------------------------------------------------
# PCG (flat, Jacobi-preconditioned, guarded) and CG (params dicts)
# ---------------------------------------------------------------------------

class CGResult(NamedTuple):
    x: object  # flat [P] tensor (pcg) or params dict (cg)
    iters: int
    residual: torch.Tensor  # final ||r|| / ||b||


def pcg_flat(matvec: Callable, b: torch.Tensor, inv_diag: torch.Tensor,
             tol: float = 1e-5, maxiter: int = 100, group=None) -> CGResult:
    """Jacobi-preconditioned CG on flat [P] vectors. f32-hardened: if an
    iteration produces a non-finite value the previous iterate is kept and
    the loop stops (the guard of the JAX loop). With a walker ``group`` the
    loop tests read values agreed over the ranks. The loop is the span
    ``sr.pcg``."""
    with annotate("sr.pcg", device=False):
        return _pcg_loop(matvec, b, inv_diag, tol, maxiter, group)


def _pcg_loop(matvec, b, inv_diag, tol, maxiter, group) -> CGResult:
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = inv_diag * r
    p = z
    rz = torch.dot(r, z)
    b_norm = torch.linalg.norm(b)
    eps = 1e-30
    atol2, rr = _agreed(torch.stack([(tol * b_norm) ** 2, torch.dot(r, r)]),
                        group)
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
        bad, rr = _agreed(torch.stack([(~good).to(b.dtype),
                                       torch.dot(r_new, r_new)]), group)
        if bad:
            break
        beta = rz_new / torch.clamp(rz, min=eps)
        p = z_new + beta * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
        more = k < maxiter and rr > atol2
    res = torch.linalg.norm(r) / torch.clamp(b_norm, min=eps)
    return CGResult(x=x, iters=k, residual=res)


def cg(matvec: Callable, b: Params, tol: float = 1e-5, maxiter: int = 100,
       group=None) -> CGResult:
    """Conjugate gradient on params dicts for a symmetric PSD operator
    (JAX's ``cg``): :func:`pcg_flat` with no preconditioner, so the same
    guard (a non-finite step keeps the previous iterate and stops) and the
    same agreed loop tests."""
    b_flat, unravel = ravel(b)
    r = pcg_flat(lambda v: ravel(matvec(unravel(v)))[0], b_flat,
                 torch.ones_like(b_flat), tol=tol, maxiter=maxiter,
                 group=group)
    return r._replace(x=unravel(r.x))


# ---------------------------------------------------------------------------
# PCG as blocks of masked iterations (no walker group), CUDA graphs
# ---------------------------------------------------------------------------

#: pcg iterations per block when there is no walker group: the host reads
#: the loop's flag once a block, and a block that the stop falls inside runs
#: its remaining iterations masked (the choice against the card's numbers:
#: PERF.md, "pcg on the device")
PCG_BLOCK = 16


class _PCGCarry(NamedTuple):
    """The block loop's state, updated in place: the iterate, residual,
    preconditioned residual and direction [P], r.z, the stopping threshold
    (tol ||b||)^2, the iteration count (int64) and whether the loop runs
    on (bool)."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    atol2: torch.Tensor
    k: torch.Tensor
    active: torch.Tensor

    @staticmethod
    def empty(n: int, dtype, device) -> "_PCGCarry":
        vec = [torch.empty(n, dtype=dtype, device=device) for _ in range(4)]
        return _PCGCarry(*vec, torch.empty((), dtype=dtype, device=device),
                         torch.empty((), dtype=dtype, device=device),
                         torch.empty((), dtype=torch.int64, device=device),
                         torch.empty((), dtype=torch.bool, device=device))


def _pcg_start(op, shift, b, inv_diag, tol, c: _PCGCarry) -> torch.Tensor:
    """Fill the carry as ``_pcg_loop`` starts (x = 0, r = b - A x, ...),
    the entry test rr > atol2 as ``active``; returns ||b||."""
    c.x.zero_()
    c.r.copy_(b - op.matvec(c.x, shift))
    c.z.copy_(inv_diag * c.r)
    c.p.copy_(c.z)
    c.rz.copy_(torch.dot(c.r, c.z))
    b_norm = torch.linalg.norm(b)
    c.atol2.copy_((tol * b_norm) ** 2)
    c.k.zero_()
    torch.gt(torch.dot(c.r, c.r), c.atol2, out=c.active)
    return b_norm


def _pcg_block(op, shift, inv_diag, c: _PCGCarry, maxiter: int,
               block: int) -> torch.Tensor:
    """``block`` iterations of ``_pcg_loop`` on the device alone: each
    computes the same ops in the same order, keeps its new values only
    where the loop is active and the step finite (``good``), counts where
    active, and stops the loop on the device (not good, k = maxiter or
    rr <= atol2). Once stopped, the carry stays bitwise as it is. Returns
    [k, active] (int64), the flag the host reads."""
    eps = 1e-30
    for _ in range(block):
        ap = op.matvec(c.p, shift)
        alpha = c.rz / torch.clamp(torch.dot(c.p, ap), min=eps)
        x_new = c.x + alpha * c.p
        r_new = c.r - alpha * ap
        z_new = inv_diag * r_new
        rz_new = torch.dot(r_new, z_new)
        good = torch.isfinite(rz_new) & torch.isfinite(alpha)
        rr = torch.dot(r_new, r_new)
        beta = rz_new / torch.clamp(c.rz, min=eps)
        p_new = z_new + beta * c.p
        keep = c.active & good
        for new, old in ((x_new, c.x), (r_new, c.r), (z_new, c.z),
                         (p_new, c.p), (rz_new, c.rz)):
            torch.where(keep, new, old, out=old)
        c.k.add_(c.active)
        torch.logical_and(keep, (c.k < maxiter) & (rr > c.atol2),
                          out=c.active)
    return torch.stack([c.k, c.active.to(c.k.dtype)])


class PCGGraph:
    """One operator shape's pcg on a card: static buffers for the centered
    score matrices, the preconditioner, the shift and the carry, which
    every solve of the shape writes into, and each block of masked
    iterations captured once as a CUDA graph over them and replayed."""

    def __init__(self, device, m: int, n: int, dtype, with_im: bool):
        self.device = torch.device(device)
        self.oc_re = torch.empty((m, n), dtype=dtype, device=device)
        self.oc_im = torch.empty_like(self.oc_re) if with_im else None
        self.inv_diag = torch.empty(n, dtype=dtype, device=device)
        self.shift = torch.empty((), dtype=dtype, device=device)
        self.carry = _PCGCarry.empty(n, dtype, device)
        # the matvec of the static matrices (diag(S) is not read by it)
        self.op = JacobianSOperator(oc_re=self.oc_re, oc_im=self.oc_im,
                                    diag_s=self.inv_diag, m_local=m)
        self._blocks: dict = {}

    @property
    def matrices(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The buffers ``make_jacobian_s(out=...)`` centers into."""
        return self.oc_re, self.oc_im

    def block(self, maxiter: int, block: int) -> Callable[[], torch.Tensor]:
        """A function that replays the block (captured at its first call
        with these arguments) and returns its flag tensor."""
        got = self._blocks.get((maxiter, block))
        if got is None:
            got = self._blocks[(maxiter, block)] = self._capture(maxiter,
                                                                 block)
            count("sr.pcg.captures")
        graph, flag = got

        def replay() -> torch.Tensor:
            graph.replay()
            return flag

        return replay

    def _capture(self, maxiter: int, block: int):
        c = self.carry

        def run():
            return _pcg_block(self.op, self.shift, self.inv_diag, c,
                              maxiter, block)

        def warm_up():
            # every iteration masked, so the carry stays as it is
            active = c.active.clone()
            c.active.fill_(False)
            run()
            c.active.copy_(active)

        graph, flag, _ = cuda_graph.capture(run, warm_up, self.device)
        return graph, flag


class PCGGraphs:
    """An SR solver's :class:`PCGGraph` per (device, M, P, dtype, whether
    there is an imaginary block)."""

    def __init__(self):
        self._shapes: dict = {}

    def get(self, device, m: int, n: int, dtype, with_im: bool) -> PCGGraph:
        """The card ``device``'s graph of the shape, made at first use."""
        device = torch.device(device)
        key = (device, m, n, dtype, with_im)
        got = self._shapes.get(key)
        if got is None:
            got = self._shapes[key] = PCGGraph(device, m, n, dtype, with_im)
        return got


def pcg_blocks(op, shift, b: torch.Tensor, inv_diag: torch.Tensor,
               tol: float = 1e-5, maxiter: int = 100, block: int = PCG_BLOCK,
               graph: Optional[PCGGraph] = None) -> CGResult:
    """:func:`pcg_flat` with no walker group on the operator ``op``
    (``op.matvec(v, shift)``), run as blocks of min(``block``, maxiter)
    masked iterations (:func:`_pcg_block`), with one flag read to the host
    (the span ``sr.pcg.wait``) per block: x, iters and the residual equal
    ``pcg_flat``'s bitwise, whatever the block. With a ``graph`` whose
    static matrices ``op`` is built on, the blocks replay as its CUDA
    graphs; else they run eagerly. Counts ``sr.pcg.blocks`` and
    ``sr.pcg.overrun`` (iterations run masked after the stop). The loop is
    the span ``sr.pcg``."""
    with annotate("sr.pcg", device=False):
        block = max(1, min(block, maxiter))
        if graph is None:
            c = _PCGCarry.empty(b.shape[0], b.dtype, b.device)
        else:
            if op.oc_re.data_ptr() != graph.oc_re.data_ptr():
                raise ValueError("pcg_blocks: op must hold the graph's "
                                 "static matrices (make_jacobian_s(out=))")
            graph.inv_diag.copy_(inv_diag)
            graph.shift.copy_(shift)
            op, shift, inv_diag, c = (graph.op, graph.shift, graph.inv_diag,
                                      graph.carry)
        b_norm = _pcg_start(op, shift, b, inv_diag, tol, c)
        blocks, k, active = 0, 0, maxiter > 0
        if active:
            run = (graph.block(maxiter, block) if graph is not None else
                   lambda: _pcg_block(op, shift, inv_diag, c, maxiter, block))
        while active:
            k, active = _agreed(run(), None)
            blocks += 1
        count("sr.pcg.blocks", blocks)
        count("sr.pcg.overrun", blocks * block - k)
        res = torch.linalg.norm(c.r) / torch.clamp(b_norm, min=1e-30)
        return CGResult(x=c.x if graph is None else c.x.clone(), iters=k,
                        residual=res)


# ---------------------------------------------------------------------------
# S operators
# ---------------------------------------------------------------------------

def make_s_matvec(log_psi_fn, params: Params, s: torch.Tensor, diag_shift,
                  group=None) -> Callable:
    """Matrix-free (S + lambda I) matvec on params dicts (the 'cg'
    backend): S v = Re[J^dag J v] / M - Re[<O>^* <J v>], with J v a
    ``torch.func.jvp`` and J^T w a ``torch.func.vjp`` of the model (JAX:
    ``jax.linearize`` and ``linear_transpose``). Its means all-reduce in one
    collective per product."""
    m_local = s.shape[0]

    def f(p):
        out = log_psi_fn(p, s)
        return out.re, out.im

    _, f_vjp = vjp(f, params)
    keys = sorted(params)
    # <O> as a (re, im) pair of params dicts: Re[J^dag w] with w = (1/M, 0)
    # gives its re part, with (0, 1/M) its im part
    ones = torch.ones(m_local, device=s.device) / m_local
    zeros = torch.zeros(m_local, device=s.device)
    (obar_re,) = f_vjp((ones, zeros))
    (obar_im,) = f_vjp((zeros, ones))
    means = _pmean_all([obar_re[k] for k in keys] + [obar_im[k] for k in keys],
                       group)
    obar_re = dict(zip(keys, means[:len(keys)]))
    obar_im = dict(zip(keys, means[len(keys):]))

    def matvec(v: Params) -> Params:
        _, (t_re, t_im) = jvp(f, (params,), (v,))  # J v as (re, im) [M]
        (jtv,) = f_vjp((t_re / m_local, t_im / m_local))  # Re[J^dag J v]/M
        *jtv_all, m_re, m_im = _pmean_all(
            [jtv[k] for k in keys] + [t_re.mean(), t_im.mean()], group)
        return {k: a - (obar_re[k] * m_re + obar_im[k] * m_im)
                + diag_shift * v[k] for k, a in zip(keys, jtv_all)}

    return matvec


def materialize_jacobian(log_psi_fn, params: Params, s: torch.Tensor,
                         chunk_size: Optional[int] = None,
                         with_im: bool = True, out=None):
    """Score matrices (J_re, J_im) [M, P] (uncentered) + the unravel fn.

    ``with_im=False`` skips the imaginary block (returns None) for models
    whose log-amplitude is real for all parameters. ``out``: a pair of
    [M, P] buffers (the second None without the imaginary block) that the
    matrices are written into, in place of new ones."""
    _, unravel = ravel(params)
    keys = sorted(params)

    def part(fn, buf):
        g = vmap(grad(fn), in_dims=(None, 0))

        def rows(s_c, dest=None):
            grads = g(params, s_c)
            return torch.cat([grads[k].reshape(s_c.shape[0], -1)
                              for k in keys], dim=1, out=dest)

        m = s.shape[0]
        if chunk_size is None or chunk_size >= m:
            return rows(s, buf)
        if m % chunk_size:
            raise ValueError(f"chunk_size {chunk_size} must divide M={m}")
        return torch.cat([rows(s[i:i + chunk_size])
                          for i in range(0, m, chunk_size)], out=buf)

    def f_re(p, si):
        return log_psi_fn(p, si[None, :]).re[0]

    def f_im(p, si):
        return log_psi_fn(p, si[None, :]).im[0]

    out_re, out_im = (None, None) if out is None else out
    j_re = part(f_re, out_re)
    j_im = part(f_im, out_im) if with_im else None
    return j_re, j_im, unravel


class JacobianSOperator(NamedTuple):
    """Centered Jacobian pair + diag(S); matvec = two [M,P] matmuls
    (one when the model is real and oc_im is None), mean-reduced over the
    walker group."""

    oc_re: torch.Tensor  # [M, P] centered
    oc_im: Optional[torch.Tensor]
    diag_s: torch.Tensor  # [P] diagonal of the *global* S
    m_local: int
    group: object = None

    def matvec(self, v: torch.Tensor, diag_shift) -> torch.Tensor:
        out = (self.oc_re @ v) @ self.oc_re
        if self.oc_im is not None:
            out = out + (self.oc_im @ v) @ self.oc_im
        return _pmean(out / self.m_local, self.group) + diag_shift * v


def make_jacobian_s(log_psi_fn, params: Params, s: torch.Tensor,
                    chunk_size: Optional[int] = None,
                    with_im: bool = True, group=None,
                    out=None) -> JacobianSOperator:
    """The centered score matrices and diag(S) (the span
    ``sr.jacobian``), centered in place, into the [M, P] buffers ``out``
    where given (:attr:`PCGGraph.matrices`)."""
    with annotate("sr.jacobian"):
        j_re, j_im, _ = materialize_jacobian(log_psi_fn, params, s,
                                             chunk_size, with_im=with_im,
                                             out=out)
        means = _pmean_all([j.mean(dim=0) for j in (j_re, j_im)
                            if j is not None], group)
        oc_re = j_re.sub_(means[0][None, :])
        diag_s = (oc_re * oc_re).mean(dim=0)
        oc_im = None
        if j_im is not None:
            oc_im = j_im.sub_(means[1][None, :])
            diag_s = diag_s + (oc_im * oc_im).mean(dim=0)
        return JacobianSOperator(oc_re=oc_re, oc_im=oc_im,
                                 diag_s=_pmean(diag_s, group),
                                 m_local=s.shape[0], group=group)


def resolve_solver(solver: str, m_total: int, n_params: int,
                   real_log_psi: bool) -> str:
    """Resolve solver='auto': 'minsr' when parts * M_total <= P (the dual
    sample-space system is the smaller one), else 'pcg'."""
    if solver != "auto":
        return solver
    parts = 1 if real_log_psi else 2
    return "minsr" if parts * m_total <= n_params else "pcg"


def _minsr_rows(op: JacobianSOperator, e_loc, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked (score rows, centered residual) for the sample-space solve;
    real models drop the identically-zero im rows (Gram [M, M])."""
    if op.oc_im is None:
        return op.oc_re, e_loc.re - _pmean(e_loc.re.mean(), group)
    m_re, m_im = _pmean_all([e_loc.re.mean(), e_loc.im.mean()], group)
    return (torch.cat([op.oc_re, op.oc_im], dim=0),
            torch.cat([e_loc.re - m_re, e_loc.im - m_im]))


def _minsr_delta(o: torch.Tensor, eps: torch.Tensor, shift, m_local: int,
                 group=None, assembly: str = "gather"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta [P], S delta [P]) with delta = O~^T (O~ O~^T / M + shift)^-1
    eps / M, the push-through solution of (S + shift) delta = O~^T eps / M.
    The Gram and its solve run in full float32.

    With a walker group the Gram is the global [2M_tot, 2M_tot] one, the
    same on every rank: 'gather' all-gathers the score rows (memory
    O(2M_tot P) per rank); 'ring' never holds them — round r broadcasts
    rank r's shard and every rank fills its Gram block (rank, r), so the
    peak is O(2M_loc P + (2M_tot)^2) (JAX moves the shards by ppermute;
    a broadcast per round runs on NCCL and gloo alike). The span
    ``sr.minsr``."""
    with annotate("sr.minsr", device=False), true_f32():
        if group is None:
            gram = (o @ o.T) / m_local
            gram = gram + shift * torch.eye(o.shape[0], dtype=o.dtype,
                                            device=o.device)
            y = chol_or_eigh_solve(gram, eps, shift)
            delta = (y @ o) / m_local
            s_delta = (o.T @ (o @ delta)) / m_local
            return delta, s_delta
        n, rank = group.world_size, group.rank
        m_total = m_local * n
        o = o.contiguous()
        eps_all = group.all_gather(eps)
        if assembly == "gather":
            o_full = group.all_gather(o)                         # [2M_tot, P]
            cols = (o_full @ o.T) / m_total                 # [2M_tot, 2M_loc]
            gram = group.all_gather(cols, dim=1)
        else:
            m2 = o.shape[0]
            row = torch.empty((m2, m2 * n), dtype=o.dtype, device=o.device)
            for src in range(n):
                held = o if src == rank else torch.empty_like(o)
                group.broadcast(held, src)
                row[:, src * m2:(src + 1) * m2] = o @ held.T   # block (rank, src)
            gram = group.all_gather(row / m_total)
        gram = gram + shift * torch.eye(gram.shape[0], dtype=o.dtype,
                                        device=o.device)
        y = chol_or_eigh_solve(gram, eps_all, shift, group)
        if assembly == "gather":
            delta = (y @ o_full) / m_total
            s_delta = (o_full.T @ (o_full @ delta)) / m_total
        else:
            m2 = o.shape[0]
            y_local = y[rank * m2:(rank + 1) * m2]
            delta = group.sum(y_local @ o) / m_total
            s_delta = group.sum(o.T @ (o @ delta)) / m_total
    return delta, s_delta


def chol_or_eigh_solve(gram: torch.Tensor, rhs: torch.Tensor, shift,
                       group=None) -> torch.Tensor:
    """Solve (gram) y = rhs for a shifted-PSD gram, NaN-proof: Cholesky
    first; if it fails or comes back non-finite, an eigh-based solve with
    eigenvalues clipped at the shift. Under a walker group every rank holds
    the same gram and takes the fallback if any rank would."""
    l_fac, info = torch.linalg.cholesky_ex(gram)
    y = None
    if int(info) == 0:
        rhs2 = rhs[:, None] if rhs.dim() == 1 else rhs
        y = torch.cholesky_solve(rhs2, l_fac)
        y = y[:, 0] if rhs.dim() == 1 else y
        bad = not bool(torch.isfinite(y).all())
    else:
        bad = True
    if group is not None:
        bad = bool(group.agree(torch.tensor(float(bad), device=gram.device)))
    if not bad:
        return y
    w, v = torch.linalg.eigh(gram)
    w = torch.clamp(w, min=max(float(shift), 1e-30))
    w_b = w[:, None] if rhs.dim() == 2 else w
    return v @ ((v.T @ rhs) / w_b)


@dataclasses.dataclass(frozen=True, eq=False)
class SR:
    """SR gradient transform plugged into the VMC step.

    Args:
      solver: 'pcg' (Jacobi-preconditioned, materialized Jacobian), 'cg'
        (matrix-free, O(P) memory), 'dense' (Cholesky; small nets and the
        test oracle) or 'minsr' (sample-space Cholesky; needs ``e_loc``).
      diag_shift0 / diag_shift_decay / diag_shift_min: lambda schedule.
      proportional_shift: shift = lambda * mean(diag(S)) ('pcg', 'dense',
        'minsr').
      cg_tol, cg_maxiter: pcg and cg stopping criteria.
      jacobian_chunk: sample chunking of the materialized Jacobian.
      real_log_psi: the model's log-amplitude is real for all parameters;
        skips the identically-zero J_im block (bit-identical delta).
      minsr_assembly: the distributed minSR Gram's assembly, 'gather' or
        'ring' (the same delta; one rank ignores it).
      momentum: SPRING's mu ('minsr' only; 0 = plain SR), used through
        :meth:`solve_spring` with the previous step's delta carried in
        ``TrainState.sr_aux`` (Goldshlager, Abrahamsen & Lin,
        arXiv:2401.10190).
    """

    solver: str = "pcg"
    diag_shift0: float = 1.0
    diag_shift_decay: float = 0.95
    diag_shift_min: float = 1e-2
    proportional_shift: bool = False
    cg_tol: float = 1e-4
    cg_maxiter: int = 100
    jacobian_chunk: Optional[int] = None
    real_log_psi: bool = False
    minsr_assembly: str = "gather"
    momentum: float = 0.0
    #: pcg's CUDA graphs and their static buffers, per operator shape
    graphs: PCGGraphs = dataclasses.field(default_factory=PCGGraphs,
                                          init=False, repr=False)

    def __post_init__(self):
        if self.solver not in ("pcg", "cg", "dense", "minsr"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.minsr_assembly not in ("gather", "ring"):
            raise ValueError(
                f"unknown minsr_assembly {self.minsr_assembly!r}")

    def diag_shift(self, step: int) -> float:
        return max(self.diag_shift0 * self.diag_shift_decay ** int(step),
                   self.diag_shift_min)

    def solve(self, log_psi_fn, params: Params, s: torch.Tensor,
              grads: Params, step: int, e_loc=None, group=None):
        """Returns (natural-gradient params dict, iters, residual).
        ``e_loc`` (a C pair) is required by 'minsr', which works on the raw
        residuals; its iters are 0 and its residual is the parameter-space
        ||(S + shift) delta - F|| / ||F||. ``group``: the walker group
        (``s`` and ``e_loc`` hold this rank's walkers, ``grads`` the global
        gradient)."""
        if self.solver == "minsr" and e_loc is None:
            raise ValueError("solver='minsr' needs e_loc")
        shift = torch.tensor(self.diag_shift(step), dtype=torch.float32,
                             device=s.device)
        if self.solver == "cg":
            matvec = make_s_matvec(log_psi_fn, params, s, shift, group)
            r = cg(matvec, grads, tol=self.cg_tol, maxiter=self.cg_maxiter,
                   group=group)
            return r.x, r.iters, r.residual
        b, unravel = ravel(grads)
        graph = None
        if (self.solver == "pcg" and group is None
                and s.device.type == "cuda" and not debug.active()):
            graph = self.graphs.get(s.device, s.shape[0], b.shape[0],
                                    b.dtype, not self.real_log_psi)
        op = make_jacobian_s(log_psi_fn, params, s,
                             chunk_size=self.jacobian_chunk,
                             with_im=not self.real_log_psi, group=group,
                             out=None if graph is None else graph.matrices)
        if self.proportional_shift:
            shift = shift * torch.clamp(op.diag_s.mean(), min=1e-12)
        if self.solver == "minsr":
            o, eps = _minsr_rows(op, e_loc, group)
            delta, s_delta = _minsr_delta(o, eps, shift, op.m_local, group,
                                          self.minsr_assembly)
            resid = torch.linalg.norm(s_delta + shift * delta - b) / \
                torch.clamp(torch.linalg.norm(b), min=1e-30)
            return unravel(delta), 0, resid
        if self.solver == "pcg":
            inv_diag = 1.0 / (op.diag_s + shift)
            if group is None:
                r = pcg_blocks(op, shift, b, inv_diag, tol=self.cg_tol,
                               maxiter=self.cg_maxiter, graph=graph)
            else:
                r = pcg_flat(lambda v: op.matvec(v, shift), b, inv_diag,
                             tol=self.cg_tol, maxiter=self.cg_maxiter,
                             group=group)
            return unravel(r.x), r.iters, r.residual
        s_dense = op.oc_re.T @ op.oc_re
        if op.oc_im is not None:
            s_dense = s_dense + op.oc_im.T @ op.oc_im
        a = _pmean(s_dense / op.m_local, group) + shift * torch.eye(
            b.shape[0], dtype=b.dtype, device=b.device)
        x = chol_or_eigh_solve(a, b, shift, group)
        resid = torch.linalg.norm(a @ x - b) / torch.clamp(
            torch.linalg.norm(b), min=1e-30)
        return unravel(x), 0, resid

    def solve_spring(self, log_psi_fn, params: Params, s: torch.Tensor,
                     grads: Params, step: int, delta_prev: torch.Tensor,
                     e_loc=None, group=None):
        """The SPRING update: (delta params dict, iters 0, residual, new
        flat delta [P] to carry as ``TrainState.sr_aux``).

        delta = mu delta_prev + argmin_x ||O~ x - (eps - mu O~ delta_prev)||^2
        / M + shift ||x||^2, i.e. (S + shift) delta = F + shift mu
        delta_prev; at mu = 0 it is :meth:`solve`'s minSR delta. The
        residual is reported against that right-hand side. Under a walker
        group ``delta_prev`` is the replicated carry: S (mu delta_prev) is
        a per-rank mean followed by a mean all-reduce, and every rank gets
        the same delta."""
        if self.solver != "minsr":
            raise ValueError("SPRING momentum requires solver='minsr' "
                             f"(got {self.solver!r})")
        if e_loc is None:
            raise ValueError("solve_spring needs e_loc")
        mu = self.momentum
        shift = torch.tensor(self.diag_shift(step), dtype=torch.float32,
                             device=s.device)
        op = make_jacobian_s(log_psi_fn, params, s,
                             chunk_size=self.jacobian_chunk,
                             with_im=not self.real_log_psi, group=group)
        if self.proportional_shift:
            shift = shift * torch.clamp(op.diag_s.mean(), min=1e-12)
        o, eps = _minsr_rows(op, e_loc, group)
        b, unravel = ravel(grads)
        with true_f32():
            # the momentum tail t = O~ (mu delta_prev) per local row, and
            # its projection S (mu delta_prev), reused for the residual
            t = o @ (mu * delta_prev)
            s_mu = _pmean((o.T @ t) / op.m_local, group)
        x, s_x = _minsr_delta(o, eps - t, shift, op.m_local, group,
                              self.minsr_assembly)
        delta = x + mu * delta_prev
        b_spring = b + shift * mu * delta_prev
        resid = torch.linalg.norm(s_x + s_mu + shift * delta - b_spring) / \
            torch.clamp(torch.linalg.norm(b_spring), min=1e-30)
        return unravel(delta), 0, resid, delta
