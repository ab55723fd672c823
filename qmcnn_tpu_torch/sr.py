"""Stochastic reconfiguration (natural gradient), port of ``qmcnn_tpu/sr.py``
(solvers 'pcg', 'dense' and single-device 'minsr'; 'cg' is a later slice).

Solves (S + lambda I) delta = F where
  S_kk' = Re[<O_k* O_k'> - <O_k*><O_k'>],   O_k = d log psi / d theta_k,
for real parameters, with F the covariance gradient from
``vmc.energy_and_grad``.

  * ``solver='pcg'`` — materializes the centered score matrices
    (J_re, J_im) [M, P] with one ``torch.func.vmap`` of ``torch.func.grad``
    per component (chunked over samples by ``jacobian_chunk``) and runs
    Jacobi-preconditioned CG whose matvec is two [M, P] matmuls.
  * ``solver='dense'`` — builds S [P, P] and solves by Cholesky, with an
    eigh fallback when f32 Cholesky fails.
  * ``solver='minsr'`` — the sample-space form for P >> M: with the
    stacked centered scores O~ = [O_re; O_im] [2M, P] (real models drop
    O_im) and the centered local energies eps, the push-through identity
    gives delta = O~^T (O~ O~^T / M + shift)^-1 eps / M, the same delta as
    'dense' from a [2M, 2M] Cholesky (Rende et al., arXiv:2310.05715).

Flat parameter order equals ``jax.flatten_util.ravel_pytree``'s: keys
sorted (``bias`` before ``kernel``, ``RealConv_10`` before ``RealConv_2``).

Diagonal shift schedule: lambda(p) = max(lambda0 * b^p, lambda_min).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from qmcnn_tpu_torch.models.cnn import true_f32

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


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # final ||r|| / ||b||


def pcg_flat(matvec: Callable, b: torch.Tensor, inv_diag: torch.Tensor,
             tol: float = 1e-5, maxiter: int = 100) -> CGResult:
    """Jacobi-preconditioned CG on flat [P] vectors. f32-hardened: if an
    iteration produces a non-finite value the previous iterate is kept and
    the loop stops (the guard of the JAX loop)."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = inv_diag * r
    p = z
    rz = torch.dot(r, z)
    b_norm = torch.linalg.norm(b)
    eps = 1e-30
    atol2 = float((tol * b_norm) ** 2)
    k = 0
    while k < maxiter and float(torch.dot(r, r)) > atol2:
        ap = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=eps)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = inv_diag * r_new
        rz_new = torch.dot(r_new, z_new)
        k += 1
        if not bool(torch.isfinite(rz_new) & torch.isfinite(alpha)):
            break
        beta = rz_new / torch.clamp(rz, min=eps)
        p = z_new + beta * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
    res = torch.linalg.norm(r) / torch.clamp(b_norm, min=eps)
    return CGResult(x=x, iters=k, residual=res)


def materialize_jacobian(log_psi_fn, params: Params, s: torch.Tensor,
                         chunk_size: Optional[int] = None,
                         with_im: bool = True):
    """Score matrices (J_re, J_im) [M, P] (uncentered) + the unravel fn.

    ``with_im=False`` skips the imaginary block (returns None) for models
    whose log-amplitude is real for all parameters."""
    _, unravel = ravel(params)
    keys = sorted(params)

    def part(fn):
        g = vmap(grad(fn), in_dims=(None, 0))

        def rows(s_c):
            out = g(params, s_c)
            return torch.cat([out[k].reshape(s_c.shape[0], -1)
                              for k in keys], dim=1)

        m = s.shape[0]
        if chunk_size is None or chunk_size >= m:
            return rows(s)
        if m % chunk_size:
            raise ValueError(f"chunk_size {chunk_size} must divide M={m}")
        return torch.cat([rows(s[i:i + chunk_size])
                          for i in range(0, m, chunk_size)])

    def f_re(p, si):
        return log_psi_fn(p, si[None, :]).re[0]

    def f_im(p, si):
        return log_psi_fn(p, si[None, :]).im[0]

    j_re = part(f_re)
    j_im = part(f_im) if with_im else None
    return j_re, j_im, unravel


class JacobianSOperator(NamedTuple):
    """Centered Jacobian pair + diag(S); matvec = two [M,P] matmuls
    (one when the model is real and oc_im is None)."""

    oc_re: torch.Tensor  # [M, P] centered
    oc_im: Optional[torch.Tensor]
    diag_s: torch.Tensor  # [P]
    m_local: int

    def matvec(self, v: torch.Tensor, diag_shift) -> torch.Tensor:
        out = (self.oc_re @ v) @ self.oc_re
        if self.oc_im is not None:
            out = out + (self.oc_im @ v) @ self.oc_im
        return out / self.m_local + diag_shift * v


def make_jacobian_s(log_psi_fn, params: Params, s: torch.Tensor,
                    chunk_size: Optional[int] = None,
                    with_im: bool = True) -> JacobianSOperator:
    j_re, j_im, _ = materialize_jacobian(log_psi_fn, params, s, chunk_size,
                                         with_im=with_im)
    oc_re = j_re - j_re.mean(dim=0)[None, :]
    diag_s = (oc_re * oc_re).mean(dim=0)
    oc_im = None
    if j_im is not None:
        oc_im = j_im - j_im.mean(dim=0)[None, :]
        diag_s = diag_s + (oc_im * oc_im).mean(dim=0)
    return JacobianSOperator(oc_re=oc_re, oc_im=oc_im, diag_s=diag_s,
                             m_local=s.shape[0])


def resolve_solver(solver: str, m_total: int, n_params: int,
                   real_log_psi: bool) -> str:
    """Resolve solver='auto': 'minsr' when parts * M_total <= P (the dual
    sample-space system is the smaller one), else 'pcg'."""
    if solver != "auto":
        return solver
    parts = 1 if real_log_psi else 2
    return "minsr" if parts * m_total <= n_params else "pcg"


def _minsr_rows(op: JacobianSOperator, e_loc) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Stacked (score rows, centered residual) for the sample-space solve;
    real models drop the identically-zero im rows (Gram [M, M])."""
    if op.oc_im is None:
        return op.oc_re, e_loc.re - e_loc.re.mean()
    return (torch.cat([op.oc_re, op.oc_im], dim=0),
            torch.cat([e_loc.re - e_loc.re.mean(),
                       e_loc.im - e_loc.im.mean()]))


def _minsr_delta(o: torch.Tensor, eps: torch.Tensor, shift,
                 m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta [P], S delta [P]) with delta = O~^T (O~ O~^T / M + shift)^-1
    eps / M, on one device. The Gram matmul runs in full float32."""
    with true_f32():
        gram = (o @ o.T) / m
        gram = gram + shift * torch.eye(o.shape[0], dtype=o.dtype,
                                        device=o.device)
        y = chol_or_eigh_solve(gram, eps, shift)
        delta = (y @ o) / m
        s_delta = (o.T @ (o @ delta)) / m
    return delta, s_delta


def chol_or_eigh_solve(gram: torch.Tensor, rhs: torch.Tensor,
                       shift) -> torch.Tensor:
    """Solve (gram) y = rhs for a shifted-PSD gram, NaN-proof: Cholesky
    first; if it fails or comes back non-finite, an eigh-based solve with
    eigenvalues clipped at the shift."""
    l_fac, info = torch.linalg.cholesky_ex(gram)
    if int(info) == 0:
        rhs2 = rhs[:, None] if rhs.dim() == 1 else rhs
        y = torch.cholesky_solve(rhs2, l_fac)
        y = y[:, 0] if rhs.dim() == 1 else y
        if bool(torch.isfinite(y).all()):
            return y
    w, v = torch.linalg.eigh(gram)
    w = torch.clamp(w, min=max(float(shift), 1e-30))
    w_b = w[:, None] if rhs.dim() == 2 else w
    return v @ ((v.T @ rhs) / w_b)


@dataclasses.dataclass(frozen=True, eq=False)
class SR:
    """SR gradient transform plugged into the VMC step.

    Args:
      solver: 'pcg' (Jacobi-preconditioned, materialized Jacobian),
        'dense' (Cholesky; small nets and the test oracle) or 'minsr'
        (sample-space Cholesky; needs ``e_loc``).
      diag_shift0 / diag_shift_decay / diag_shift_min: lambda schedule.
      proportional_shift: shift = lambda * mean(diag(S)).
      cg_tol, cg_maxiter: pcg stopping criteria.
      jacobian_chunk: sample chunking of the materialized Jacobian.
      real_log_psi: the model's log-amplitude is real for all parameters;
        skips the identically-zero J_im block (bit-identical delta).
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

    def __post_init__(self):
        if self.solver == "cg":
            raise NotImplementedError(
                "sr.solver='cg' is not ported yet (ROADMAP.md); use 'pcg', "
                "'dense' or 'minsr'")
        if self.solver not in ("pcg", "dense", "minsr"):
            raise ValueError(f"unknown solver {self.solver!r}")

    def diag_shift(self, step: int) -> float:
        return max(self.diag_shift0 * self.diag_shift_decay ** int(step),
                   self.diag_shift_min)

    def solve(self, log_psi_fn, params: Params, s: torch.Tensor,
              grads: Params, step: int, e_loc=None):
        """Returns (natural-gradient params dict, iters, residual).
        ``e_loc`` (a C pair) is required by 'minsr', which works on the raw
        residuals; its iters are 0 and its residual is the parameter-space
        ||(S + shift) delta - F|| / ||F||."""
        if self.solver == "minsr" and e_loc is None:
            raise ValueError("solver='minsr' needs e_loc")
        shift = torch.tensor(self.diag_shift(step), dtype=torch.float32,
                             device=s.device)
        op = make_jacobian_s(log_psi_fn, params, s,
                             chunk_size=self.jacobian_chunk,
                             with_im=not self.real_log_psi)
        if self.proportional_shift:
            shift = shift * torch.clamp(op.diag_s.mean(), min=1e-12)
        b, unravel = ravel(grads)
        if self.solver == "minsr":
            o, eps = _minsr_rows(op, e_loc)
            delta, s_delta = _minsr_delta(o, eps, shift, op.m_local)
            resid = torch.linalg.norm(s_delta + shift * delta - b) / \
                torch.clamp(torch.linalg.norm(b), min=1e-30)
            return unravel(delta), 0, resid
        if self.solver == "pcg":
            inv_diag = 1.0 / (op.diag_s + shift)
            r = pcg_flat(lambda v: op.matvec(v, shift), b, inv_diag,
                         tol=self.cg_tol, maxiter=self.cg_maxiter)
            return unravel(r.x), r.iters, r.residual
        s_dense = op.oc_re.T @ op.oc_re
        if op.oc_im is not None:
            s_dense = s_dense + op.oc_im.T @ op.oc_im
        a = s_dense / op.m_local + shift * torch.eye(
            b.shape[0], dtype=b.dtype, device=b.device)
        x = chol_or_eigh_solve(a, b, shift)
        resid = torch.linalg.norm(a @ x - b) / torch.clamp(
            torch.linalg.norm(b), min=1e-30)
        return unravel(x), 0, resid
