"""Time-dependent variational principle (t-VMC): real- and imaginary-time
evolution of the variational state on the ansatz manifold (port of
``qmcnn_tpu/ops/tdvp.py``).

Math (real parameters theta — every parameter is a real float32 leaf,
complex weights being (re, im) leaf pairs, ops/cplx.py):

  O_k(s)  = d log psi / d theta_k = J_re + i J_im        (per-sample scores)
  dE(s)   = E_loc(s) - <E>_w                              (centered residual)
  S       = Re<Oc* Oc>_w   (the quantum geometric tensor's real part)
  F       = <Oc* dE>_w

  imaginary time  d theta/d tau = -S^{-1} Re[F]    (gradient flow; the SR
                                                    step with lr = d tau)
  real time       d theta/d t   = +S^{-1} Im[F]    (McLachlan: S thetadot
                                                    = -Re[i <Oc* dE>] = Im[F])

With the sqrt-weighted stacked score matrix O~ = [sqrt(w) Oc_re;
sqrt(w) Oc_im] (rows 2M), both right-hand sides are O~^T eps for a residual
vector eps built from dE, and the regularized solve

  thetadot = (O~^T O~ + lam)^{-1} O~^T eps = O~^T (O~ O~^T + lam)^{-1} eps

has the same sample-space (minSR) push-through as ``sr.py``'s 'minsr'
[Rende et al., arXiv:2310.05715].

Weights: estimators take explicit normalized weights w (sum over every
rank = 1), so the same code serves MC mode (w = 1/M_total over Metropolis
samples) and full-sum mode (w = |psi(s)|^2 / Z over an enumerated basis:
exact expectations, no MC noise).

The TDVP error epsilon^2 = ||sum_k O_k thetadot_k - target||^2_w /
||target||^2_w (target = -dE resp. -i dE) is returned every step: 0 is an
exact evolution, 1 a flow the manifold cannot carry at all.

Two forwards, as ``VMC`` takes them: ``log_psi_fn`` (the model, which the
Jacobian differentiates) and ``eval_log_psi_fn`` (log psi and E_loc under
``no_grad``; on CUDA the fused kernel of an eligible model). With a walker
``group`` (``parallel.mesh.WalkerGroup``) each rank holds its rows of the
samples and their weights; the weights are normalized over every rank, so
each JAX ``psum`` is a sum over the ranks, and minSR all-gathers the score
rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qmcnn_tpu_torch.models.cnn import true_f32
from qmcnn_tpu_torch.ops.cplx import C
from qmcnn_tpu_torch.ops.local_energy import local_energy
from qmcnn_tpu_torch.sr import chol_or_eigh_solve, materialize_jacobian

Params = dict


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the walker group's ranks; identity when not distributed."""
    return x if group is None else group.sum(x)


def untimed(name: str):
    """The no-op ``timer``: a context that times nothing."""
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# full-summation (exact) sample sets
# ---------------------------------------------------------------------------

def all_states(n_sites: int, sz_zero: bool = False) -> np.ndarray:
    """Enumerate the full computational basis (host-side).

    [D, n_sites] float32 arrays of +-1 spins in the ED basis order
    (``ops/exact.all_configs``); ``sz_zero`` restricts to the sum(s) = 0
    sector. D = 2^N or binom(N, N/2): keep N <= ~16 (or ~18 in-sector).
    """
    if n_sites > 24:
        raise ValueError(f"full summation over 2^{n_sites} states is "
                         f"intractable — use MC sampling")
    from qmcnn_tpu_torch.ops import exact

    s = exact.all_configs(n_sites)
    if sz_zero:
        if n_sites % 2:
            raise ValueError("sz0 sector needs an even number of sites")
        s = s[s.sum(axis=1) == 0]
    return s


def state_weights(log_psi_fn, params, s: torch.Tensor) -> torch.Tensor:
    """Normalized Born weights |psi(s)|^2 / Z over an enumerated basis."""
    with torch.no_grad():
        return torch.softmax(2.0 * log_psi_fn(params, s).re, dim=0)


def expectation(log_psi_fn, params, op, s: torch.Tensor,
                weights: torch.Tensor, group=None,
                chunk_size: Optional[int] = None) -> C:
    """<psi|op|psi>/<psi|psi> estimated as sum_s w_s op_loc(s), summed over
    ``group``'s ranks. ``op`` is any Hamiltonian-like object (diag_batch /
    connected_batch / n_conn)."""
    with torch.no_grad():
        lp = log_psi_fn(params, s)
        o_loc = local_energy(log_psi_fn, params, op, s, lp,
                             chunk_size=chunk_size)
        return C(_psum((weights * o_loc.re).sum(), group),
                 _psum((weights * o_loc.im).sum(), group))


# ---------------------------------------------------------------------------
# the TDVP right-hand side
# ---------------------------------------------------------------------------

class TDVPResult(NamedTuple):
    theta_dot: Params    # matching params
    energy: C            # scalar pair <E>_w
    e_var: torch.Tensor  # <|dE|^2>_w
    tdvp_error: torch.Tensor  # epsilon^2 in [0, 1]
    residual: torch.Tensor    # ||(S+lam) thetadot - b|| / ||b||


@dataclasses.dataclass(frozen=True, eq=False)
class TDVP:
    """The projected flow d theta = rhs(theta, samples) for one Hamiltonian.

    Args:
      log_psi_fn: (params, s [B, N]) -> C [B], the model (differentiated).
      ham: Hamiltonian (ops/hamiltonians.py).
      mode: 'imag' (gradient flow to the ground state) | 'real' (unitary
        quench dynamics; needs an ansatz that can carry phases).
      solver: 'dense' ([P, P] Cholesky) | 'minsr' (sample-space
        [parts * M_total]^2 Cholesky, for P >> M).
      diag_shift: Tikhonov regularization lam, fixed over the run.
      with_im: materialize the J_im score block. Required for mode='real'
        and for any model with complex output; False halves the Jacobian
        for provably-real models in imaginary time.
      jacobian_chunk: sample chunking of the Jacobian.
      chunk_size: walker chunking of the local-energy forward.
      group: the walker group (None: one device).
      eval_log_psi_fn: the evaluation forward of log psi and E_loc (None:
        ``log_psi_fn``).
      timer: ``timer(name)`` context around the parts of ``rhs``
        (``forward``: log psi and E_loc; ``jacobian``; ``solve``).
    """

    log_psi_fn: Callable[..., C]
    ham: Any
    mode: str = "imag"
    solver: str = "minsr"
    diag_shift: float = 1e-4
    with_im: bool = True
    jacobian_chunk: Optional[int] = None
    chunk_size: Optional[int] = None
    group: Any = None
    eval_log_psi_fn: Optional[Callable[..., C]] = None
    timer: Callable = untimed

    def __post_init__(self):
        if self.mode not in ("imag", "real"):
            raise ValueError(f"unknown TDVP mode {self.mode!r}")
        if self.solver not in ("dense", "minsr"):
            raise ValueError(f"unknown TDVP solver {self.solver!r}")
        if self.mode == "real" and not self.with_im:
            raise ValueError("real-time TDVP needs the imaginary score "
                             "block (with_im=True): a real-log-psi manifold "
                             "cannot carry phases, Im[F] would be 0")
        if self.eval_log_psi_fn is None:
            object.__setattr__(self, "eval_log_psi_fn", self.log_psi_fn)

    def rhs(self, params: Params, s: torch.Tensor,
            weights: torch.Tensor) -> TDVPResult:
        """One TDVP solve at the given (samples, weights)."""
        g, fwd = self.group, self.eval_log_psi_fn
        with self.timer("forward"), torch.no_grad():
            lp = fwd(params, s)
            e_loc = local_energy(fwd, params, self.ham, s, lp,
                                 chunk_size=self.chunk_size)
            e_mean = C(_psum((weights * e_loc.re).sum(), g),
                       _psum((weights * e_loc.im).sum(), g))
            de = e_loc - e_mean
            e_var = _psum((weights * de.abs2()).sum(), g)
        with self.timer("jacobian"):
            j_re, j_im, unravel = materialize_jacobian(
                self.log_psi_fn, params, s, self.jacobian_chunk,
                with_im=self.with_im)
        with self.timer("solve"), true_f32():
            x, b_dot, s_dot, resid = self._solve(j_re, j_im, de, weights)
            # epsilon^2 = (||target||^2 - 2 x.b + x.S.x) / ||target||^2,
            # ||target||^2_w = <|dE|^2>_w for both modes (|i dE| = |dE|)
            err = (e_var - 2.0 * b_dot + x @ s_dot) / torch.clamp(
                e_var, min=1e-30)
        return TDVPResult(theta_dot=unravel(x), energy=e_mean, e_var=e_var,
                          tdvp_error=torch.clamp(err, min=0.0),
                          residual=resid)

    def _solve(self, j_re, j_im, de: C, weights: torch.Tensor):
        """(theta_dot [P], x.b, S x, the solver's relative residual)."""
        g = self.group
        # centering with the weights (not SR's uniform mean)
        mean_re = _psum((weights[:, None] * j_re).sum(0), g)
        sw = torch.sqrt(weights)[:, None]
        blocks = [sw * (j_re - mean_re[None, :])]
        if j_im is not None:
            mean_im = _psum((weights[:, None] * j_im).sum(0), g)
            blocks.append(sw * (j_im - mean_im[None, :]))
        o_t = torch.cat(blocks, dim=0)  # [parts * M, P] sqrt-weighted
        swv = torch.sqrt(weights)
        if self.mode == "imag":
            eps = [-swv * de.re]
            if j_im is not None:
                eps.append(-swv * de.im)
        else:
            eps = [swv * de.im, -swv * de.re]
        eps = torch.cat(eps)  # [parts * M]
        shift = self.diag_shift
        if self.solver == "dense":
            s_mat = _psum(o_t.T @ o_t, g)
            b = _psum(o_t.T @ eps, g)
            a = s_mat + shift * torch.eye(b.shape[0], dtype=b.dtype,
                                          device=b.device)
            x = chol_or_eigh_solve(a, b, shift, g)
            s_dot = s_mat @ x
            resid = torch.linalg.norm(a @ x - b)
        else:  # minsr
            if g is None:
                o_full, eps_full = o_t, eps
            else:
                o_full, eps_full = g.all_gather(o_t), g.all_gather(eps)
            rows = o_full.shape[0]
            gram = o_full @ o_full.T + shift * torch.eye(
                rows, dtype=o_t.dtype, device=o_t.device)
            y = chol_or_eigh_solve(gram, eps_full, shift, g)
            x = y @ o_full
            b = o_full.T @ eps_full
            s_dot = o_full.T @ (o_full @ x)
            resid = torch.linalg.norm(s_dot + shift * x - b)
        resid = resid / torch.clamp(torch.linalg.norm(b), min=1e-30)
        return x, x @ b, s_dot, resid

    # -- integrators --------------------------------------------------------

    def step_euler(self, params: Params, dt: float, s: torch.Tensor,
                   weights: torch.Tensor) -> Tuple[Params, TDVPResult]:
        r = self.rhs(params, s, weights)
        return {k: params[k] + dt * r.theta_dot[k] for k in params}, r

    def step_heun(self, params: Params, dt: float, s: torch.Tensor,
                  weights: torch.Tensor,
                  resample: Optional[Callable] = None
                  ) -> Tuple[Params, TDVPResult]:
        """Heun (explicit trapezoid, 2nd order); returns the first stage's
        result.

        ``resample(params) -> (s, weights)`` refreshes the sample set at the
        predictor point (exact reweighting in full-sum mode). None reuses
        (s, weights) for stage 2 (formally O(dt) in the stage-2 estimator,
        fine when the samples change slowly).
        """
        r1 = self.rhs(params, s, weights)
        pred = {k: params[k] + dt * r1.theta_dot[k] for k in params}
        s2, w2 = resample(pred) if resample is not None else (s, weights)
        r2 = self.rhs(pred, s2, w2)
        new = {k: params[k] + 0.5 * dt * (r1.theta_dot[k] + r2.theta_dot[k])
               for k in params}
        return new, r1
