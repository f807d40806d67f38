"""Augmented KKT system assembly, residuals and step recovery, over a batch.

Port of ``ipopt_tpu/kkt.py`` (``StdAugSystemSolver``,
``IpStdAugSystemSolver.hpp:140-172``; ``PDFullSpaceSolver``).  Every function
takes tensors with a leading batch axis B and returns per-lane results; the
augmented matrix of each lane is

      [ W + D_x + delta_x I      0         J_c^T      J_d^T ]
      [        0            D_s + delta_s    0         -I   ]
      [       J_c                0       -delta_c I     0   ]
      [       J_d               -I           0     -delta_d I]

ordered [x, s, y_c, y_d] (``ipopt_tpu/kkt.py:231-259``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .types import Iterate, KKTResiduals, col, max_init, min_init
from .problem import CanonicalNLP
from .profiling import span


def _mtv(J, y):
    """J^T y per lane: J (B, m, n), y (B, m) -> (B, n), in J's dtype."""
    return torch.matmul(y.to(J.dtype).unsqueeze(-2), J).squeeze(-2)


class Evals(NamedTuple):
    """Cached NLP evaluations at a point.  The dense backend materializes
    the Jacobians J_c (B, me, n) and J_d (B, mi, n); a chained problem never
    does, and keeps the evaluation point ``x`` instead, from which
    ``jac_t`` takes the transpose products by a vector-Jacobian product
    (``ipopt_tpu/kkt.py:53-73``)."""

    f: Any
    grad_f: Any
    c: Any
    d: Any
    J_c: Any = None
    J_d: Any = None
    x: Any = None


def evaluate(nlp: CanonicalNLP, x) -> Evals:
    if nlp.chain is not None and nlp.struct.fd_jac_eps:
        raise NotImplementedError(
            "jacobian_approximation='finite-difference-values' needs "
            "the dense backend (structured backends are matrix-free)")
    with span("eval"):
        if nlp.chain is not None:
            c, d = nlp.eval_cd(x)
            return gradient_evals(nlp, x, nlp.eval_f(x), c, d)
        f, grad_f, c, d, J_c, J_d = nlp.eval_all(x)
    return Evals(f=f, grad_f=grad_f, c=c, d=d, J_c=J_c, J_d=J_d)


def gradient_evals(nlp: CanonicalNLP, x, f, c, d) -> Evals:
    """``Evals`` at x from known f, c and d: adds the gradient and, on the
    dense backend, the Jacobians."""
    if nlp.chain is not None:
        return Evals(f=f, grad_f=nlp.eval_grad_f(x), c=c, d=d, x=x)
    _, grad_f, _, _, J_c, J_d = nlp.eval_all(x)
    return Evals(f=f, grad_f=grad_f, c=c, d=d, J_c=J_c, J_d=J_d)


def jac_t(nlp: CanonicalNLP, ev: Evals, y_c, y_d):
    """J_c^T y_c + J_d^T y_d per lane at the point of ``ev``."""
    with span("eval.jac_t"):
        if nlp.chain is not None:
            # in the evaluation point's dtype, returned in ``ev``'s (a float32
            # view of float64 evaluations keeps the float64 point)
            x = ev.x
            return nlp.eval_jac_t(x, y_c.to(x.dtype), y_d.to(x.dtype)).to(ev.grad_f.dtype)
        return _mtv(ev.J_c, y_c) + _mtv(ev.J_d, y_d)


# ---------------------------------------------------------------------------
# Slacks and barrier quantities
# ---------------------------------------------------------------------------

def slacks(nlp: CanonicalNLP, it: Iterate):
    """Masked slack vectors; 1.0 where a bound is absent."""
    one = torch.ones((), dtype=it.x.dtype, device=it.x.device)
    sl_xL = torch.where(nlp.has_xL, it.x - nlp.x_L, one)
    sl_xU = torch.where(nlp.has_xU, nlp.x_U - it.x, one)
    sl_sL = torch.where(nlp.has_dL, it.s - nlp.d_L, one)
    sl_sU = torch.where(nlp.has_dU, nlp.d_U - it.s, one)
    return sl_xL, sl_xU, sl_sL, sl_sU


def _msum(mask, v):
    return torch.where(mask, v, torch.zeros_like(v)).sum(-1)


def barrier_obj(nlp: CanonicalNLP, it: Iterate, f_val, mu, kappa_d=1e-5):
    """phi_mu = f - mu * sum(log(slacks)) + kappa_d * mu * linear damping."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    logs = (_msum(nlp.has_xL, torch.log(sl_xL))
            + _msum(nlp.has_xU, torch.log(sl_xU))
            + _msum(nlp.has_dL, torch.log(sl_sL))
            + _msum(nlp.has_dU, torch.log(sl_sU)))
    damp = (_msum(nlp.has_xL & ~nlp.has_xU, sl_xL)
            + _msum(nlp.has_xU & ~nlp.has_xL, sl_xU)
            + _msum(nlp.has_dL & ~nlp.has_dU, sl_sL)
            + _msum(nlp.has_dU & ~nlp.has_dL, sl_sU))
    return f_val - mu * logs + kappa_d * mu * damp


def _mwhere(mask, v):
    return torch.where(mask, v, torch.zeros_like(v))


def grad_barrier_x(nlp: CanonicalNLP, it: Iterate, grad_f, mu, kappa_d=1e-5):
    """d phi_mu / dx (without constraint terms)."""
    sl_xL, sl_xU, _, _ = slacks(nlp, it)
    m = col(mu)
    kd = torch.zeros_like(grad_f) + kappa_d * m
    g = grad_f
    g = g - _mwhere(nlp.has_xL, m / sl_xL)
    g = g + _mwhere(nlp.has_xU, m / sl_xU)
    g = g - _mwhere(nlp.has_xL & ~nlp.has_xU, kd)
    g = g + _mwhere(nlp.has_xU & ~nlp.has_xL, kd)
    return g


def grad_barrier_s(nlp: CanonicalNLP, it: Iterate, mu, kappa_d=1e-5):
    _, _, sl_sL, sl_sU = slacks(nlp, it)
    m = col(mu)
    kd = torch.zeros_like(sl_sL) + kappa_d * m
    g = -_mwhere(nlp.has_dL, m / sl_sL)
    g = g + _mwhere(nlp.has_dU, m / sl_sU)
    g = g - _mwhere(nlp.has_dL & ~nlp.has_dU, kd)
    g = g + _mwhere(nlp.has_dU & ~nlp.has_dL, kd)
    return g


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------

def kkt_residuals(nlp: CanonicalNLP, it: Iterate, ev: Evals, mu) -> KKTResiduals:
    """Raw 8-block KKT residuals (IpoptCalculatedQuantities curr_*_resid)."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    m = col(mu)
    grad_lag_x = ev.grad_f + jac_t(nlp, ev, it.y_c, it.y_d) - it.z_L + it.z_U
    grad_lag_s = -it.y_d - it.v_L + it.v_U
    return KKTResiduals(
        grad_lag_x=grad_lag_x,
        grad_lag_s=grad_lag_s,
        c=ev.c,
        d_minus_s=ev.d - it.s,
        compl_x_L=_mwhere(nlp.has_xL, sl_xL * it.z_L - m),
        compl_x_U=_mwhere(nlp.has_xU, sl_xU * it.z_U - m),
        compl_s_L=_mwhere(nlp.has_dL, sl_sL * it.v_L - m),
        compl_s_U=_mwhere(nlp.has_dU, sl_sU * it.v_U - m),
    )


def norm_inf(v):
    """Max-norm over the last axis; 0 for an empty axis."""
    return max_init(v.abs(), 0.0)


def error_scaling(nlp: CanonicalNLP, it: Iterate, s_max):
    """(s_d, s_c) of ComputeOptimalityErrorScaling
    (IpIpoptCalculatedQuantities.cpp:3664-3698)."""
    n_mults_c = (nlp.has_xL.sum(-1) + nlp.has_xU.sum(-1)
                 + nlp.has_dL.sum(-1) + nlp.has_dU.sum(-1))
    sum_z = (_msum(nlp.has_xL, it.z_L.abs())
             + _msum(nlp.has_xU, it.z_U.abs())
             + _msum(nlp.has_dL, it.v_L.abs())
             + _msum(nlp.has_dU, it.v_U.abs()))
    sum_y = it.y_c.abs().sum(-1) + it.y_d.abs().sum(-1)
    n_mults_d = n_mults_c + it.y_c.shape[-1] + it.y_d.shape[-1]
    one = torch.ones_like(sum_y)
    s_c = torch.where(n_mults_c > 0,
                      torch.clamp(sum_z / torch.clamp(n_mults_c, min=1), min=s_max) / s_max,
                      one)
    s_d = torch.where(n_mults_d > 0,
                      torch.clamp((sum_z + sum_y) / torch.clamp(n_mults_d, min=1),
                                  min=s_max) / s_max,
                      one)
    return s_d, s_c


def optimality_error(nlp: CanonicalNLP, it: Iterate, res: KKTResiduals,
                     s_max=100.0):
    """E_mu per Waechter-Biegler eq. (5) with the s_d/s_c scaling.

    Returns (E, dual_inf, primal_inf, compl_inf), each (B,)."""
    s_d, s_c = error_scaling(nlp, it, s_max)
    dual_inf = torch.maximum(norm_inf(res.grad_lag_x), norm_inf(res.grad_lag_s))
    primal_inf = torch.maximum(norm_inf(res.c), norm_inf(res.d_minus_s))
    compl_inf = torch.maximum(
        torch.maximum(norm_inf(res.compl_x_L), norm_inf(res.compl_x_U)),
        torch.maximum(norm_inf(res.compl_s_L), norm_inf(res.compl_s_U)))
    E = torch.maximum(torch.maximum(dual_inf / s_d, primal_inf), compl_inf / s_c)
    return E, dual_inf, primal_inf, compl_inf


# ---------------------------------------------------------------------------
# Augmented system
# ---------------------------------------------------------------------------

class SigmaBlocks(NamedTuple):
    sigma_x: Any  # (B, n)
    sigma_s: Any  # (B, mi)


def sigmas(nlp: CanonicalNLP, it: Iterate) -> SigmaBlocks:
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    sigma_x = (_mwhere(nlp.has_xL, it.z_L / sl_xL)
               + _mwhere(nlp.has_xU, it.z_U / sl_xU))
    sigma_s = (_mwhere(nlp.has_dL, it.v_L / sl_sL)
               + _mwhere(nlp.has_dU, it.v_U / sl_sU))
    return SigmaBlocks(sigma_x, sigma_s)


def assemble_aug_system(W, J_c, J_d, sigma: SigmaBlocks,
                        delta_x, delta_s, delta_c, delta_d):
    """Dense augmented KKT matrices (B, N, N), ordering [x, s, y_c, y_d].
    The deltas are per-lane (B,) tensors."""
    B, n, _ = W.shape
    mi = sigma.sigma_s.shape[-1]
    me = J_c.shape[-2]
    N = n + mi + me + mi
    K = W.new_zeros((B, N, N))
    ar_n = torch.arange(n, device=W.device)
    K[:, :n, :n] = W
    K[:, ar_n, ar_n] = W[:, ar_n, ar_n] + (sigma.sigma_x + col(delta_x))
    s0, c0, d0 = n, n + mi, n + mi + me
    ar_mi = torch.arange(mi, device=W.device)
    ar_me = torch.arange(me, device=W.device)
    K[:, s0 + ar_mi, s0 + ar_mi] = sigma.sigma_s + col(delta_s)
    K[:, c0:d0, :n] = J_c
    K[:, :n, c0:d0] = J_c.transpose(-1, -2)
    K[:, c0 + ar_me, c0 + ar_me] = (-col(delta_c)) * torch.ones(
        (B, me), dtype=W.dtype, device=W.device)
    K[:, d0:, :n] = J_d
    K[:, :n, d0:] = J_d.transpose(-1, -2)
    K[:, d0 + ar_mi, s0 + ar_mi] = -1.0
    K[:, s0 + ar_mi, d0 + ar_mi] = -1.0
    K[:, d0 + ar_mi, d0 + ar_mi] = (-col(delta_d)) * torch.ones(
        (B, mi), dtype=W.dtype, device=W.device)
    return K


def condensed_rhs_parts(nlp: CanonicalNLP, it: Iterate, ev: Evals, mu,
                        kappa_d=1e-5):
    """The four (negated) RHS blocks of the augmented system:
    (-r_x, -r_s, -c, -(d - s)), in the evaluations' dtype (float64 ones
    over a float32 iterate under refinement_precision="double")."""
    r_x = (grad_barrier_x(nlp, it, ev.grad_f, mu, kappa_d)
           + jac_t(nlp, ev, it.y_c, it.y_d))
    r_s = (grad_barrier_s(nlp, it, mu, kappa_d) - it.y_d).to(ev.c.dtype)
    return -r_x, -r_s, -ev.c, -(ev.d - it.s)


def split_aug_solution(sol, n, mi, me):
    return (sol[..., :n], sol[..., n:n + mi], sol[..., n + mi:n + mi + me],
            sol[..., n + mi + me:])


def recover_bound_mult_steps(nlp: CanonicalNLP, it: Iterate, dx, ds, mu):
    """Back-substitute the eliminated complementarity rows."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    m = col(mu)
    dz_L = _mwhere(nlp.has_xL, m / sl_xL - it.z_L - it.z_L / sl_xL * dx)
    dz_U = _mwhere(nlp.has_xU, m / sl_xU - it.z_U + it.z_U / sl_xU * dx)
    dv_L = _mwhere(nlp.has_dL, m / sl_sL - it.v_L - it.v_L / sl_sL * ds)
    dv_U = _mwhere(nlp.has_dU, m / sl_sU - it.v_U + it.v_U / sl_sU * ds)
    return dz_L, dz_U, dv_L, dv_U


def fraction_to_boundary(nlp: CanonicalNLP, it: Iterate, step: Iterate, tau):
    """(alpha_max^pr, alpha_max^dual) per lane: the largest alpha in (0, 1]
    keeping var + alpha*d >= (1-tau)*slack."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    t = col(tau)

    def limit(slack, d, active):
        one = torch.ones_like(d)
        neg = active & (d < 0)
        safe_d = torch.where(neg, d, -one)
        a = torch.where(neg, -t * slack / safe_d, one)
        return min_init(a, 1.0)

    a_x = torch.minimum(limit(sl_xL, step.x, nlp.has_xL),
                        limit(sl_xU, -step.x, nlp.has_xU))
    a_s = torch.minimum(limit(sl_sL, step.s, nlp.has_dL),
                        limit(sl_sU, -step.s, nlp.has_dU))
    alpha_primal = torch.clamp(torch.minimum(a_x, a_s), max=1.0)
    a_z = torch.minimum(limit(it.z_L, step.z_L, nlp.has_xL),
                        limit(it.z_U, step.z_U, nlp.has_xU))
    a_v = torch.minimum(limit(it.v_L, step.v_L, nlp.has_dL),
                        limit(it.v_U, step.v_U, nlp.has_dU))
    alpha_dual = torch.clamp(torch.minimum(a_z, a_v), max=1.0)
    return alpha_primal, alpha_dual
