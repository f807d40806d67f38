"""Matrix-free step computation, over a batch (port of
``ipopt_tpu/algorithm/matrix_free.py``; ``linear_solver="minres"``).

The augmented system

    [ W + Sig_x + dx I    0        Jc^T   Jd^T ] [dx ]   [ r1 ]
    [ 0               Sig_s + dx    0     -I   ] [ds ] = [ r2 ]
    [ Jc                  0       -dc I    0   ] [dyc]   [ r3 ]
    [ Jd                 -I         0    -dc I ] [dyd]   [ r4 ]

is solved by MINRES with operator products only: W v is a Hessian-vector
product of the Lagrangian (``torch.func.jvp`` of its gradient), J v and
J^T u are a JVP and a VJP of the constraints.  In place of the inertia
(no factorization exists) the inertia-free curvature test of
IpPDFullSpaceSolver.cpp:592-637 decides, with the PDPerturbationHandler's
delta_x escalation on failure.

Each lane runs its own MINRES and retry loop; the loops run while any lane
is active, and a lane that is done keeps its values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, jvp, vmap

from ..types import Iterate, col, tree_where
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool
from ..kkt import Evals, sigmas, condensed_rhs_parts, recover_bound_mult_steps
from .step import StepResult, perturbation_start


class AdProducts(NamedTuple):
    """The operator products at an iterate, per lane: W v, (J_c v, J_d v)
    and J_c^T u_c + J_d^T u_d."""
    Wv: object
    Jv: object
    JTu: object


def ad_products(nlp: CanonicalNLP, it: Iterate) -> AdProducts:
    """AD operator products at ``it`` (no matrix is formed)."""
    x = it.x
    lane = nlp.lane()

    def hvp1(x1, yc, yd, ln, v1):
        g = grad(lambda xx: nlp.lag1(xx, yc, yd, ln))
        return jvp(g, (x1,), (v1,))[1]

    def Wv(v):
        return vmap(hvp1)(x, it.y_c, it.y_d, lane, v)

    def Jv(v):
        return jvp(nlp.eval_cd, (x,), (v,))[1]

    def JTu(uc, ud):
        return nlp.eval_jac_t(x, uc, ud)

    return AdProducts(Wv, Jv, JTu)


def _make_operator(nlp: CanonicalNLP, it: Iterate, delta_x, delta_c):
    """The augmented-system product (B, N) -> (B, N) for per-lane deltas
    (``matrix_free.py:43-96``); returns (matvec, sigmas)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    sig = sigmas(nlp, it)
    ad = ad_products(nlp, it)
    dxc, dcc = col(delta_x), col(delta_c)

    def matvec(w):
        dx, ds = w[:, :n], w[:, n:n + mi]
        dyc, dyd = w[:, n + mi:n + mi + me], w[:, n + mi + me:]
        jc, jd = ad.Jv(dx)
        o_x = ad.Wv(dx) + (sig.sigma_x + dxc) * dx + ad.JTu(dyc, dyd)
        o_s = (sig.sigma_s + dxc) * ds - dyd
        o_c = jc - dcc * dyc
        o_d = jd - ds - dcc * dyd
        return torch.cat([o_x, o_s, o_c, o_d], -1)

    return matvec, sig


def _dot(a, b):
    return (a * b).sum(-1)


def minres(matvec, b, maxiter: int, rtol):
    """MINRES (Paige-Saunders) per lane for symmetric, possibly indefinite
    A x = b, b (B, N); ``rtol`` a float or (B,).  Returns (x, relres)."""
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    B = b.shape[0]
    beta0 = torch.linalg.vector_norm(b, dim=-1)
    bnorm = torch.clamp(beta0, min=eps)
    zero = b.new_zeros((B,))
    c = dict(k=torch.zeros((B,), dtype=torch.int64, device=b.device),
             x=torch.zeros_like(b), r1=torch.zeros_like(b), r2=b,
             w0=torch.zeros_like(b), w1=torch.zeros_like(b),
             beta=beta0, beta_prev=torch.ones_like(zero), dbar=zero, epsln=zero,
             phibar=beta0, cs=-torch.ones_like(zero), sn=zero)
    while True:
        active = (c["k"] < maxiter) & (c["phibar"] > rtol * bnorm)
        if not host_bool(active.any()):
            break
        beta = c["beta"]
        v = c["r2"] / col(torch.clamp(beta, min=eps))
        y = matvec(v)
        y = y - col(beta / torch.clamp(c["beta_prev"], min=eps)) * c["r1"]
        alpha = _dot(v, y)
        y = y - col(alpha / torch.clamp(beta, min=eps)) * c["r2"]
        beta_next = torch.linalg.vector_norm(y, dim=-1)
        # previous rotation
        oldeps = c["epsln"]
        delta = c["cs"] * c["dbar"] + c["sn"] * alpha
        gbar = c["sn"] * c["dbar"] - c["cs"] * alpha
        epsln = c["sn"] * beta_next
        dbar = -c["cs"] * beta_next
        # current rotation
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_next * beta_next), min=eps)
        cs = gbar / gamma
        sn = beta_next / gamma
        phi = cs * c["phibar"]
        phibar = sn * c["phibar"]
        w = (v - col(oldeps) * c["w0"] - col(delta) * c["w1"]) / col(gamma)
        new = dict(k=c["k"] + 1, x=c["x"] + col(phi) * w, r1=c["r2"], r2=y,
                   w0=c["w1"], w1=w, beta=beta_next, beta_prev=beta, dbar=dbar,
                   epsln=epsln, phibar=phibar, cs=cs, sn=sn)
        c = {k: tree_where(active, new[k], c[k]) for k in c}
    return c["x"], c["phibar"] / bnorm


def mf_search_direction(nlp: CanonicalNLP, opts: Options, it: Iterate,
                        ev: Evals, mu, delta_w_last) -> StepResult:
    """The matrix-free step with the inertia-free curvature test and the
    delta_x retry loop (``matrix_free.py:168-241``)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    rhs = torch.cat(condensed_rhs_parts(nlp, it, ev, mu, opts.kappa_d), -1)
    delta_cd = torch.clamp(opts.jacobian_regularization_value
                           * mu ** opts.jacobian_regularization_exponent,
                           min=opts.jacobian_regularization_value)
    curv_tol = max(opts.neg_curv_test_tol, 1e-11)
    maxiter = min(4 * (n + 2 * mi + me), 400)
    Wv = ad_products(nlp, it).Wv

    def attempt(delta_x):
        matvec, sig = _make_operator(nlp, it, delta_x, delta_cd)
        sol, relres = minres(matvec, rhs, maxiter, opts.residual_ratio_singular)
        dx, ds = sol[:, :n], sol[:, n:n + mi]
        # inertia-free test: curvature of the regularized Hessian block
        curv = (_dot(dx, Wv(dx)) + _dot((sig.sigma_x + col(delta_x)) * dx, dx)
                + _dot((sig.sigma_s + col(delta_x)) * ds, ds))
        nrm2 = _dot(dx, dx) + _dot(ds, ds)
        ok = (curv >= curv_tol * nrm2) & (relres <= opts.residual_ratio_singular)
        return sol, ok, relres

    zero = torch.zeros_like(mu)
    sol, ok, rr = attempt(zero)
    delta_x = zero
    trials = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    gave_up = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    start, inc = perturbation_start(opts, delta_w_last)
    while True:
        active = ~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)
        if not host_bool(active.any()):
            break
        new_dx = torch.where(delta_x == 0, start, delta_x * inc)
        sol2, ok2, rr2 = attempt(new_dx)
        trials, delta_x, sol, ok, rr, gave_up = tree_where(
            active, (trials + 1, new_dx, sol2, ok2, rr2,
                     new_dx > opts.max_hessian_perturbation),
            (trials, delta_x, sol, ok, rr, gave_up))

    failed = ~ok
    dx, ds = sol[:, :n], sol[:, n:n + mi]
    dyc, dyd = sol[:, n + mi:n + mi + me], sol[:, n + mi + me:]
    dz_L, dz_U, dv_L, dv_U = recover_bound_mult_steps(nlp, it, dx, ds, mu)
    step = Iterate(x=dx, s=ds, y_c=dyc, y_d=dyd,
                   z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
    step = tree_where(failed, Iterate(*(torch.zeros_like(v) for v in step)), step)
    new_last = torch.where(delta_x > 0, delta_x, delta_w_last)
    return StepResult(step=step, delta_x=delta_x, delta_c=delta_cd,
                      delta_w_last=new_last, failed=failed, num_trials=trials,
                      residual_ratio=rr, fac=None, K=None)
