"""Inexact-step algorithm, over a batch (``inexact_algorithm=True``; port of
``ipopt_tpu/algorithm/inexact.py``, after Curtis, Schenk and Waechter, SIAM
J. Sci. Comput. 32(6), 2010, and the reference's ``src/Algorithm/Inexact/``):

- the normal step v toward feasibility (InexactDoglegNormalStep): a dogleg
  between the Cauchy point of 0.5 ||c + A v||^2 and an inexact Newton
  least-squares step (CG on A A^T), inside ||v|| <= omega ||A^T c||;
  omega grows 10x while the region is inactive;
- the step decomposition policy (always / adaptive / switch-once): the
  constraint rows ask for A d = A v (decomposed) or A d = -c, with the
  adaptive bit per lane in the solver's carry;
- the total step by MINRES on the slack-scaled primal-dual system, with the
  tangential component condition, the three termination tests, the delta_x
  escalation on failure and the pure normal step as the fallback;
- the penalty line search on phi + nu ||(c, d-s)||_2 with the exact nu
  update and the flexible interval [nu_low, nu] (InexactLSAcceptor).

All operators are AD products (``matrix_free.ad_products``); the slacks are
scaled by S = min(slack, slack_scale_max) (InexactCq::curr_scaling_slacks).
Each lane runs its own loops; a lane that is done keeps its values.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate, col, tree_where
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool
from ..kkt import (Evals, sigmas, slacks, barrier_obj, grad_barrier_x,
                   grad_barrier_s, fraction_to_boundary,
                   recover_bound_mult_steps, condensed_rhs_parts)
from .step import StepResult, perturbation_start
from .matrix_free import ad_products, minres


class InexactAux(NamedTuple):
    """What the penalty line search needs from the step, per lane."""
    uWu: Any                  # curvature of the tangential part
    tangential_norm: Any      # ||u|| (slack-scaled)
    norm_cplusAd: Any         # ||(c + Jc dx, (d-s) + Jd dx - ds)||_2
    theta2: Any               # ||(c, d-s)||_2 at the current point
    grad_barr_t_delta: Any    # grad phi . (dx, ds)


def _sq(v):
    return (v * v).sum(-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _scaling_slacks(nlp: CanonicalNLP, it: Iterate, opts: Options):
    """S, the scaling of the slack variables (IpInexactCq.cpp:90-125): the
    distance to the nearer bound capped at ``slack_scale_max``, 1 where
    unbounded; ones with ``inexact_linear_system_scaling="none"``."""
    if opts.inexact_linear_system_scaling == "none":
        return torch.ones_like(it.s)
    _, _, sl_sL, sl_sU = slacks(nlp, it)
    one = torch.ones_like(it.s)
    S = torch.where(nlp.has_dL & nlp.has_dU, torch.minimum(sl_sL, sl_sU),
                    torch.where(nlp.has_dL, sl_sL, torch.where(nlp.has_dU, sl_sU, one)))
    S = torch.clamp(S, max=opts.slack_scale_max)
    return torch.clamp(S, min=torch.finfo(it.x.dtype).tiny)


def _cg(matvec, b, maxiter: int, rtol):
    """Plain CG per lane for the SPD normal-step system, b (B, M)."""
    tiny = torch.finfo(b.dtype).tiny
    bnorm = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=tiny)
    c = dict(k=torch.zeros((b.shape[0],), dtype=torch.int64, device=b.device),
             x=torch.zeros_like(b), r=b, p=b, rs=_dot(b, b))
    while True:
        active = (c["k"] < maxiter) & (torch.sqrt(c["rs"]) > rtol * bnorm)
        if not host_bool(active.any()):
            break
        Ap = matvec(c["p"])
        alpha = c["rs"] / torch.clamp(_dot(c["p"], Ap), min=tiny)
        x = c["x"] + col(alpha) * c["p"]
        r = c["r"] - col(alpha) * Ap
        rs_new = _dot(r, r)
        p = r + col(rs_new / torch.clamp(c["rs"], min=tiny)) * c["p"]
        new = dict(k=c["k"] + 1, x=x, r=r, p=p, rs=rs_new)
        c = {k: tree_where(active, new[k], c[k]) for k in c}
    return c["x"]


def decomposition_initial_cn(opts: Options, batch: int = 1, device=None):
    """The first compute_normal bit per lane (IpInexactSearchDirCalc.cpp:
    54-69): None for "always" (static: always decomposed), False (B,) for
    "adaptive" and "switch-once"."""
    if opts.inexact_step_decomposition == "always":
        return None
    return torch.zeros((batch,), dtype=torch.bool, device=device)


def decomposition_next_cn(opts: Options, cn, alpha_primal_test):
    """The bit after an accepted step size (IpInexactLSAcceptor.cpp:450-470):
    a small step activates the decomposition; with "adaptive" a large one
    deactivates it again, with "switch-once" it stays on."""
    if cn is None:
        return None
    nxt = cn | (alpha_primal_test < opts.inexact_decomposition_activate_tol)
    if opts.inexact_step_decomposition == "adaptive":
        nxt = torch.where(cn & (alpha_primal_test
                                > opts.inexact_decomposition_inactivate_tol),
                          torch.zeros_like(cn), nxt)
    return nxt


def inexact_search_direction(nlp: CanonicalNLP, opts: Options, it: Iterate,
                             ev: Evals, mu, delta_w_last, tr_omega, nu,
                             compute_normal=None, last_ls_count=None):
    """The dogleg normal step and the inexact total step
    (``inexact.py:159-474``).  ``compute_normal`` is the per-lane bit, or
    None when always decomposed.  Returns (StepResult, new tr_omega,
    InexactAux)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    dtype = it.x.dtype
    tiny = torch.finfo(dtype).tiny
    eps_m = torch.finfo(dtype).eps
    sig = sigmas(nlp, it)
    S = _scaling_slacks(nlp, it, opts)
    c = ev.c
    dms = ev.d - it.s
    theta2 = torch.sqrt(_sq(c) + _sq(dms))
    cn = (torch.ones_like(theta2, dtype=torch.bool) if compute_normal is None
          else compute_normal)
    ad = ad_products(nlp, it)

    # the slack-scaled constraint operator A (x, s~) -> (c rows, d rows)
    def A(vx, vs):
        jc, jd = ad.Jv(vx)
        return jc, jd - S * vs

    def AT(uc, ud):
        return ad.JTu(uc, ud), -S * ud

    # --- the Cauchy step of 0.5 ||(c, dms) + A v||^2 ------------------------
    g_x, g_s = AT(c, dms)
    g_norm2 = _sq(g_x) + _sq(g_s)
    g_norm = torch.sqrt(g_norm2)
    Ag_c, Ag_d = A(g_x, g_s)
    Ag_norm2 = torch.clamp(_sq(Ag_c) + _sq(Ag_d), min=tiny)
    alpha_cs = torch.minimum(tr_omega, g_norm2 / Ag_norm2)
    vc_x, vc_s = -col(alpha_cs) * g_x, -col(alpha_cs) * g_s

    # --- the Newton least-squares step: (A A^T + dn) w = -(c, dms), v = A^T w
    dn = 1e-10

    def AAt(u):
        uc, ud = u[:, :me], u[:, me:]
        tx, ts = AT(uc, ud)
        rc, rd = A(tx, ts)
        return torch.cat([rc + dn * uc, rd + dn * ud], -1)

    w = _cg(AAt, -torch.cat([c, dms], -1), min(me + mi, opts.inexact_normal_max_iter),
            opts.inexact_normal_tol)
    vn_x, vn_s = AT(w[:, :me], w[:, me:])

    # --- the dogleg inside ||v|| <= omega ||A^T c|| -------------------------
    tr_radius = tr_omega * g_norm
    vn_norm = torch.sqrt(_sq(vn_x) + _sq(vn_s))
    vc_norm = torch.sqrt(_sq(vc_x) + _sq(vc_s))
    cauchy_hits_tr = alpha_cs == tr_omega
    newton_inside = vn_norm <= tr_radius
    # the segment v_c + lam (v_n - v_c) crossing the trust region
    cdotn = _dot(vn_x, vc_x) + _dot(vn_s, vc_s)
    a_q = torch.clamp(vn_norm ** 2 - 2 * cdotn + vc_norm ** 2, min=tiny)
    b_q = 2 * (cdotn - vn_norm ** 2)
    c_q = vn_norm ** 2 - tr_radius ** 2
    disc = torch.clamp(b_q * b_q - 4 * a_q * c_q, min=0.0)
    lam = col(torch.clamp((-b_q - torch.sqrt(disc)) / (2 * a_q), 0.0, 1.0))
    vd_x = (1 - lam) * vn_x + lam * vc_x
    vd_s = (1 - lam) * vn_s + lam * vc_s
    hit, inside = col(cauchy_hits_tr), col(newton_inside)
    v_x = torch.where(hit, vc_x, torch.where(inside, vn_x, vd_x))
    v_s = torch.where(hit, vc_s, torch.where(inside, vn_s, vd_s))
    feasible_already = theta2 <= 1e-12
    use_v = col(cn & ~feasible_already)
    v_x = torch.where(use_v, v_x, torch.zeros_like(v_x))
    v_s = torch.where(use_v, v_s, torch.zeros_like(v_s))
    tr_inactive = feasible_already | newton_inside
    new_omega = torch.where(tr_inactive, torch.clamp(10.0 * tr_omega, max=opts.omega_max),
                            tr_omega)

    # --- the total step: MINRES on the scaled primal-dual system ------------
    parts = condensed_rhs_parts(nlp, it, ev, mu, opts.kappa_d)
    Av_c, Av_d = A(v_x, v_s)
    cnc = col(cn)
    rows_c = torch.where(cnc, Av_c, -c)
    rows_d = torch.where(cnc, Av_d, -dms)
    N = n + mi + me + mi
    rhs = torch.cat([parts[0], S * parts[1], rows_c, rows_d], -1)
    delta_cd = (opts.jacobian_regularization_value
                * mu ** opts.jacobian_regularization_exponent)
    tcc_tol = opts.tcc_theta * mu ** opts.tcc_theta_mu_exponent
    # inexact_desired_pd_residual_iter widens MINRES's iteration budget
    maxiter = min(4 * N, max(400, opts.inexact_desired_pd_residual_iter))
    # the target relative residual, tied to mu (the reference's SMART tests
    # tighten with the NLP error)
    pd_rtol = torch.clamp(torch.clamp(0.01 * mu, min=100.0 * eps_m),
                          max=opts.inexact_desired_pd_residual)

    # --- current-point norms for the termination tests ----------------------
    gphi_x = grad_barrier_x(nlp, it, ev.grad_f, mu, opts.kappa_d)
    gphi_s = grad_barrier_s(nlp, it, mu, opts.kappa_d)
    tt2_x, tt2_s = AT(it.y_c, it.y_d)
    tt2_x = gphi_x + tt2_x
    tt2_s = S * gphi_s + tt2_s
    curr_tt2 = torch.sqrt(_sq(tt2_x) + _sq(tt2_s))
    cAv_norm = torch.sqrt(_sq(c + Av_c) + _sq(dms + Av_d))
    curr_tt1 = torch.sqrt(curr_tt2 ** 2 + torch.where(cn, cAv_norm, theta2) ** 2)
    try_tt2 = g_norm <= opts.tt_eps2 * curr_tt2
    sigma_mrc = opts.rho * opts.tt_eps3
    s_sig = S * sig.sigma_s * S
    dcc = col(delta_cd)

    def attempt(delta_x):
        dxc = col(delta_x)
        s_diag = s_sig + (col(mu) * dxc if opts.modify_hessian_with_slacks else dxc)

        def matvec(wv):
            dx, dst = wv[:, :n], wv[:, n:n + mi]
            dyc, dyd = wv[:, n + mi:n + mi + me], wv[:, n + mi + me:]
            o_x = ad.Wv(dx) + (sig.sigma_x + dxc) * dx + ad.JTu(dyc, dyd)
            o_st = s_diag * dst - S * dyd
            rc, rd = A(dx, dst)
            return torch.cat([o_x, o_st, rc - dcc * dyc, rd - dcc * dyd], -1)

        sol, relres = minres(matvec, rhs, maxiter, pd_rtol)
        dx, dst = sol[:, :n], sol[:, n:n + mi]
        dyc, dyd = sol[:, n + mi:n + mi + me], sol[:, n + mi + me:]
        # --- the tangential component condition ---------------------------
        u_x, u_s = dx - v_x, dst - v_s
        u_nrm2 = _sq(u_x) + _sq(u_s)
        v_nrm2 = _sq(v_x) + _sq(v_s)
        v_nrm = torch.sqrt(v_nrm2)
        Wu_x = ad.Wv(u_x) + (sig.sigma_x + dxc) * u_x
        Wu_s = (s_sig + dxc) * u_s
        uWu = _dot(u_x, Wu_x) + _dot(u_s, Wu_s)
        tcc1 = u_nrm2 <= opts.tcc_psi ** 2 * v_nrm2
        tcc2a = 0.5 * uWu >= tcc_tol * u_nrm2
        # TCC2b, decomposed only (IpInexactPDTerminationTester.cpp:465-483)
        gphi_u = _dot(gphi_x, u_x) + _dot(S * gphi_s, u_s)
        vWu = _dot(v_x, Wu_x) + _dot(v_s, Wu_s)
        tcc2b = gphi_u + vWu + 0.5 * uWu <= opts.tcc_zeta * v_nrm
        tcc = torch.where(cn, tcc1 | (tcc2a & tcc2b), tcc1 | tcc2a)
        # --- the residual pieces ------------------------------------------
        resid = rhs - matvec(sol)
        rho_norm = torch.linalg.vector_norm(resid[:, :n + mi], dim=-1)
        Ad_c, Ad_d = A(dx, dst)
        cAd_norm = torch.sqrt(_sq(c + Ad_c) + _sq(dms + Ad_d))
        # --- TT1: residual and model reduction -----------------------------
        tt1_res = torch.where(
            cn, rho_norm <= opts.tt_kappa1 * curr_tt1,
            torch.linalg.vector_norm(resid, dim=-1) <= opts.tt_kappa1 * curr_tt1)
        delta_m = (-(_dot(gphi_x, dx) + _dot(S * gphi_s, dst))
                   + nu * (theta2 - cAd_norm))
        base_m = torch.maximum(0.5 * uWu, tcc_tol * u_nrm2)
        mrc_rhs = torch.where(cn, base_m + sigma_mrc * nu * (theta2 - cAv_norm),
                              base_m + sigma_mrc * nu
                              * torch.maximum(theta2, cAd_norm - theta2))
        tt1 = tcc & tt1_res & (delta_m >= mrc_rhs - 10 * eps_m)
        # --- TT2: sufficient dual progress ---------------------------------
        dtt_x, dtt_s = AT(dyc, dyd)
        tt2_norm = torch.sqrt(_sq(tt2_x + dtt_x) + _sq(tt2_s + dtt_s))
        tt2 = try_tt2 & (tt2_norm <= opts.tt_kappa2 * curr_tt2)
        # --- TT3: linearized feasibility gain ------------------------------
        tt3 = torch.where(
            cn, tcc & (rho_norm <= opts.tt_kappa1 * curr_tt1)
            & (theta2 - cAd_norm >= opts.tt_eps3 * (theta2 - cAv_norm)),
            tcc & (rho_norm <= opts.tt_kappa1 * theta2)
            & (cAd_norm <= opts.tt_kappa1 * theta2))
        # a MINRES breakdown (residual far past the asked inexactness) fails
        relres_ok = relres <= torch.clamp(1.01 * pd_rtol, min=opts.residual_ratio_singular)
        ok = (tt1 | tt2 | tt3) & relres_ok
        return sol, ok, relres, uWu, torch.sqrt(u_nrm2)

    zero = torch.zeros_like(mu)
    start, inc = perturbation_start(opts, delta_w_last)
    # inexact_regularization_ls_count_trigger (IpInexactPDSolver.cpp:47-52,
    # 150-160): a long line search in the previous iteration pre-perturbs
    delta_x = zero
    if last_ls_count is not None:
        delta_x = torch.where(
            last_ls_count > opts.inexact_regularization_ls_count_trigger, start, zero)
    sol, ok, rr, uWu, u_norm = attempt(delta_x)
    trials = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    gave_up = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    while True:
        active = ~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)
        if not host_bool(active.any()):
            break
        new_dx = torch.where(delta_x == 0, start, delta_x * inc)
        res2 = attempt(new_dx)
        trials, delta_x, sol, ok, rr, uWu, u_norm, gave_up = tree_where(
            active, (trials + 1, new_dx) + res2 + (new_dx > opts.max_hessian_perturbation,),
            (trials, delta_x, sol, ok, rr, uWu, u_norm, gave_up))

    # termination test 3's fallback: the pure normal step (d = v, dy = 0)
    # when the perturbation loop could not satisfy the tests
    normal_only = ~ok
    no = col(normal_only)
    dx = torch.where(no, v_x, sol[:, :n])
    dst = torch.where(no, v_s, sol[:, n:n + mi])
    dyc = torch.where(no, torch.zeros_like(c), sol[:, n + mi:n + mi + me])
    dyd = torch.where(no, torch.zeros_like(dms), sol[:, n + mi + me:])
    uWu = torch.where(normal_only, zero, uWu)
    u_norm = torch.where(normal_only, zero, u_norm)

    ds = S * dst  # the slack step unscaled
    dz_L, dz_U, dv_L, dv_U = recover_bound_mult_steps(nlp, it, dx, ds, mu)
    step = Iterate(x=dx, s=ds, y_c=dyc, y_d=dyd, z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
    # the step fails only if even the normal step is unusable (a feasible
    # point with a MINRES breakdown, or an undecomposed round with no v)
    failed = normal_only & (feasible_already | ~cn)
    step = tree_where(failed, Iterate(*(torch.zeros_like(v) for v in step)), step)

    jc, jd = ad.Jv(dx)
    aux = InexactAux(
        uWu=uWu, tangential_norm=u_norm,
        norm_cplusAd=torch.sqrt(_sq(c + jc) + _sq(dms + jd - ds)),
        theta2=theta2, grad_barr_t_delta=_dot(gphi_x, dx) + _dot(gphi_s, ds))
    new_last = torch.where(delta_x > 0, delta_x, delta_w_last)
    sr = StepResult(step=step, delta_x=delta_x, delta_c=delta_cd,
                    delta_w_last=new_last, failed=failed, num_trials=trials,
                    residual_ratio=rr, fac=None, K=None)
    return sr, new_omega, aux


def inexact_line_search(nlp: CanonicalNLP, opts: Options, it: Iterate,
                        ev: Evals, sr: StepResult, mu, tau, nu, nu_low,
                        aux: InexactAux):
    """The penalty-function backtracking search (InexactLSAcceptor,
    ``inexact.py:477-576``).  Returns (LineSearchResult, nu, nu_low)."""
    from .linesearch import LineSearchResult, _trial_point
    dtype = it.x.dtype
    eps = torch.finfo(dtype).eps
    step = sr.step
    B = it.x.shape[0]
    false = torch.zeros((B,), dtype=torch.bool, device=it.x.device)
    theta2 = aux.theta2
    phi = barrier_obj(nlp, it, ev.f, mu, opts.kappa_d)

    # --- the nu update (IpInexactLSAcceptor.cpp:174-246) --------------------
    Upsilon = aux.tangential_norm ** 2
    numerator = aux.grad_barr_t_delta + torch.maximum(0.5 * aux.uWu,
                                                      opts.tcc_theta * Upsilon)
    denominator = (1.0 - opts.rho) * (theta2 - aux.norm_cplusAd)
    nu_trial = torch.where(denominator > eps, numerator / denominator, nu)
    do_update = theta2 > opts.nu_update_inf_skip_tol
    nu_new = torch.where(do_update & (nu < nu_trial), nu_trial + opts.nu_inc, nu)
    if opts.flexible_penalty_function:
        nu_mid = torch.where(do_update, torch.maximum(nu_low, nu_trial), nu_new)
    else:
        nu_mid = nu_new
    ref_pred = -aux.grad_barr_t_delta + nu_mid * (theta2 - aux.norm_cplusAd)

    alpha_max, alpha_dual = fraction_to_boundary(nlp, it, step, tau)

    def acceptable(alpha, theta2_t, phi_t):
        pred = alpha * ref_pred
        basval = (phi + nu_new * theta2).abs()
        ared = (phi + nu_new * theta2) - (phi_t + nu_new * theta2_t)
        acc = opts.eta_phi * pred - ared <= 10.0 * eps * basval
        acc_low = false
        if opts.flexible_penalty_function:
            ared_low = (phi + nu_low * theta2) - (phi_t + nu_low * theta2_t)
            acc_low = opts.eta_phi * pred - ared_low <= 10.0 * eps * basval
        return acc | acc_low, acc

    it0 = _trial_point(it, step, alpha_max, alpha_dual)
    cy = dict(k=torch.zeros((B,), dtype=torch.int64, device=it.x.device),
              alpha=alpha_max, done=false, accepted=false, by_high=false, it_t=it0,
              f_t=ev.f, c_t=ev.c, d_t=ev.d, theta2_t=theta2, phi_t=phi,
              alpha_used=alpha_max)
    while True:
        running = ~cy["done"] & (cy["k"] < opts.max_backtracking_steps)
        if not host_bool(running.any()):
            break
        alpha = cy["alpha"]
        it_t = _trial_point(it, step, alpha, alpha_dual)
        f_t = nlp.eval_f(it_t.x)
        c_t, d_t = nlp.eval_cd(it_t.x)
        th_t = torch.sqrt(_sq(c_t) + _sq(d_t - it_t.s))
        ph_t = barrier_obj(nlp, it_t, f_t, mu, opts.kappa_d)
        acc, by_high = acceptable(alpha, th_t, ph_t)
        nxt = alpha * opts.alpha_red_factor
        new = dict(k=cy["k"] + 1, alpha=nxt, done=acc | (nxt < 1e-13), accepted=acc,
                   by_high=by_high, it_t=it_t, f_t=f_t, c_t=c_t, d_t=d_t,
                   theta2_t=th_t, phi_t=ph_t, alpha_used=alpha)
        cy = {k: tree_where(running, new[k], cy[k]) for k in cy}

    # --- nu_low on an acceptance by the high test only (:350-360) -----------
    nu_low_new = nu_low
    if opts.flexible_penalty_function:
        dtheta = cy["theta2_t"] - theta2
        nu_real = torch.where(dtheta.abs() > eps, -(cy["phi_t"] - phi) / dtheta, nu_low)
        upd = torch.minimum(nu_new, nu_low + torch.clamp(
            opts.nu_low_fact * (nu_real - nu_low), min=opts.nu_inc))
        nu_low_new = torch.where(cy["accepted"] & cy["by_high"], upd, nu_low)

    theta1 = ev.c.abs().sum(-1) + (ev.d - it.s).abs().sum(-1)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=it.x.device)
    ls = LineSearchResult(
        accepted=cy["accepted"], alpha_primal=cy["alpha_used"], alpha_dual=alpha_dual,
        trial=cy["it_t"], trial_ev_f=cy["f_t"], trial_c=cy["c_t"], trial_d=cy["d_t"],
        n_backtracks=cy["k"], used_soc=false, ftype=~false, filter=None,
        theta_curr=theta1, phi_curr=phi,
        # no first-trial reuse: the solver evaluates the watchdog point itself
        first_trial=cy["it_t"], first_f=cy["f_t"], first_c=cy["c_t"],
        first_d=cy["d_t"], first_theta=inf, first_phi=inf,
        n_evals=cy["k"], n_soc_rounds=torch.zeros_like(cy["k"]),
        last_rej_filter=false, penalty_nu=nu_new)
    return ls, nu_new, nu_low_new
