"""Chen-Goldfarb penalty-method line search, over a batch
(``line_search_method="cg-penalty"``; port of
``ipopt_tpu/algorithm/cg_penalty.py``, the reference's
``src/contrib/CGPenalty/``):

- the search direction (CGSearchDirCalculator): the penalty initialized
  from max|y|; one factorization with the Jacobian regularization tied to
  the penalty, delta_c = ||(c, d-s)||_2 / kkt_penalty (CGPerturbationHandler);
  the fast direction (the primal-dual right-hand side) and the cgpen one
  (constraint rows shifted by +delta_c y); three compatibility tests pick
  one; the penalty pre-update;
- the acceptor (CGPenaltyLSAcceptor): Armijo on phi + nu ||(c, d-s)||_2
  with the exact directional derivative, the piecewise-linear penalty list
  (PLPF) as a fixed-capacity (B, K) triple, the pen_theta_max cap, and the
  two-stage update of the penalty parameters.

Every quantity of the reference's carry is per lane; the backtracking
loop runs while any lane is searching and a lane that is done keeps its
carry.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate, col, max_init, min_init, tree_where
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool
from ..kkt import (Evals, barrier_obj, grad_barrier_x, grad_barrier_s,
                   fraction_to_boundary, condensed_rhs_parts, slacks, jac_t,
                   recover_bound_mult_steps, kkt_residuals, optimality_error)
from .step import StepResult, factorize_any, solve_any


class CGState(NamedTuple):
    """The Chen-Goldfarb carry (CGPenaltyData), per lane."""
    penalty: Any            # (B,) nu of the line-search penalty function
    kkt_penalty: Any        # (B,) penalty scaling the KKT perturbation
    initialized: Any        # (B,) bool
    pp_pen_r: Any           # (B, K) PLPF breakpoint penalties
    pp_barr: Any            # (B, K) PLPF barrier values
    pp_inf: Any             # (B, K) PLPF infeasibilities (1-norm)
    pp_size: Any            # (B,)
    curr_eta: Any           # (B,) eta tolerance (-1 = not set)
    pen_theta_max: Any      # (B,) infeasibility cap (-1 = not set)
    nonmono_count: Any      # (B,) nonmonotone penalty decreases
    second_update_count: Any  # (B,)


class CGStepAux(NamedTuple):
    """What the acceptor and the updater need from the direction, per lane."""
    ref_penalty_fn: Any      # phi_nu at the current point
    ref_direct_deriv: Any    # D phi_nu along the cgpen direction
    pert: Any                # the accepted delta_c
    inf2: Any                # ||(c, d-s)||_2 at the current point
    used_fast: Any           # bool: the fast direction was taken
    dxs_nrm2: Any            # ||(dx, ds)||_2^2 of the taken step
    dy_c: Any                # the taken direction's y steps
    dy_d: Any


def cg_init(opts: Options, batch: int, dtype, device) -> CGState:
    """The carry before the first iteration (a list of one slot when the
    method is off, as the reference keeps its state small)."""
    K = opts.max_piece_number if opts.line_search_method == "cg-penalty" else 1

    def full(v, dt=dtype, shape=(batch,)):
        return torch.full(shape, v, dtype=dt, device=device)

    zi = full(0, torch.int64)
    return CGState(
        penalty=full(1.0), kkt_penalty=full(1.0), initialized=full(False, torch.bool),
        pp_pen_r=full(0.0, shape=(batch, K)),
        pp_barr=full(float("inf"), shape=(batch, K)),
        pp_inf=full(float("inf"), shape=(batch, K)),
        pp_size=zi, curr_eta=full(-1.0), pen_theta_max=full(-1.0),
        nonmono_count=zi, second_update_count=zi)


def _sq(v):
    return (v * v).sum(-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _inf2(c, d, s):
    return torch.sqrt(_sq(c) + _sq(d - s))


def cg_search_direction(nlp: CanonicalNLP, opts: Options, it: Iterate,
                        ev: Evals, W, mu, delta_w_last, cg: CGState):
    """The fast/cgpen direction pair and the penalty bookkeeping
    (``cg_penalty.py:88-245``); returns (StepResult, CGState, CGStepAux)."""
    dtype = it.x.dtype
    tiny = torch.finfo(dtype).tiny
    inf2 = _inf2(ev.c, ev.d, it.s)
    dms = ev.d - it.s
    zero = torch.zeros_like(inf2)

    # --- penalty initialization (first iteration) -------------------------
    y_max = torch.maximum(max_init(it.y_c.abs(), 0.0), max_init(it.y_d.abs(), 0.0))
    pen0 = torch.clamp(torch.clamp(y_max, max=opts.penalty_init_max),
                       min=opts.penalty_init_min)
    penalty = torch.where(cg.initialized, cg.penalty, pen0)
    kkt_penalty = torch.where(cg.initialized, cg.kkt_penalty,
                              torch.full_like(inf2, opts.penalty_init_min))

    # --- factorize with the CG perturbation (curr_cg_pert_fact) -----------
    pert_fact = inf2 / kkt_penalty
    fr = factorize_any(nlp, opts, it, ev, W, mu, delta_w_last,
                       delta_cd_override=pert_fact)
    pert = fr.delta_c

    # --- fast direction: the primal-dual right-hand side --------------------
    parts = condensed_rhs_parts(nlp, it, ev, mu, opts.kappa_d)
    (dxf, dsf, dycf, dydf), rr = solve_any(nlp, opts, fr.fac, fr.K, parts)
    # --- cgpen direction: constraint rows shifted by +pert * y --------------
    pc = col(pert)
    parts_pen = (parts[0], parts[1], parts[2] + pc * it.y_c, parts[3] + pc * it.y_d)
    (dxp, dsp, dycp, dydp), _ = solve_any(nlp, opts, fr.fac, fr.K, parts_pen)

    # --- compatibility tests for keeping the fast direction ----------------
    gphi_x = grad_barrier_x(nlp, it, ev.grad_f, mu, opts.kappa_d)
    gphi_s = grad_barrier_s(nlp, it, mu, opts.kappa_d)
    tilde_nrm = torch.sqrt(_sq(dxf) + _sq(dsf))
    diff_nrm = torch.sqrt(_sq(dxf - dxp) + _sq(dsf - dsp))
    test_x = diff_nrm <= opts.kappa_x_dis * torch.maximum(
        tilde_nrm, tilde_nrm ** opts.vartheta)
    tilde_dy = torch.sqrt(_sq(dycf) + _sq(dydf))
    bar_y = torch.sqrt(_sq(it.y_c + dycp) + _sq(it.y_d + dydp))
    test_y = tilde_dy <= torch.clamp(opts.kappa_y_dis * bar_y, min=opts.delta_y_max)
    # fast_direct_deriv <= fast_des_fact d^T barH d (IpCGPenaltyCq.cpp:225, 295)
    gphi_dfast = _dot(gphi_x, dxf) + _dot(gphi_s, dsf)
    safe_inf = torch.clamp(inf2, min=tiny)
    fac = penalty * pert / safe_inf
    fast_deriv = (gphi_dfast - penalty * inf2
                  + torch.where(inf2 > 0, fac * (_dot(ev.c, dycf) + _dot(dms, dydf)),
                                zero))
    dT_barH_d = ((-_dot(it.y_c, dycf) - _dot(it.y_d, dydf)) * pert_fact
                 - gphi_dfast + _dot(ev.c, it.y_c) + _dot(dms, it.y_d)
                 - _dot(ev.c, dycf) - _dot(dms, dydf) + penalty * inf2)
    test_deriv = fast_deriv <= opts.fast_des_fact * dT_barH_d
    # with no perturbation the two directions coincide
    keep_fast = (test_x & test_y & test_deriv) | (pert == 0)
    if opts.never_use_fact_cgpen_direction:
        keep_fast = keep_fast & (pert == 0)
    kf = col(keep_fast)
    dx, ds = torch.where(kf, dxf, dxp), torch.where(kf, dsf, dsp)
    dy_c, dy_d = torch.where(kf, dycf, dycp), torch.where(kf, dydf, dydp)

    # --- penalty pre-update (compute_curr_cg_penalty) ----------------------
    gphi_d = _dot(gphi_x, dx) + _dot(gphi_s, ds)
    # d^T (damped Hessian) d from the augmented rows, with the reference's
    # intended J_d^T dy_d term (``cg_penalty.py:179-181``)
    jT_ypdy = jac_t(nlp, ev, it.y_c + dy_c, it.y_d + dy_d)
    dHd = -gphi_d - (_dot(jT_ypdy, dx) - _dot(it.y_d, ds) - _dot(dy_d, ds))
    dxs_nrm2 = _sq(dx) + _sq(ds)
    dHd = torch.maximum(1e-8 * dxs_nrm2, dHd)
    fac2 = pert / safe_inf
    deriv_inf_fast = fac2 * (_dot(ev.c, dy_c) + _dot(dms, dy_d)) - inf2
    deriv_inf_pen = fac2 * (_dot(ev.c, it.y_c + dy_c) + _dot(dms, it.y_d + dy_d)) - inf2
    deriv_inf = torch.where(keep_fast, deriv_inf_fast, deriv_inf_pen)
    denom = deriv_inf + opts.pen_des_fact * inf2
    nu_cand = torch.where((inf2 > 0) & (denom.abs() > tiny),
                          -(gphi_d + opts.pen_des_fact * dHd) / denom, zero)
    # the update rules (IpCGSearchDirCalc.cpp:330-366)
    up = nu_cand > penalty
    nu_up = torch.maximum(nu_cand, penalty + 1.0)
    keep_nu = (penalty <= kkt_penalty) | (pert == 0)
    new_penalty = torch.where(up, nu_up, torch.where(keep_nu, penalty, kkt_penalty))
    nonmono = cg.nonmono_count + (~up & ~keep_nu).long()
    new_kkt_penalty = torch.where((new_penalty > kkt_penalty) & (nonmono > 50),
                                  new_penalty, kkt_penalty)

    # --- reference quantities for the acceptor -----------------------------
    phi = barrier_obj(nlp, it, ev.f, mu, opts.kappa_d)
    ref_pen_fn = phi + new_penalty * inf2
    gphi_dpen = _dot(gphi_x, dxp) + _dot(gphi_s, dsp)
    ref_deriv = (gphi_dpen - new_penalty * inf2
                 + torch.where(inf2 > 0, (new_penalty * pert / safe_inf)
                               * (_dot(ev.c, it.y_c + dycp)
                                  + _dot(dms, it.y_d + dydp)), zero))

    dz_L, dz_U, dv_L, dv_U = recover_bound_mult_steps(nlp, it, dx, ds, mu)
    step = Iterate(x=dx, s=ds, y_c=dy_c, y_d=dy_d,
                   z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
    step = tree_where(fr.failed, Iterate(*(torch.zeros_like(v) for v in step)), step)
    sr = StepResult(step=step, delta_x=fr.delta_x, delta_c=fr.delta_c,
                    delta_w_last=fr.delta_w_last, failed=fr.failed,
                    num_trials=fr.num_trials, residual_ratio=rr, fac=fr.fac, K=fr.K)
    cg_new = cg._replace(penalty=new_penalty, kkt_penalty=new_kkt_penalty,
                         initialized=torch.ones_like(cg.initialized),
                         nonmono_count=nonmono)
    aux = CGStepAux(ref_penalty_fn=ref_pen_fn, ref_direct_deriv=ref_deriv,
                    pert=pert, inf2=inf2, used_fast=keep_fast, dxs_nrm2=dxs_nrm2,
                    dy_c=dy_c, dy_d=dy_d)
    return sr, cg_new, aux


# ---------------------------------------------------------------------------
# The piecewise-linear penalty function (PLPF, ``IpPiecewisePenalty.cpp``)
# ---------------------------------------------------------------------------

def _valid(cg: CGState):
    K = cg.pp_inf.shape[-1]
    return torch.arange(K, device=cg.pp_inf.device)[None, :] < cg.pp_size[:, None]


def pp_acceptable(cg: CGState, Fzconst, Fzlin):
    """PiecewisePenalty::Acceptable (IpPiecewisePenalty.cpp:92-106): below
    some breakpoint line, or less infeasible than every entry; per lane."""
    valid = _valid(cg)
    Fz = col(Fzconst) + cg.pp_pen_r * (col(Fzlin) - cg.pp_inf) - cg.pp_barr
    below = (valid & (Fz < 0)).any(-1)
    inf = torch.full_like(cg.pp_inf, float("inf"))
    min_inf = min_init(torch.where(valid, cg.pp_inf, inf), float("inf"))
    return below | (Fzlin < min_inf)


def pp_biggest_barr(cg: CGState):
    ninf = torch.full_like(cg.pp_barr, -float("inf"))
    return max_init(torch.where(_valid(cg), cg.pp_barr, ninf), -float("inf"))


def pp_update(cg: CGState, barr_t, inf_t) -> CGState:
    """The PLPF envelope update, fixed-shape (``cg_penalty.py:276-324``):
    insert the point, keep the Pareto-dominant points, sort them by
    infeasibility descending and recompute the breakpoint penalties."""
    B, K = cg.pp_inf.shape
    dev = cg.pp_inf.device
    valid = _valid(cg)
    pinf = torch.full_like(cg.pp_inf, float("inf"))
    barr = torch.where(valid, cg.pp_barr, pinf)
    inf = torch.where(valid, cg.pp_inf, pinf)
    # the new point in slot pp_size, or in the last slot when full
    slot = torch.clamp(cg.pp_size, max=K - 1)[:, None]
    barr = barr.scatter(-1, slot, barr_t[:, None])
    inf = inf.scatter(-1, slot, inf_t[:, None])
    # drop i if some j is no worse in both and better in one (ties keep the
    # lowest index)
    bi, bj = barr[:, :, None], barr[:, None, :]
    ii, ij = inf[:, :, None], inf[:, None, :]
    strictly_better = (bj <= bi) & (ij <= ii) & ((bj < bi) | (ij < ii))
    idx = torch.arange(K, device=dev)
    tie_earlier = (bj == bi) & (ij == ii) & (idx[None, None, :] < idx[None, :, None])
    dominated = (strictly_better | tie_earlier).any(-1)
    keep = torch.isfinite(inf) & ~dominated
    sort_key = torch.where(keep, -inf, pinf)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    barr_s = barr.gather(-1, order)
    inf_s = inf.gather(-1, order)
    size = keep.gather(-1, order).sum(-1)
    # breakpoints: pen_r_0 = 0, pen_r_k = (barr_k - barr_{k-1}) / (inf_{k-1} - inf_k)
    dbarr = barr_s - torch.roll(barr_s, 1, -1)
    dinf = torch.roll(inf_s, 1, -1) - inf_s
    zero = torch.zeros_like(dbarr)
    pen_r = torch.where(idx[None, :] == 0, zero,
                        torch.where(dinf > 0, dbarr / torch.clamp(dinf, min=1e-300),
                                    zero))
    fill = idx[None, :] < size[:, None]
    return cg._replace(pp_pen_r=torch.where(fill, pen_r, zero),
                       pp_barr=torch.where(fill, barr_s, pinf),
                       pp_inf=torch.where(fill, inf_s, pinf), pp_size=size)


# ---------------------------------------------------------------------------
# The line search
# ---------------------------------------------------------------------------

def cg_line_search(nlp: CanonicalNLP, opts: Options, it: Iterate, ev: Evals,
                   sr: StepResult, mu, tau, cg: CGState, aux: CGStepAux):
    """Backtracking with the CG penalty-function acceptance
    (CGPenaltyLSAcceptor::CheckAcceptabilityOfTrialPoint,
    ``cg_penalty.py:331-458``).  Returns (LineSearchResult, CGState)."""
    from .linesearch import LineSearchResult, _trial_point, _eval_theta_phi
    dtype = it.x.dtype
    eps = torch.finfo(dtype).eps
    step = sr.step
    B = it.x.shape[0]
    false = torch.zeros((B,), dtype=torch.bool, device=it.x.device)

    theta = ev.c.abs().sum(-1) + (ev.d - it.s).abs().sum(-1)
    phi = barrier_obj(nlp, it, ev.f, mu, opts.kappa_d)

    # the PLPF list and the infeasibility cap, set up lazily
    empty = cg.pp_size == 0
    first = torch.arange(cg.pp_inf.shape[-1], device=theta.device)[None, :] == 0
    e0 = empty[:, None] & first
    cg = cg._replace(
        pp_pen_r=torch.where(e0, torch.zeros_like(cg.pp_pen_r), cg.pp_pen_r),
        pp_barr=torch.where(e0, col(phi), cg.pp_barr),
        pp_inf=torch.where(e0, col(theta), cg.pp_inf),
        pp_size=torch.where(empty, torch.ones_like(cg.pp_size), cg.pp_size))
    cg = cg._replace(pen_theta_max=torch.where(
        cg.pen_theta_max < 0, opts.pen_theta_max_fact * torch.clamp(theta, min=1.0),
        cg.pen_theta_max))

    alpha_max, alpha_dual = fraction_to_boundary(nlp, it, step, tau)
    inf_max = torch.maximum(max_init(ev.c.abs(), 0.0), max_init((ev.d - it.s).abs(), 0.0))
    biggest_barr = pp_biggest_barr(cg)

    def acceptable(alpha, theta_t, phi_t, it_t, c_t, d_t):
        cap_ok = theta_t <= cg.pen_theta_max
        # Armijo on phi_nu with the trial's 2-norm infeasibility
        pen_t = phi_t + cg.penalty * _inf2(c_t, d_t, it_t.s)
        armijo = (pen_t - aux.ref_penalty_fn
                  - opts.eta_penalty * alpha * aux.ref_direct_deriv
                  <= 10.0 * eps * aux.ref_penalty_fn.abs())
        if opts.never_use_piecewise_penalty_ls:
            plpf = false
        else:
            Fzconst = phi_t + alpha * opts.piecewisepenalty_gamma_obj * aux.dxs_nrm2
            Fzlin = theta_t + alpha * opts.piecewisepenalty_gamma_infeasi * theta
            barr_dec_ok = (phi_t - biggest_barr
                           <= -alpha * opts.piecewisepenalty_gamma_obj * aux.dxs_nrm2
                           + 10.0 * eps * phi.abs())
            plpf = (pp_acceptable(cg, Fzconst, Fzlin)
                    & (~(inf_max < opts.theta_min) | barr_dec_ok))
        accept = (cap_ok & (armijo | plpf)) | (alpha < opts.min_alpha_primal)
        return accept, cap_ok & armijo

    it0 = _trial_point(it, step, alpha_max, alpha_dual)
    cy = dict(k=torch.zeros((B,), dtype=torch.int64, device=it.x.device),
              alpha=alpha_max, done=false, accepted=false, by_armijo=false,
              it_t=it0, f_t=ev.f, c_t=ev.c, d_t=ev.d, theta_t=theta, phi_t=phi,
              alpha_used=alpha_max)
    while True:
        running = ~cy["done"] & (cy["k"] < opts.max_backtracking_steps)
        if not host_bool(running.any()):
            break
        alpha = cy["alpha"]
        it_t = _trial_point(it, step, alpha, alpha_dual)
        f_t, c_t, d_t, theta_t, phi_t = _eval_theta_phi(nlp, opts, it_t, mu)
        acc, by_arm = acceptable(alpha, theta_t, phi_t, it_t, c_t, d_t)
        nxt = alpha * opts.alpha_red_factor
        new = dict(k=cy["k"] + 1, alpha=nxt, done=acc | (nxt < opts.min_alpha_primal * 0.5),
                   accepted=acc, by_armijo=by_arm, it_t=it_t, f_t=f_t, c_t=c_t,
                   d_t=d_t, theta_t=theta_t, phi_t=phi_t, alpha_used=alpha)
        cy = {k: tree_where(running, new[k], cy[k]) for k in cy}

    # --- UpdateForNextIteration: the PLPF entry of a non-Armijo acceptance,
    #     then the penalty parameters when the system was perturbed
    do_pp = cy["accepted"] & ~cy["by_armijo"]
    cg = tree_where(do_pp, pp_update(cg, cy["phi_t"], cy["theta_t"]), cg)
    cg = _update_penalty_parameter(nlp, opts, it, ev, sr, mu, cg, aux, cy)

    inf = torch.full((B,), float("inf"), dtype=dtype, device=it.x.device)
    ls = LineSearchResult(
        accepted=cy["accepted"], alpha_primal=cy["alpha_used"], alpha_dual=alpha_dual,
        trial=cy["it_t"], trial_ev_f=cy["f_t"], trial_c=cy["c_t"], trial_d=cy["d_t"],
        n_backtracks=cy["k"], used_soc=false, ftype=~false, filter=None,
        theta_curr=theta, phi_curr=phi,
        # no first-trial reuse: the solver evaluates the watchdog point itself
        first_trial=cy["it_t"], first_f=cy["f_t"], first_c=cy["c_t"],
        first_d=cy["d_t"], first_theta=inf, first_phi=inf,
        n_evals=cy["k"], n_soc_rounds=torch.zeros_like(cy["k"]),
        last_rej_filter=false, penalty_nu=cg.penalty)
    return ls, cg


def _update_penalty_parameter(nlp, opts: Options, it: Iterate, ev: Evals, sr,
                              mu, cg: CGState, aux: CGStepAux, out) -> CGState:
    """UpdatePenaltyParameter (IpCGPenaltyLSAcceptor.cpp:712-900,
    ``cg_penalty.py:439-496``)."""
    inf = float("inf")
    active = aux.pert != 0
    res = kkt_residuals(nlp, it, ev, 0.0)
    E, _, _, _ = optimality_error(nlp, it, res, opts.s_max)
    eta0 = torch.clamp(torch.clamp(opts.gamma_hat * E, max=opts.gamma_tilde),
                       min=opts.eta_min)
    curr_eta = torch.where(cg.curr_eta < 0, eta0, cg.curr_eta)

    trial_inf2 = _inf2(out["c_t"], out["d_t"], out["it_t"].s)
    max_step = torch.maximum(max_init(sr.step.x.abs(), 0.0), max_init(sr.step.s.abs(), 0.0))
    inc = (trial_inf2 >= opts.penalty_update_infeasibility_tol) & (max_step <= curr_eta)

    # the complementarity window
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    nan = float("nan")

    def pr(has, v):
        return torch.where(has, v, torch.full_like(v, nan))

    prods = torch.cat([pr(nlp.has_xL, sl_xL * it.z_L), pr(nlp.has_xU, sl_xU * it.z_U),
                       pr(nlp.has_dL, sl_sL * it.v_L), pr(nlp.has_dU, sl_sU * it.v_U)], -1)
    isnan = torch.isnan(prods)
    min_c = torch.minimum(mu, min_init(torch.where(isnan, torch.full_like(prods, inf),
                                                   prods), inf))
    max_c = torch.maximum(mu, max_init(torch.where(isnan, torch.full_like(prods, -inf),
                                                   prods), -inf))
    inc = (inc & (min_c >= mu * opts.penalty_update_compl_tol)
           & (max_c <= mu / opts.penalty_update_compl_tol))

    # the omega tests: |y + dy - c / pert|_inf < eta (c and d blocks)
    pert_safe = col(torch.where(aux.pert != 0, aux.pert, torch.ones_like(aux.pert)))
    om_c = max_init((it.y_c + aux.dy_c - ev.c / pert_safe).abs(), 0.0)
    om_d = max_init((it.y_d + aux.dy_d - (ev.d - it.s) / pert_safe).abs(), 0.0)
    inc = inc & (om_c < curr_eta) & (om_d < curr_eta) & active

    new_eta = torch.where(inc, torch.clamp(curr_eta / 2.0, min=opts.eta_min), curr_eta)
    y_full_max = torch.maximum(max_init((it.y_c + aux.dy_c).abs(), 0.0),
                               max_init((it.y_d + aux.dy_d).abs(), 0.0))
    pen_infeas = torch.maximum(opts.chi_hat * cg.kkt_penalty, y_full_max + 1.0)
    pen_feas = torch.maximum(opts.chi_tilde * cg.kkt_penalty, opts.chi_cup * y_full_max)
    pen_new = torch.where(aux.inf2 >= opts.epsilon_c, pen_infeas, pen_feas)
    pen_new = torch.clamp(pen_new, max=opts.penalty_max)
    kkt_pen = torch.where(inc, pen_new, cg.kkt_penalty)

    # the second, heuristic update
    scaled_y = (torch.maximum(max_init(it.y_c.abs(), 0.0), max_init(it.y_d.abs(), 0.0))
                / torch.clamp(max_init(ev.grad_f.abs(), 0.0), min=1.0))
    do2 = (scaled_y <= 1e4) | (cg.second_update_count < 5)
    dms = ev.d - it.s
    r2 = _dot(aux.dy_c, ev.c) + _dot(aux.dy_d, dms)
    r2 = r2 + torch.where(aux.used_fast, torch.zeros_like(r2),
                          _dot(it.y_c, ev.c) + _dot(it.y_d, dms))
    trigger2 = r2.abs() > 0.5 * kkt_pen * aux.inf2
    nrm2_y = torch.sqrt(_sq(it.y_c + aux.dy_c) + _sq(it.y_d + aux.dy_d))
    fire2 = do2 & trigger2 & ((nlp.me + nlp.mi) > 0)
    kkt_pen = torch.where(fire2, torch.clamp(5.0 * nrm2_y, max=opts.penalty_max), kkt_pen)
    cnt2 = cg.second_update_count + (fire2 & (scaled_y > 1e4)).long()
    return cg._replace(curr_eta=new_eta, kkt_penalty=kkt_pen, second_update_count=cnt2)
