"""Filter line search: BacktrackingLineSearch + FilterLSAcceptor (or the
l1-penalty acceptor, PenaltyLSAcceptor), over a batch.

Port of ``ipopt_tpu/algorithm/linesearch.py`` (Waechter-Biegler Algorithm A;
``IpFilterLSAcceptor.cpp``, ``IpBacktrackingLineSearch.cpp``): alpha_min by
eq. (23), backtracking with filter acceptability, the switching condition and
Armijo, second-order corrections (both ``soc_method``s), a corrector's
pre-trial, slack magic steps, ``accept_every_trial_step`` and
``accept_after_max_steps``, and filter augmentation.  The filter is a
fixed-capacity pair of (B, cap) tensors pre-filled with +inf.  The
backtracking loop runs while any lane is still searching; a lane that is
done keeps its carry, so its trial counters equal the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate, col, tree_where, max_init
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool
from ..kkt import (Evals, barrier_obj, grad_barrier_x, grad_barrier_s,
                   fraction_to_boundary)
from .step import StepResult, soc_direction


class FilterState(NamedTuple):
    """Fixed-capacity filter (IpFilter.hpp:19) of margined corner points; a
    trial is blocked by entry j iff theta_t >= theta_j and phi_t >= phi_j."""

    theta: Any  # (B, cap)
    phi: Any    # (B, cap)
    size: Any   # (B,)


def filter_init(batch: int, cap: int, dtype, device) -> FilterState:
    inf = torch.full((batch, cap), float("inf"), dtype=dtype, device=device)
    return FilterState(theta=inf, phi=inf.clone(),
                       size=torch.zeros((batch,), dtype=torch.int64, device=device))


def filter_reset(fs: FilterState) -> FilterState:
    return FilterState(theta=torch.full_like(fs.theta, float("inf")),
                       phi=torch.full_like(fs.phi, float("inf")),
                       size=torch.zeros_like(fs.size))


def filter_acceptable(fs: FilterState, theta_t, phi_t):
    blocked = ((theta_t[:, None] >= fs.theta) & (phi_t[:, None] >= fs.phi)).any(-1)
    return ~blocked


def filter_augment(fs: FilterState, theta, phi, gamma_theta, gamma_phi) -> FilterState:
    """AugmentFilter (IpFilterLSAcceptor.cpp:295); on overflow the entry with
    the largest theta is replaced."""
    cap = fs.theta.shape[-1]
    full = fs.size >= cap
    i = torch.where(full, fs.theta.argmax(-1), fs.size).unsqueeze(-1)
    return FilterState(
        theta=fs.theta.scatter(-1, i, ((1.0 - gamma_theta) * theta).unsqueeze(-1)),
        phi=fs.phi.scatter(-1, i, (phi - gamma_phi * theta).unsqueeze(-1)),
        size=torch.clamp(fs.size + 1, max=cap))


class LineSearchResult(NamedTuple):
    accepted: Any
    alpha_primal: Any
    alpha_dual: Any
    trial: Iterate
    trial_ev_f: Any
    trial_c: Any
    trial_d: Any
    n_backtracks: Any
    used_soc: Any
    ftype: Any
    filter: FilterState
    theta_curr: Any
    phi_curr: Any
    first_trial: Iterate
    first_f: Any
    first_c: Any
    first_d: Any
    first_theta: Any
    first_phi: Any
    n_evals: Any
    n_soc_rounds: Any
    last_rej_filter: Any
    penalty_nu: Any = None  # the l1-penalty acceptor's parameter (B,)


def _theta(c, d, s, norm_type: str = "1-norm"):
    """theta(x) in the option-selected norm (constraint_violation_norm_type)."""
    dms = d - s
    if norm_type == "2-norm":
        return torch.sqrt((c * c).sum(-1) + (dms * dms).sum(-1))
    if norm_type == "max-norm":
        return torch.maximum(max_init(c.abs(), 0.0), max_init(dms.abs(), 0.0))
    return c.abs().sum(-1) + dms.abs().sum(-1)


def magic_step(nlp: CanonicalNLP, s, d_t):
    """Slack magic step (IpBacktrackingLineSearch.cpp:1003-1099): move s_i
    toward d_i(x_trial), up for lower-bounded rows and down for upper-
    bounded ones, except on two-sided rows where the move worsens the
    centering distance |d_L + d_U - 2 s|."""
    dms = d_t - s
    zero = torch.zeros_like(dms)
    delta = (torch.where(nlp.has_dL, torch.clamp(dms, min=0.0), zero)
             + torch.where(nlp.has_dU, torch.clamp(dms, max=0.0), zero))
    both = nlp.has_dL & nlp.has_dU
    center_old = (nlp.d_L + nlp.d_U - 2.0 * s).abs()
    center_new = (nlp.d_L + nlp.d_U - 2.0 * (s + delta)).abs()
    delta = torch.where(both & (center_new > center_old), zero, delta)
    return s + delta


def _eval_theta_phi(nlp: CanonicalNLP, opts: Options, it_trial: Iterate, mu):
    f_t = nlp.eval_f(it_trial.x)
    c_t, d_t = nlp.eval_cd(it_trial.x)
    theta_t = _theta(c_t, d_t, it_trial.s, opts.constraint_violation_norm_type)
    phi_t = barrier_obj(nlp, it_trial, f_t, mu, opts.kappa_d)
    return f_t, c_t, d_t, theta_t, phi_t


def _eval_trial_magic(nlp: CanonicalNLP, opts: Options, it_trial: Iterate, mu):
    """``_eval_theta_phi`` after the optional magic step on the trial's
    slacks (the moved s stays in the trial)."""
    if opts.magic_steps:
        it_trial = it_trial._replace(
            s=magic_step(nlp, it_trial.s, nlp.eval_d(it_trial.x)))
    return (it_trial,) + _eval_theta_phi(nlp, opts, it_trial, mu)


def _trial_point(it: Iterate, step: Iterate, alpha, alpha_dual):
    a, ad = col(alpha), col(alpha_dual)
    return Iterate(
        x=it.x + a * step.x, s=it.s + a * step.s,
        y_c=it.y_c + a * step.y_c, y_d=it.y_d + a * step.y_d,
        z_L=it.z_L + ad * step.z_L, z_U=it.z_U + ad * step.z_U,
        v_L=it.v_L + ad * step.v_L, v_U=it.v_U + ad * step.v_U)


class _Carry(NamedTuple):
    k: Any
    alpha: Any
    done: Any
    accepted: Any
    ftype: Any
    it_t: Iterate
    f_t: Any
    c_t: Any
    d_t: Any
    first: tuple  # (it, f, c, d, theta, phi) at the alpha_max trial
    used_soc: Any
    alpha_used: Any
    n_soc_rounds: Any
    rej_filter: Any


def line_search(nlp: CanonicalNLP, opts: Options, it: Iterate, ev: Evals,
                sr: StepResult, mu, tau, fs: FilterState,
                theta_min, theta_max, corr=None, penalty_nu=None) -> LineSearchResult:
    """One backtracking search per lane.  ``corr`` is a corrector's pre-trial
    (FilterLSAcceptor::TryCorrector, IpFilterLSAcceptor.cpp:655-880): a
    dict with ``trial``, ``alpha_pr``, ``alpha_du`` and ``active``.  It is
    tested first, at the uncorrected first trial's step size; a lane that
    accepts it does no backtracking.  With ``line_search_method="penalty"``
    the l1-penalty acceptor (PenaltyLSAcceptor, ``linesearch.py:219-240``)
    takes the filter's place, its parameter ``penalty_nu`` (B,) carried by
    the solver; "none" is the filter, as in the reference."""
    dtype, dev = it.x.dtype, it.x.device
    B = it.x.shape[0]
    step = sr.step
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)

    theta = _theta(ev.c, ev.d, it.s, opts.constraint_violation_norm_type)
    phi = barrier_obj(nlp, it, ev.f, mu, opts.kappa_d)
    gphi_x = grad_barrier_x(nlp, it, ev.grad_f, mu, opts.kappa_d)
    gphi_s = grad_barrier_s(nlp, it, mu, opts.kappa_d)
    gphi_dx = (gphi_x * step.x).sum(-1) + (gphi_s * step.s).sum(-1)

    alpha_max, alpha_dual = fraction_to_boundary(nlp, it, step, tau)

    # alpha_min, eq. (23) / CalculateAlphaMin.
    descent = gphi_dx < 0
    safe_mg = torch.clamp(-gphi_dx, min=torch.finfo(dtype).tiny)
    term_phi = opts.gamma_phi * theta / safe_mg
    term_sw = (opts.delta * theta ** opts.s_theta) / safe_mg ** opts.s_phi
    amin_case1 = torch.minimum(torch.clamp(term_phi, max=opts.gamma_theta), term_sw)
    amin_case2 = torch.clamp(term_phi, max=opts.gamma_theta)
    alpha_min = opts.alpha_min_frac * torch.where(
        descent, torch.where(theta <= theta_min, amin_case1, amin_case2),
        torch.full_like(theta, opts.gamma_theta))

    def switching(alpha):
        return descent & (alpha * safe_mg ** opts.s_phi
                          > opts.delta * theta ** opts.s_theta)

    use_penalty = opts.line_search_method == "penalty"
    if use_penalty:
        # nu >= |grad phi . d| / ((1 - rho) theta) + 1, rho = 0.1; Armijo on
        # phi + nu theta with the model decrease grad phi . d - nu theta
        nu_req = torch.where(theta > 0, gphi_dx.abs()
                             / ((1.0 - 0.1) * torch.clamp(theta, min=1e-30)),
                             torch.zeros_like(theta))
        nu = torch.maximum(penalty_nu, nu_req + 1.0)
    else:
        nu = penalty_nu

    def acceptable3(alpha, theta_t, phi_t):
        """(accept, is_ftype, rejected_by_filter) per lane."""
        if use_penalty:
            lhs = (phi_t + nu * theta_t) - (phi + nu * theta)
            accept = lhs <= opts.eta_phi * alpha * torch.clamp(gphi_dx - nu * theta,
                                                               max=0.0)
            # no filter augmentation, never a filter rejection
            return accept, ~false, false
        in_filter = filter_acceptable(fs, theta_t, phi_t)
        to_filter = in_filter & (theta_t <= theta_max)
        armijo = phi_t <= phi + opts.eta_phi * alpha * gphi_dx
        suff = ((theta_t <= (1.0 - opts.gamma_theta) * theta)
                | (phi_t <= phi - opts.gamma_phi * theta))
        ftype_case = (theta <= theta_min) & switching(alpha)
        acc_vs_curr = torch.where(ftype_case, armijo, suff)
        basval = torch.clamp(phi.abs(), min=1.0)
        not_absurd = phi_t <= phi + 10.0 ** opts.obj_max_inc * basval
        accept = to_filter & acc_vs_curr & not_absurd
        return accept, ftype_case & armijo, ~in_filter

    def eval_trial(alpha):
        return _eval_trial_magic(nlp, opts, _trial_point(it, step, alpha, alpha_dual),
                                 mu)

    def try_soc(alpha, c_t, d_t, it_t_s, lanes):
        """Second-order corrections (A-5.7) for the lanes ``lanes``: at most
        max_soc rounds, each re-solving with the saved factorization."""
        best_acc, best_ftype = false, false
        best = (it, ev.f, ev.c, ev.d)
        c_soc = col(alpha) * ev.c + c_t
        dms_soc = col(alpha) * (ev.d - it.s) + (d_t - it_t_s)
        theta_old = _theta(c_t, d_t, it_t_s, opts.constraint_violation_norm_type)
        active = lanes
        n_rounds = izero
        alpha_soc = alpha
        for _ in range(opts.max_soc):
            if not host_bool(active.any()):
                break  # nothing below changes a lane that is not active
            dsoc = soc_direction(nlp, opts, it, ev, sr.fac, sr.K, mu,
                                 c_soc, dms_soc, alpha_soc)
            # in the iterate's dtype, whatever the factorization's
            # (linesearch.py:288-292)
            dsoc = Iterate(*(v.to(it.x.dtype) for v in dsoc))
            a_soc, _ = fraction_to_boundary(nlp, it, dsoc, tau)
            it_soc = _trial_point(it, dsoc, a_soc, alpha_dual)
            f_s, c_s, d_s, th_s, ph_s = _eval_theta_phi(nlp, opts, it_soc, mu)
            acc, isf, _ = acceptable3(a_soc, th_s, ph_s)
            acc = acc & active
            keep_going = active & ~acc & (th_s <= opts.kappa_soc * theta_old)
            best_acc = best_acc | acc
            best_ftype = torch.where(acc, isf, best_ftype)
            best = tree_where(acc, (it_soc, f_s, c_s, d_s), best)
            c_soc = col(a_soc) * c_soc + c_s
            dms_soc = col(a_soc) * dms_soc + (d_s - it_soc.s)
            theta_old = th_s
            alpha_soc = a_soc
            n_rounds = n_rounds + active.long()
            active = keep_going
        return (best_acc, best_ftype) + best + (n_rounds,)

    it0 = _trial_point(it, step, alpha_max, alpha_dual)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    cy = _Carry(k=izero, alpha=alpha_max, done=false, accepted=false,
                ftype=false, it_t=it0, f_t=ev.f, c_t=ev.c, d_t=ev.d,
                first=(it0, ev.f, ev.c, ev.d, inf, inf), used_soc=false,
                alpha_used=alpha_max, n_soc_rounds=izero, rej_filter=false)
    if corr is not None:
        c_it, c_f, c_c, c_d, c_th, c_ph = _eval_trial_magic(nlp, opts,
                                                            corr["trial"], mu)
        c_ok, c_ftype, _ = acceptable3(alpha_max, c_th, c_ph)
        corr_acc = c_ok & corr["active"]
        cy = cy._replace(done=corr_acc, accepted=corr_acc, ftype=c_ftype,
                         it_t=c_it, f_t=c_f, c_t=c_c, d_t=c_d,
                         alpha_used=corr["alpha_pr"])
    if opts.accept_every_trial_step:
        # no line search: the full fraction-to-boundary step
        it_t, f_t, c_t, d_t, theta_t, phi_t = eval_trial(alpha_max)
        cy = cy._replace(k=izero + 1, done=~false, accepted=~false, ftype=~false,
                         it_t=it_t, f_t=f_t, c_t=c_t, d_t=d_t,
                         first=(it_t, f_t, c_t, d_t, theta_t, phi_t),
                         alpha_used=alpha_max)

    while True:
        running = ~cy.done & (cy.k < opts.max_backtracking_steps)
        if not host_bool(running.any()):
            break
        alpha = cy.alpha
        it_t, f_t, c_t, d_t, theta_t, phi_t = eval_trial(alpha)
        acc, isf, rejf = acceptable3(alpha, theta_t, phi_t)
        if opts.accept_after_max_steps >= 0:
            # IpBacktrackingLineSearch.cpp:749: accept after this many
            # backtracks whatever the trial
            acc = acc | (cy.k >= opts.accept_after_max_steps)
        no_soc = (false, false, it_t, f_t, c_t, d_t, izero)
        soc = no_soc
        if opts.max_soc > 0:
            # only on the first trial, when rejected and theta did not improve
            do_soc = running & (cy.k == 0) & ~acc & (theta_t >= theta)
            if host_bool(do_soc.any()):
                soc = tree_where(do_soc, try_soc(alpha, c_t, d_t, it_t.s, do_soc),
                                 no_soc)
        s_acc, s_ftype, s_it, s_f, s_c, s_d, s_rounds = soc
        final_acc = acc | s_acc
        pick_soc = s_acc & ~acc
        k0 = cy.k == 0
        new = _Carry(
            k=cy.k + 1, alpha=alpha * opts.alpha_red_factor,
            done=final_acc | (alpha * opts.alpha_red_factor < alpha_min),
            accepted=final_acc,
            ftype=torch.where(pick_soc, s_ftype, isf),
            it_t=tree_where(pick_soc, s_it, it_t),
            f_t=torch.where(pick_soc, s_f, f_t),
            c_t=tree_where(pick_soc, s_c, c_t),
            d_t=tree_where(pick_soc, s_d, d_t),
            first=tree_where(k0, (it_t, f_t, c_t, d_t, theta_t, phi_t), cy.first),
            used_soc=cy.used_soc | pick_soc,
            alpha_used=alpha,
            n_soc_rounds=cy.n_soc_rounds + s_rounds,
            rej_filter=~final_acc & rejf)
        cy = tree_where(running, new, cy)

    # Filter augmentation for accepted non-f-type iterations (A-6).
    augment = cy.accepted & ~cy.ftype
    fs_out = tree_where(augment, filter_augment(fs, theta, phi, opts.gamma_theta,
                                                opts.gamma_phi), fs)
    f_it, f_f, f_c, f_d, f_th, f_ph = cy.first
    return LineSearchResult(
        accepted=cy.accepted, alpha_primal=cy.alpha_used, alpha_dual=alpha_dual,
        trial=cy.it_t, trial_ev_f=cy.f_t, trial_c=cy.c_t, trial_d=cy.d_t,
        n_backtracks=cy.k, used_soc=cy.used_soc, ftype=cy.ftype, filter=fs_out,
        theta_curr=theta, phi_curr=phi,
        first_trial=f_it, first_f=f_f, first_c=f_c, first_d=f_d,
        first_theta=f_th, first_phi=f_ph,
        n_evals=cy.k + cy.n_soc_rounds + (0 if corr is None else 1),
        n_soc_rounds=cy.n_soc_rounds,
        last_rej_filter=cy.rej_filter, penalty_nu=nu)


def compute_alpha_for_y(nlp: CanonicalNLP, opts: Options, it: Iterate,
                        step: Iterate, trial: Iterate, alpha_primal,
                        alpha_dual):
    """Step size for y — PerformDualStep (IpBacktrackingLineSearch.cpp:908-990)."""
    kind = opts.alpha_for_y
    if kind in ("primal", "acceptor"):
        return alpha_primal
    if kind == "bound-mult":
        return alpha_dual
    if kind == "min":
        return torch.minimum(alpha_primal, alpha_dual)
    if kind == "max":
        return torch.maximum(alpha_primal, alpha_dual)
    if kind == "full":
        return torch.ones_like(alpha_primal)
    if kind in ("primal-and-full", "dual-and-full"):
        base = alpha_primal if kind == "primal-and-full" else alpha_dual
        dxnorm = torch.maximum(max_init(step.x.abs(), 0.0),
                               max_init(step.s.abs(), 0.0))
        return torch.where(dxnorm <= opts.alpha_for_y_tol,
                           torch.ones_like(base), base)
    # min-dual-infeas / safer-min-dual-infeas: closed-form minimizer of the
    # dual infeasibility along delta_y at the new primal point.
    jty = nlp.eval_jac_t(trial.x, step.y_c, step.y_d)
    gl_x = (nlp.eval_grad_f(trial.x) + nlp.eval_jac_t(trial.x, it.y_c, it.y_d)
            - trial.z_L + trial.z_U)
    gl_s = -it.y_d - trial.v_L + trial.v_U
    a = (jty * jty).sum(-1) + (step.y_d * step.y_d).sum(-1)
    b = (gl_x * jty).sum(-1) - (gl_s * step.y_d).sum(-1)
    alpha = -b / torch.clamp(a, min=torch.finfo(trial.x.dtype).tiny)
    if kind == "safer-min-dual-infeas":
        return torch.minimum(torch.maximum(alpha_primal, alpha_dual),
                             torch.maximum(alpha, torch.minimum(alpha_primal,
                                                                alpha_dual)))
    return torch.clamp(alpha, 0.0, 1.0)
