"""Feasibility restoration phase: MinC_1NrmRestorationPhase, over the lanes
that need it (port of ``ipopt_tpu/algorithm/restoration.py``).

The restoration NLP for the current outer iterate (x_R, s_R) of each lane:

    min  rho * 1^T (p_c + n_c + p_d + n_d) + (eta/2) ||D_r (x - x_R)||^2
    s.t. c(x) - p_c + n_c = 0,   d(x) - p_d + n_d in [d_L, d_U],
         x_L <= x <= x_U,  p, n >= 0

(``IpRestoMinC_1Nrm.cpp``, ``IpRestoIpoptNLP.hpp:33``).  The reference runs
it under a mask for every lane (``solver.py:880-956``); the port runs the
nested IPM only on the sub-batch of lanes that entered restoration, and
within it only on the lanes whose restoration is still running.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..types import Iterate, SolverReturn, col, tree_take, tree_put, tree_where, max_init
from ..problem import CanonicalNLP, CanonicalStructure
from ..options import Options
from ..profiling import host_bool
from .. import kkt
from ..kkt import evaluate, slacks, barrier_obj
from .linesearch import FilterState, filter_acceptable, filter_init


def build_resto_nlp(orig: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """The restoration CanonicalNLP over the lanes of ``orig``.  Its ``params``
    carry x_ref, eta and the original problem's per-instance data, so one
    template serves any entry point (filled in by perform_restoration)."""
    s = orig.struct
    n, me, mi = s.n, s.me, s.mi
    nr = n + 2 * me + 2 * mi
    B, dtype, dev = orig.batch, orig.dtype, orig.device
    rho = float(opts.resto_penalty_parameter)

    def split(xt):
        return (xt[:n], xt[n:n + me], xt[n + me:n + 2 * me],
                xt[n + 2 * me:n + 2 * me + mi], xt[n + 2 * me + mi:])

    def f_resto(xt, params):
        x, n_c, p_c, n_d, p_d = split(xt)
        x_ref = params["x_ref"]
        dr = 1.0 / torch.clamp(x_ref.abs(), min=1.0)
        prox = 0.5 * params["eta"] * ((dr * (x - x_ref)) ** 2).sum()
        return rho * (n_c.sum() + p_c.sum() + n_d.sum() + p_d.sum()) + prox

    def g_resto(xt, params):
        x, n_c, p_c, n_d, p_d = split(xt)
        cvals, dvals = orig.cd1(x, params["orig"])
        return torch.cat([cvals - p_c + n_c, dvals - p_d + n_d])

    struct = CanonicalStructure(
        n_full=nr, n=nr, m=me + mi, me=me, mi=mi,
        eq_idx=np.arange(me, dtype=np.int32),
        ineq_idx=np.arange(me, me + mi, dtype=np.int32),
        free_idx=np.arange(nr, dtype=np.int32),
        fixed_idx=np.zeros((0,), np.int32),
        fixed_treatment="make_parameter")

    zeros_pn = torch.zeros((B, 2 * me + 2 * mi), dtype=dtype, device=dev)
    ones_pn = torch.ones((B, 2 * me + 2 * mi), dtype=torch.bool, device=dev)
    params0 = {"x_ref": orig.x0,
               "eta": torch.zeros((B,), dtype=dtype, device=dev),
               "orig": orig.lane()}
    return CanonicalNLP(
        struct=struct, f=f_resto, g=g_resto, params=params0,
        x_L=torch.cat([orig.x_L, zeros_pn], -1),
        x_U=torch.cat([orig.x_U, zeros_pn], -1),
        d_L=orig.d_L, d_U=orig.d_U,
        has_xL=torch.cat([orig.has_xL, ones_pn], -1),
        has_xU=torch.cat([orig.has_xU, ~ones_pn], -1),
        has_dL=orig.has_dL, has_dU=orig.has_dU,
        c_rhs=torch.zeros((B, me), dtype=dtype, device=dev),
        x_fixed=torch.zeros((B, nr), dtype=dtype, device=dev),
        x0=torch.cat([orig.x0, torch.ones_like(zeros_pn)], -1),
        x_L_orig=torch.cat([orig.x_L_orig, zeros_pn], -1),
        x_U_orig=torch.cat([orig.x_U_orig, zeros_pn], -1),
        obj_scale=torch.ones((B,), dtype=dtype, device=dev),
        c_scale=torch.ones((B, me), dtype=dtype, device=dev),
        d_scale=torch.ones((B, mi), dtype=dtype, device=dev))


def _solve_quadratic_pn(mu, rho, c):
    """n with p - n = c minimizing the barrier-penalty (solve_quadratic)."""
    a = col(mu) / (2.0 * rho) - 0.5 * c
    b = col(mu) * c / (2.0 * rho)
    return a + torch.sqrt(a * a + b)


def resto_initial_iterate(orig: CanonicalNLP, opts: Options, it: Iterate,
                          c_val, dms_val, resto_mu) -> Iterate:
    rho = opts.resto_penalty_parameter
    n_c = _solve_quadratic_pn(resto_mu, rho, c_val)
    p_c = c_val + n_c
    n_d = _solve_quadratic_pn(resto_mu, rho, dms_val)
    p_d = dms_val + n_d
    n_c, p_c, n_d, p_d = (torch.clamp(v, min=1e-30) for v in (n_c, p_c, n_d, p_d))
    xt = torch.cat([it.x, n_c, p_c, n_d, p_d], -1)
    m = col(resto_mu)
    z_pn = torch.cat([m / n_c, m / p_c, m / n_d, m / p_d], -1)
    return Iterate(
        x=xt, s=it.s,
        y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
        z_L=torch.cat([torch.clamp(it.z_L, max=rho), z_pn], -1),
        z_U=torch.cat([torch.clamp(it.z_U, max=rho), torch.zeros_like(z_pn)], -1),
        v_L=torch.clamp(it.v_L, max=rho), v_U=torch.clamp(it.v_U, max=rho))


class RestoResult(NamedTuple):
    it: Iterate
    success: Any
    locally_infeasible: Any
    failed: Any
    resto_iters: Any


def perform_restoration(orig: CanonicalNLP, resto_nlp: CanonicalNLP,
                        opts: Options, resto_opts: Options, it: Iterate,
                        ev, outer_mu, fs: FilterState, theta_outer, phi_outer,
                        ipm_step_fn) -> RestoResult:
    """Run the nested restoration IPM for every lane of ``orig`` (all of
    which entered restoration).  ``ipm_step_fn(nlp, opts, state)`` is the
    solver's step without a restoration fallback."""
    from .solver import IPMState, counters_init, robust_state_init
    from .init import least_squares_y

    n, me, mi = orig.struct.n, orig.struct.me, orig.struct.mi
    B, dtype, dev = orig.batch, it.x.dtype, it.x.device
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)

    c_val = ev.c
    dms_val = ev.d - it.s
    theta_entry_max = torch.maximum(max_init(c_val.abs(), 0.0),
                                    max_init(dms_val.abs(), 0.0))
    resto_mu = torch.maximum(outer_mu, theta_entry_max)
    eta = opts.resto_proximity_weight * torch.sqrt(resto_mu)
    rnlp = resto_nlp._replace(params={"x_ref": it.x, "eta": eta,
                                      "orig": orig.lane()})
    it_r = resto_initial_iterate(orig, opts, it, c_val, dms_val, resto_mu)
    ev_r = evaluate(rnlp, it_r.x)
    theta0_r = ev_r.c.abs().sum(-1) + (ev_r.d - it_r.s).abs().sum(-1)
    st_r = IPMState(
        it=it_r, mu=resto_mu, tau=torch.clamp(1.0 - resto_mu, min=opts.tau_min),
        iter_count=izero, delta_w_last=zero,
        fs=filter_init(B, opts.max_filter_size, dtype, dev),
        theta_min=opts.theta_min_fact * torch.clamp(theta0_r, min=1.0),
        theta_max=opts.theta_max_fact * torch.clamp(theta0_r, min=1.0),
        status=torch.full((B,), int(SolverReturn.CONTINUE), dtype=torch.int64,
                          device=dev),
        acceptable_count=izero, last_alpha_pr=zero, last_alpha_du=zero,
        last_ls_count=izero, last_delta_x=zero, last_step_norm=zero,
        restoration_count=izero, tiny_step_count=izero,
        counters=counters_init(B, dev),
        wd_active=torch.zeros((B,), dtype=torch.bool, device=dev),
        wd_trials=izero, wd_shortened_count=izero, wd_ref=it_r,
        wd_ref_theta=inf, wd_ref_phi=inf, soft_resto_count=izero, ev=ev_r,
        **robust_state_init(resto_opts, it_r))

    kappa = opts.required_infeasibility_reduction
    inf_pr_req = torch.clamp(kappa * theta_entry_max,
                             min=min(opts.tol, opts.constr_viol_tol))

    def progress(s_r):
        """theta/phi of the ORIGINAL problem at the resto iterate; the exit
        test of RestoConvergenceCheck + TestOrigProgress."""
        x = s_r.it.x[:, :n]
        it_o = it._replace(x=x, s=s_r.it.s)
        f_o = orig.eval_f(x)
        c_o, d_o = orig.eval_cd(x)
        inf_pr = torch.maximum(max_init(c_o.abs(), 0.0),
                               max_init((d_o - s_r.it.s).abs(), 0.0))
        theta_o = c_o.abs().sum(-1) + (d_o - s_r.it.s).abs().sum(-1)
        phi_o = barrier_obj(orig, it_o, f_o, outer_mu, opts.kappa_d)
        curr_ok = ((theta_o <= (1.0 - opts.gamma_theta) * theta_outer)
                   | (phi_o <= phi_outer - opts.gamma_phi * theta_outer))
        return (inf_pr <= inf_pr_req) & filter_acceptable(fs, theta_o, phi_o) & curr_ok

    def body(rn, o, s_r):
        s_next = ipm_step_fn(rn, resto_opts, s_r)
        # Restoration-of-restoration (IpRestoRestoPhase.cpp): the resto NLP
        # is always feasible, so on a nested failure reset (p, n) at the
        # current x and continue, at most max_resto_resto_iters times.
        fail = ((s_next.status == int(SolverReturn.ERROR_IN_STEP_COMPUTATION))
                | (s_next.status == int(SolverReturn.RESTORATION_FAILURE)))
        do_rr = fail & (s_next.restoration_count < opts.max_resto_resto_iters)
        if not host_bool(do_rr.any()):
            return s_next
        Bs = s_next.it.x.shape[0]
        x_cur = s_next.it.x[:, :n]
        c_o, d_o = o.eval_cd(x_cur)
        it_outer_like = Iterate(
            x=x_cur, s=s_next.it.s,
            y_c=x_cur.new_zeros((Bs, me)), y_d=x_cur.new_zeros((Bs, mi)),
            z_L=s_next.it.z_L[:, :n], z_U=s_next.it.z_U[:, :n],
            v_L=s_next.it.v_L, v_U=s_next.it.v_U)
        it_rr = resto_initial_iterate(o, opts, it_outer_like, c_o,
                                      d_o - s_next.it.s, s_next.mu)
        return s_next._replace(
            it=tree_where(do_rr, it_rr, s_next.it),
            status=torch.where(do_rr, int(SolverReturn.CONTINUE), s_next.status),
            restoration_count=s_next.restoration_count + do_rr.long(),
            fs=tree_where(do_rr, filter_init(Bs, opts.max_filter_size, dtype, dev),
                          s_next.fs))

    max_resto = min(opts.max_iter, opts.max_resto_iter)
    while True:
        done_prog = (st_r.iter_count != 0) & progress(st_r)
        cont = ((st_r.status == int(SolverReturn.CONTINUE)) & ~done_prog
                & (st_r.iter_count < max_resto))
        if not host_bool(cont.any()):
            break
        if host_bool(cont.all()):
            st_r = body(rnlp, orig, st_r)
        else:
            idx = cont.nonzero().squeeze(-1)
            sub = body(rnlp.take(idx), orig.take(idx), tree_take(st_r, idx))
            st_r = tree_put(st_r, idx, sub)
    final = st_r

    success = progress(final)
    resto_converged = ((final.status == int(SolverReturn.SUCCESS))
                       | (final.status == int(SolverReturn.STOP_AT_ACCEPTABLE_POINT)))
    locally_infeasible = ~success & resto_converged
    failed = ~success & ~resto_converged

    # ---- return to the main algorithm -----------------------------------
    x_new = final.it.x[:, :n]
    s_new = final.it.s
    it_new = it._replace(x=x_new, s=s_new)

    # Pretend-Newton bound multiplier update (ComputeBoundMultiplierStep).
    sl_old = slacks(orig, it)
    sl_new = slacks(orig, it_new)
    m = col(outer_mu)

    def dz_of(z, slo, sln, has):
        dz = (m + z * (slo - sln)) / slo - z
        return torch.where(has, dz, torch.zeros_like(dz))

    dz_L = dz_of(it.z_L, sl_old[0], sl_new[0], orig.has_xL)
    dz_U = dz_of(it.z_U, sl_old[1], sl_new[1], orig.has_xU)
    dv_L = dz_of(it.v_L, sl_old[2], sl_new[2], orig.has_dL)
    dv_U = dz_of(it.v_U, sl_old[3], sl_new[3], orig.has_dU)
    step = Iterate(x=torch.zeros_like(x_new), s=torch.zeros_like(s_new),
                   y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
                   z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
    _, alpha_dual = kkt.fraction_to_boundary(
        orig, it, step, torch.clamp(1.0 - outer_mu, min=opts.tau_min))
    ad = col(alpha_dual)
    z_L = it.z_L + ad * dz_L
    z_U = it.z_U + ad * dz_U
    v_L = it.v_L + ad * dv_L
    v_U = it.v_U + ad * dv_U
    zmax = torch.maximum(
        torch.maximum(max_init(z_L.abs(), 0.0), max_init(z_U.abs(), 0.0)),
        torch.maximum(max_init(v_L.abs(), 0.0), max_init(v_U.abs(), 0.0)))
    reset = (zmax > opts.bound_mult_reset_threshold)[:, None]

    def one_where(has, v):
        return torch.where(reset, has.to(v.dtype), v)

    z_L, z_U = one_where(orig.has_xL, z_L), one_where(orig.has_xU, z_U)
    v_L, v_U = one_where(orig.has_dL, v_L), one_where(orig.has_dU, v_U)

    # Equality multipliers: least squares capped at constr_mult_reset_threshold
    # (default 0 -> reset to zero).
    _, grad_f, _, _, J_c, J_d = orig.eval_all(x_new)
    y_c, y_d = least_squares_y(orig, x_new, s_new, grad_f, J_c, J_d,
                               z_L, z_U, v_L, v_U,
                               max(opts.constr_mult_reset_threshold, 1e-30))
    it_out = Iterate(x=x_new, s=s_new, y_c=y_c, y_d=y_d,
                     z_L=z_L, z_U=z_U, v_L=v_L, v_U=v_U)
    return RestoResult(it=it_out, success=success,
                       locally_infeasible=locally_infeasible, failed=failed,
                       resto_iters=final.iter_count)
