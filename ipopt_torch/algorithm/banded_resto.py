"""Restoration phase of the general-sparsity (banded) backend, over the lanes
that need it (port of ``ipopt_tpu/algorithm/banded_resto.py``).

The restoration NLP of a sparse problem is sparse too: the variables widen
to [x | n_rows (m) | p_rows (m)] and every constraint row becomes
g_r(x) - p_r + n_r, so its KKT pattern is the original one plus identity
couplings.  ``sparse.canonicalize_sparse`` analyzed it once
(``BandedInfo.resto``), and it runs on the same banded backend.  The
semantics follow ``restoration.py``; on return the equality multipliers are
zero, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import Iterate, SolverReturn, col, max_init, tree_put, tree_take
from ..problem import CanonicalNLP, CanonicalStructure
from ..options import Options
from ..sparse import BandedInfo, _row_scale
from .. import kkt
from ..kkt import evaluate, slacks, barrier_obj
from .linesearch import FilterState, filter_acceptable, filter_init
from .restoration import RestoResult, _solve_quadratic_pn


def build_resto_banded(orig: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """The banded restoration CanonicalNLP over the lanes of ``orig``; its
    ``params["resto"]`` (reference point, eta, row scales) are filled in by
    ``perform_restoration_banded``."""
    info: BandedInfo = orig.chain
    s = orig.struct
    n, m = info.n, s.m
    nr = n + 2 * m
    rho = float(opts.resto_penalty_parameter)
    orig_g = orig.g
    B, dtype, dev = orig.batch, orig.dtype, orig.device

    def f_flat(xfull, params):
        x, pn, th = xfull[:n], xfull[n:], params["resto"]
        dr = 1.0 / torch.clamp(th["xref"].abs(), min=1.0)
        return (rho * pn.sum()
                + 0.5 * th["eta"] * ((dr * (x - th["xref"])) ** 2).sum())

    def g_flat(xfull, params):
        x, nn, pp = xfull[:n], xfull[n:n + m], xfull[n + m:]
        return params["resto"]["rscale"] * orig_g(x, params["orig"]) - pp + nn

    struct = CanonicalStructure(
        n_full=nr, n=nr, m=m, me=s.me, mi=s.mi,
        eq_idx=s.eq_idx, ineq_idx=s.ineq_idx,
        free_idx=np.arange(nr, dtype=np.int32),
        fixed_idx=np.zeros((0,), np.int32),
        fixed_treatment="make_parameter")

    def widen(v, pn_val):
        return torch.cat([v, torch.full((B, 2 * m), pn_val, dtype=v.dtype, device=dev)], -1)

    return CanonicalNLP(
        struct=struct, f=f_flat, g=g_flat,
        params={"orig": orig.params, "resto": None},
        x_L=widen(orig.x_L, 0.0), x_U=widen(orig.x_U, 0.0),
        d_L=orig.d_L, d_U=orig.d_U,
        has_xL=widen(orig.has_xL, True), has_xU=widen(orig.has_xU, False),
        has_dL=orig.has_dL, has_dU=orig.has_dU,
        c_rhs=orig.c_scale * orig.c_rhs,
        x_fixed=torch.zeros((B, nr), dtype=dtype, device=dev),
        x0=widen(orig.x0, 1.0),
        x_L_orig=widen(orig.x_L_orig, 0.0), x_U_orig=widen(orig.x_U_orig, 0.0),
        obj_scale=torch.ones((B,), dtype=dtype, device=dev),
        c_scale=torch.ones((B, s.me), dtype=dtype, device=dev),
        d_scale=torch.ones((B, s.mi), dtype=dtype, device=dev),
        chain=info.resto)


def perform_restoration_banded(orig: CanonicalNLP, opts: Options,
                               resto_opts: Options, it: Iterate, ev,
                               outer_mu, fs: FilterState, theta_outer,
                               phi_outer, ipm_step_fn) -> RestoResult:
    """Run the nested banded restoration IPM for every lane of ``orig`` (all
    of which entered restoration); ``ipm_step_fn(nlp, opts, state)`` is the
    solver's step without a restoration fallback."""
    from .solver import IPMState, counters_init, robust_state_init

    s = orig.struct
    n, m = orig.chain.n, s.m
    B, dtype, dev = orig.batch, it.x.dtype, it.x.device
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)

    c_val = ev.c
    dms_val = ev.d - it.s
    theta_entry_inf = torch.maximum(max_init(c_val.abs(), 0.0),
                                    max_init(dms_val.abs(), 0.0))
    resto_mu = torch.maximum(outer_mu, theta_entry_inf)
    eta = opts.resto_proximity_weight * torch.sqrt(resto_mu)

    resto = build_resto_banded(orig, opts)
    resto = resto._replace(params={"orig": orig.params, "resto": {
        "xref": it.x, "eta": eta, "rscale": _row_scale(orig)}})

    # entry iterate (RestoIterateInitializer closed form), rows in user order
    rho = opts.resto_penalty_parameter
    rows = it.x.new_zeros((B, m))
    if s.me:
        rows[:, s.index("eq_idx", dev)] = c_val
    if s.mi:
        rows[:, s.index("ineq_idx", dev)] = dms_val
    n_row = torch.clamp(_solve_quadratic_pn(resto_mu, rho, rows), min=1e-30)
    p_row = torch.clamp(rows + n_row, min=1e-30)
    z_pn = col(resto_mu) / torch.cat([n_row, p_row], -1)
    it_r = Iterate(
        x=torch.cat([it.x, n_row, p_row], -1), s=it.s,
        y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
        z_L=torch.cat([torch.clamp(it.z_L, max=rho), z_pn], -1),
        z_U=torch.cat([torch.clamp(it.z_U, max=rho), torch.zeros_like(z_pn)], -1),
        v_L=torch.clamp(it.v_L, max=rho), v_U=torch.clamp(it.v_U, max=rho))

    ev_r = evaluate(resto, it_r.x)
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

    inf_pr_req = torch.clamp(opts.required_infeasibility_reduction * theta_entry_inf,
                             min=min(opts.tol, opts.constr_viol_tol))

    def orig_progress(s_r):
        """The exit test (RestoConvergenceCheck + TestOrigProgress) on the
        original problem at the resto iterate."""
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

    max_resto = min(opts.max_iter, opts.max_resto_iter)
    while True:
        done_prog = (st_r.iter_count != 0) & orig_progress(st_r)
        cont = ((st_r.status == int(SolverReturn.CONTINUE)) & ~done_prog
                & (st_r.iter_count < max_resto))
        if not bool(cont.any()):
            break
        if bool(cont.all()):
            st_r = ipm_step_fn(resto, resto_opts, st_r)
        else:
            idx = cont.nonzero().squeeze(-1)
            st_r = tree_put(st_r, idx, ipm_step_fn(resto.take(idx), resto_opts,
                                                   tree_take(st_r, idx)))
    final = st_r

    success = orig_progress(final)
    resto_converged = ((final.status == int(SolverReturn.SUCCESS))
                       | (final.status == int(SolverReturn.STOP_AT_ACCEPTABLE_POINT)))
    locally_infeasible = ~success & resto_converged
    failed = ~success & ~resto_converged

    # ---- return to the main algorithm -----------------------------------
    x_new = final.it.x[:, :n]
    s_new = final.it.s
    it_new = it._replace(x=x_new, s=s_new)
    sl_old = slacks(orig, it)
    sl_new = slacks(orig, it_new)
    mu_c = col(outer_mu)

    def dz_of(z, slo, sln, has):
        dz = (mu_c + z * (slo - sln)) / slo - z
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
    z_L, z_U = it.z_L + ad * dz_L, it.z_U + ad * dz_U
    v_L, v_U = it.v_L + ad * dv_L, it.v_U + ad * dv_U
    zmax = torch.maximum(
        torch.maximum(max_init(z_L.abs(), 0.0), max_init(z_U.abs(), 0.0)),
        torch.maximum(max_init(v_L.abs(), 0.0), max_init(v_U.abs(), 0.0)))
    reset = (zmax > opts.bound_mult_reset_threshold)[:, None]

    def one_where(has, val):
        return torch.where(reset, has.to(val.dtype), val)

    it_out = Iterate(x=x_new, s=s_new,
                     y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
                     z_L=one_where(orig.has_xL, z_L), z_U=one_where(orig.has_xU, z_U),
                     v_L=one_where(orig.has_dL, v_L), v_U=one_where(orig.has_dU, v_U))
    return RestoResult(it=it_out, success=success,
                       locally_infeasible=locally_infeasible, failed=failed,
                       resto_iters=final.iter_count)
