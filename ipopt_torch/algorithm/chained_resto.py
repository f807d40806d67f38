"""Restoration phase of the chained (block-tridiagonal) backend, over the
lanes that need it (port of ``ipopt_tpu/algorithm/chained_resto.py``).

The restoration NLP of a chained problem is chained too: each variable group
widens from [x_k (v)] to [x_k | n_k (mk) | p_k (mk)] and the stage
constraints become  g_k(x_k, x_{k+1}) - p_k + n_k  with the original bounds,
so its KKT system stays block-tridiagonal (blocks v + 4 mk wide) and runs on
the same BCR backend.  The semantics follow ``restoration.py``; the terminal
group's p/n slots are dummies that the rho-penalty drives to zero.  On
return the equality multipliers are zero (``chained_resto.py:323-325``), not
the least-squares estimate of the dense restoration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import Iterate, SolverReturn, col, max_init, tree_put, tree_take
from ..problem import CanonicalNLP, CanonicalStructure
from ..options import Options
from ..profiling import host_bool
from ..chained import ChainInfo, flat_callables, row_scale, scatter_rows
from .. import kkt
from ..kkt import evaluate, slacks, barrier_obj
from .linesearch import FilterState, filter_acceptable, filter_init
from .restoration import RestoResult, _solve_quadratic_pn


def build_resto_chained(orig: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """The chained restoration CanonicalNLP over the lanes of ``orig``; its
    ``params`` (reference point, eta, row scales) are filled in by
    ``perform_restoration_chained``."""
    ch: ChainInfo = orig.chain
    K, v, mk = ch.K, ch.v, ch.mk
    vr = v + 2 * mk            # resto group width: [x | n | p]
    nr = (K + 1) * vr
    rho = float(opts.resto_penalty_parameter)
    s = orig.struct
    g_stage = ch.g_stage
    B, dtype, dev = orig.batch, orig.dtype, orig.device

    def split_w(w):
        return w[:v], w[v:v + mk], w[v + mk:]

    def f_stage_r(wk, wk1, th):
        xk, nk, pk = split_w(wk)
        xk1, nk1, pk1 = split_w(wk1)
        dr = 1.0 / torch.clamp(th["xref"].abs(), min=1.0)
        val = (rho * (nk.sum() + pk.sum())
               + 0.5 * th["eta"][0] * ((dr * (xk - th["xref"])) ** 2).sum())
        # the terminal group's prox + penalty ride on the last stage
        dr1 = 1.0 / torch.clamp(th["xref1"].abs(), min=1.0)
        return val + th["is_last"][0] * (
            rho * (nk1.sum() + pk1.sum())
            + 0.5 * th["eta"][0] * ((dr1 * (xk1 - th["xref1"])) ** 2).sum())

    def g_stage_r(wk, wk1, th):
        # rows in the original problem's scaled space (th["rscale"]), so the
        # resto bounds come scaled from the original canonical form
        xk, nk, pk = split_w(wk)
        xk1, _, _ = split_w(wk1)
        return th["rscale"] * g_stage(xk, xk1, th["theta"]) - pk + nk

    info_r = ChainInfo(K=K, v=vr, mk=mk, f_stage=f_stage_r, g_stage=g_stage_r,
                       f_last=None, eq_mask=ch.eq_mask)
    f_flat, g_flat = flat_callables(K, vr, f_stage_r, g_stage_r)
    struct = CanonicalStructure(
        n_full=nr, n=nr, m=K * mk, me=s.me, mi=s.mi,
        eq_idx=s.eq_idx, ineq_idx=s.ineq_idx,
        free_idx=np.arange(nr, dtype=np.int32),
        fixed_idx=np.zeros((0,), np.int32),
        fixed_treatment="make_parameter")

    def widen(xgrp, pn_val):
        """(B, (K+1) v) -> (B, (K+1) vr) with the p/n slots set to pn_val."""
        pad = torch.full((B, K + 1, 2 * mk), pn_val, dtype=xgrp.dtype, device=dev)
        return torch.cat([xgrp.reshape(B, K + 1, v), pad], 2).reshape(B, -1)

    return CanonicalNLP(
        struct=struct, f=f_flat, g=g_flat, params={"theta": None},
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
        chain=info_r)


def perform_restoration_chained(orig: CanonicalNLP, opts: Options,
                                resto_opts: Options, it: Iterate, ev,
                                outer_mu, fs: FilterState, theta_outer,
                                phi_outer, ipm_step_fn) -> RestoResult:
    """Run the nested chained restoration IPM for every lane of ``orig`` (all
    of which entered restoration); ``ipm_step_fn(nlp, opts, state)`` is the
    solver's step without a restoration fallback."""
    ch: ChainInfo = orig.chain
    K, v, mk = ch.K, ch.v, ch.mk
    vr = v + 2 * mk
    B, dtype, dev = orig.batch, it.x.dtype, it.x.device

    c_val = ev.c
    dms_val = ev.d - it.s
    theta_entry_inf = torch.maximum(max_init(c_val.abs(), 0.0),
                                    max_init(dms_val.abs(), 0.0))
    resto_mu = torch.maximum(outer_mu, theta_entry_inf)
    eta = opts.resto_proximity_weight * torch.sqrt(resto_mu)

    Xref = it.x.reshape(B, K + 1, v)
    is_last = (torch.arange(K, device=dev) == K - 1).to(dtype)[:, None]
    resto = build_resto_chained(orig, opts)
    resto = resto._replace(params={"theta": {
        "theta": orig.params["theta"],
        "xref": Xref[:, :-1],
        "xref1": Xref[:, 1:],
        "eta": eta[:, None, None].expand(B, K, 1),
        "is_last": is_last.expand(B, K, 1),
        "rscale": row_scale(orig),
    }})

    # entry iterate: (n, p) from the row residuals (c on equality rows,
    # d - s on inequality rows)
    rho = opts.resto_penalty_parameter
    rows = scatter_rows(orig, c_val, dms_val).reshape(B, -1)
    n_row = torch.clamp(_solve_quadratic_pn(resto_mu, rho, rows), min=1e-30)
    p_row = torch.clamp(rows + n_row, min=1e-30)
    NP = torch.cat([n_row.reshape(B, K, mk), p_row.reshape(B, K, mk)], 2)
    NP_full = torch.cat([NP, torch.ones((B, 1, 2 * mk), dtype=dtype, device=dev)], 1)
    z_pn = resto_mu[:, None, None] / NP_full
    it_r = Iterate(
        x=torch.cat([Xref, NP_full], 2).reshape(B, -1), s=it.s,
        y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
        z_L=torch.cat([torch.clamp(it.z_L, max=rho).reshape(B, K + 1, v), z_pn],
                      2).reshape(B, -1),
        z_U=torch.cat([torch.clamp(it.z_U, max=rho).reshape(B, K + 1, v),
                       torch.zeros_like(z_pn)], 2).reshape(B, -1),
        v_L=torch.clamp(it.v_L, max=rho), v_U=torch.clamp(it.v_U, max=rho))

    return run_structured_restoration(
        orig, opts, resto_opts, it, outer_mu, fs, theta_outer, phi_outer,
        ipm_step_fn, resto, it_r, theta_entry_inf, resto_mu,
        lambda x_r: x_r.reshape(x_r.shape[0], K + 1, vr)[:, :, :v].reshape(
            x_r.shape[0], -1))


def run_structured_restoration(orig: CanonicalNLP, opts: Options,
                               resto_opts: Options, it: Iterate, outer_mu,
                               fs: FilterState, theta_outer, phi_outer,
                               ipm_step_fn, resto: CanonicalNLP, it_r: Iterate,
                               theta_entry_inf, resto_mu, extract_x) -> RestoResult:
    """The nested restoration IPM of a structured backend (chained, banded,
    arrow) from its restoration NLP ``resto`` and entry iterate ``it_r``,
    with the exit test on the original problem and the return to the main
    algorithm; ``extract_x`` maps a restoration x to the original x.  On
    return the equality multipliers are zero (``chained_resto.py:323-325``),
    not the least-squares estimate of the dense restoration."""
    from .solver import IPMState, counters_init, robust_state_init

    B, dtype, dev = orig.batch, it.x.dtype, it.x.device
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)
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
        x = extract_x(s_r.it.x)
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
        if not host_bool(cont.any()):
            break
        if host_bool(cont.all()):
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
    x_new = extract_x(final.it.x)
    s_new = final.it.s
    it_new = it._replace(x=x_new, s=s_new)
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
