"""Restoration phase of the scenario (block-arrow) backend, over the lanes
that need it (port of ``ipopt_tpu/algorithm/arrow_resto.py``).

The restoration NLP of a scenario problem is a scenario problem too: each
scenario's variable group widens from [x_s (ns)] to [x_s | n_s (ms) | p_s
(ms)] and the scenario constraints become g_s(x0, x_s) - p_s + n_s, so its
KKT system keeps the arrow shape and runs on the same backend.  The
first-stage variables x0 carry only the proximity term, spread over the
scenarios (each carries 1/S of it).  The semantics follow ``restoration.py``
(``RestoIpoptNLP`` eta/rho terms, the p/n closed form of
``RestoIterateInitializer``, the exit test on the original problem).
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import Iterate, max_init
from ..problem import CanonicalNLP, CanonicalStructure
from ..options import Options
from ..parallel.scenario import (ArrowInfo, flat_callables, scatter_rows,
                                 _row_scale)
from .linesearch import FilterState
from .restoration import RestoResult, _solve_quadratic_pn
from .chained_resto import run_structured_restoration


def _widen(ar: ArrowInfo, x, pad):
    """(B, n0 + S ns) -> (B, n0 + S (ns + 2 ms)), the p/n slots ``pad``."""
    B = x.shape[0]
    Xs = x[:, ar.n0:].reshape(B, ar.S, ar.ns)
    fill = torch.full((B, ar.S, 2 * ar.ms), pad, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, :ar.n0], torch.cat([Xs, fill], 2).reshape(B, -1)], -1)


def build_resto_arrow(orig: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """The arrow restoration CanonicalNLP over the lanes of ``orig``
    (``arrow_resto.py:33-120``); its ``params`` (reference points, eta, row
    scales) are filled in by ``perform_restoration_arrow``."""
    ar: ArrowInfo = orig.chain
    S, n0, ns, ms = ar.S, ar.n0, ar.ns, ar.ms
    nsr = ns + 2 * ms
    nr = n0 + S * nsr
    rho = float(opts.resto_penalty_parameter)
    s = orig.struct
    g_scen = ar.g_scen
    B, dtype, dev = orig.batch, orig.dtype, orig.device

    def split_w(w):
        return w[:ns], w[ns:ns + ms], w[ns + ms:]

    def f_scen_r(x0v, ws, th):
        xs, nk, pk = split_w(ws)
        drs = 1.0 / torch.clamp(th["xsref"].abs(), min=1.0)
        dr0 = 1.0 / torch.clamp(th["x0ref"].abs(), min=1.0)
        val = (rho * (nk.sum() + pk.sum())
               + 0.5 * th["eta"][0] * ((drs * (xs - th["xsref"])) ** 2).sum())
        return val + (0.5 * th["eta"][0] / S
                      * ((dr0 * (x0v - th["x0ref"])) ** 2).sum())

    def g_scen_r(x0v, ws, th):
        # rows in the original problem's scaled space (th["rscale"])
        xs, nk, pk = split_w(ws)
        return th["rscale"] * g_scen(x0v, xs, th["theta"]) - pk + nk

    info_r = ArrowInfo(S=S, n0=n0, ns=nsr, ms=ms, f_scen=f_scen_r,
                       g_scen=g_scen_r, f0=None, eq_mask=ar.eq_mask)
    f_flat, g_flat = flat_callables(S, n0, nsr, f_scen_r, g_scen_r)
    struct = CanonicalStructure(
        n_full=nr, n=nr, m=S * ms, me=s.me, mi=s.mi,
        eq_idx=s.eq_idx, ineq_idx=s.ineq_idx,
        free_idx=np.arange(nr, dtype=np.int32),
        fixed_idx=np.zeros((0,), np.int32),
        fixed_treatment="make_parameter")
    return CanonicalNLP(
        struct=struct, f=f_flat, g=g_flat, params={"theta": None},
        x_L=_widen(ar, orig.x_L, 0.0), x_U=_widen(ar, orig.x_U, 0.0),
        d_L=orig.d_L, d_U=orig.d_U,
        has_xL=_widen(ar, orig.has_xL, True), has_xU=_widen(ar, orig.has_xU, False),
        has_dL=orig.has_dL, has_dU=orig.has_dU,
        c_rhs=orig.c_scale * orig.c_rhs,
        x_fixed=torch.zeros((B, nr), dtype=dtype, device=dev),
        x0=_widen(ar, orig.x0, 1.0),
        x_L_orig=_widen(ar, orig.x_L_orig, 0.0),
        x_U_orig=_widen(ar, orig.x_U_orig, 0.0),
        obj_scale=torch.ones((B,), dtype=dtype, device=dev),
        c_scale=torch.ones((B, s.me), dtype=dtype, device=dev),
        d_scale=torch.ones((B, s.mi), dtype=dtype, device=dev),
        chain=info_r)


def perform_restoration_arrow(orig: CanonicalNLP, opts: Options,
                              resto_opts: Options, it: Iterate, ev,
                              outer_mu, fs: FilterState, theta_outer,
                              phi_outer, ipm_step_fn) -> RestoResult:
    """Run the nested arrow restoration IPM for every lane of ``orig`` (all
    of which entered restoration), ``arrow_resto.py:135-332``;
    ``ipm_step_fn(nlp, opts, state)`` is the solver's step without a
    restoration fallback."""
    ar: ArrowInfo = orig.chain
    S, n0, ns, ms = ar.S, ar.n0, ar.ns, ar.ms
    nsr = ns + 2 * ms
    B = orig.batch

    c_val = ev.c
    dms_val = ev.d - it.s
    theta_entry_inf = torch.maximum(max_init(c_val.abs(), 0.0),
                                    max_init(dms_val.abs(), 0.0))
    resto_mu = torch.maximum(outer_mu, theta_entry_inf)
    eta = opts.resto_proximity_weight * torch.sqrt(resto_mu)

    x0ref = it.x[:, :n0]
    Xsref = it.x[:, n0:].reshape(B, S, ns)
    resto = build_resto_arrow(orig, opts)
    resto = resto._replace(params={"theta": {
        "theta": orig.params["theta"],
        "xsref": Xsref,
        "x0ref": x0ref[:, None, :].expand(B, S, n0),
        "eta": eta[:, None, None].expand(B, S, 1),
        "rscale": _row_scale(orig),
    }})

    # entry iterate (RestoIterateInitializer closed form) from the row
    # residuals: c on equality rows, d - s on inequality rows
    rho = opts.resto_penalty_parameter
    rows = scatter_rows(orig, c_val, dms_val).reshape(B, -1)
    n_row = torch.clamp(_solve_quadratic_pn(resto_mu, rho, rows), min=1e-30)
    p_row = torch.clamp(rows + n_row, min=1e-30)
    NP = torch.cat([n_row.reshape(B, S, ms), p_row.reshape(B, S, ms)], 2)
    z_pn = resto_mu[:, None, None] / NP

    def group(v0, vs, pad):
        return torch.cat([v0, torch.cat([vs.reshape(B, S, ns), pad], 2).reshape(B, -1)], -1)

    zl_x = torch.clamp(it.z_L, max=rho)
    zu_x = torch.clamp(it.z_U, max=rho)
    it_r = Iterate(
        x=group(x0ref, Xsref, NP), s=it.s,
        y_c=torch.zeros_like(it.y_c), y_d=torch.zeros_like(it.y_d),
        z_L=group(zl_x[:, :n0], zl_x[:, n0:], z_pn),
        z_U=group(zu_x[:, :n0], zu_x[:, n0:], torch.zeros_like(z_pn)),
        v_L=torch.clamp(it.v_L, max=rho), v_U=torch.clamp(it.v_U, max=rho))

    def extract_x(x_r):
        Bx = x_r.shape[0]
        return torch.cat([x_r[:, :n0], x_r[:, n0:].reshape(Bx, S, nsr)[:, :, :ns]
                          .reshape(Bx, -1)], -1)

    return run_structured_restoration(
        orig, opts, resto_opts, it, outer_mu, fs, theta_outer, phi_outer,
        ipm_step_fn, resto, it_r, theta_entry_inf, resto_mu, extract_x)
