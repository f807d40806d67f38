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

from ..types import Iterate, col, max_init
from ..problem import CanonicalNLP, CanonicalStructure
from ..options import Options
from ..sparse import BandedInfo, _row_scale
from .linesearch import FilterState
from .restoration import RestoResult, _solve_quadratic_pn
from .chained_resto import run_structured_restoration


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
    s = orig.struct
    n, m = orig.chain.n, s.m
    B, dev = orig.batch, it.x.device

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

    return run_structured_restoration(
        orig, opts, resto_opts, it, outer_mu, fs, theta_outer, phi_outer,
        ipm_step_fn, resto, it_r, theta_entry_inf, resto_mu, lambda x_r: x_r[:, :n])
