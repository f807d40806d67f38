"""Search direction: the PDFullSpaceSolver + PDPerturbationHandler equivalent,
over a batch (port of ``ipopt_tpu/algorithm/step.py``), with five KKT
backends chosen by the problem (``_backend``): the dense augmented system
(K1), the block-tridiagonal system of a chained problem (``chained_kkt.py``,
BCR with K2), the RCM-banded system of a flat problem with
``linear_solver="banded-bcr"`` (``ipopt_torch/sparse.py``, the same BCR),
its nested-dissection fronts with ``linear_solver="multifrontal"``
(``linalg/nested_dissection.py``, K1 on every level), and the block-arrow
system of a scenario problem (``arrow_kkt.py``, K1 on the scenario blocks).  A limited-memory Hessian (``quasi_newton.LowRankW``)
is solved by Sherman-Morrison-Woodbury around the backend's base system
(``lowrank_kkt.py`` on the dense backend, ``lowrank_struct.py`` on the
others).

The reference runs each retry loop per instance under ``vmap``; here each
loop runs over the batch while any lane is still active, and a lane that is
done keeps its values (``torch.where`` on the active mask), so every lane
ends with the values and counters the reference gives that instance alone:
- the inertia-correction retry (``step.py:208-239``): every round factors
  the KKT of every lane with one batched factorization;
- iterative refinement (``step.py:120-157``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate, col, tree_where, max_init, torch_dtype
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool, span
from ..kkt import (Evals, sigmas, assemble_aug_system, condensed_rhs_parts,
                   split_aug_solution, recover_bound_mult_steps,
                   grad_barrier_x, grad_barrier_s, jac_t)
from ..linalg.ldlt import ldlt, ldlt_blocked, ldlt_solve, LDLTResult


class StepResult(NamedTuple):
    step: Iterate
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any
    residual_ratio: Any
    fac: Any   # LDLTResult (dense) or BCRFactor (chained, banded)
    K: Any


def _sym_ruiz_scale(K, sweeps: int = 2):
    """Symmetric Ruiz equilibration (the MC19 analog): D K D with
    D_i = prod sqrt(1/row_inf_norm), per lane."""
    d = torch.ones(K.shape[:-1], dtype=K.dtype, device=K.device)
    for _ in range(sweeps):
        Ks = K * d[:, :, None] * d[:, None, :]
        rn = torch.sqrt(torch.clamp(max_init(Ks.abs(), 0.0), min=1e-30))
        d = d / rn
    return torch.clamp(d, 1e-8, 1e8)


def _factorize(K, opts: Options) -> LDLTResult:
    """Factorize K, optionally after symmetric equilibration, in
    ``factorization_dtype`` (cast after the equilibration, as the reference
    does): the solves refine against the full-precision K."""
    if opts.linear_system_scaling == "mc19":
        d = _sym_ruiz_scale(K)
        Ks = K * d[:, :, None] * d[:, None, :]
    else:
        d = None
        Ks = K
    if opts.factorization_dtype:
        Ks = Ks.to(torch_dtype(opts.factorization_dtype))
    if opts.linear_solver == "dense-ldlt-blocked":
        fac = ldlt_blocked(Ks, block=opts.kkt_block_size, pivot_tol=opts.ldlt_pivot_tol)
    else:
        # dense-ldlt, and condensed-cholesky, which the reference accepts and
        # routes here too (step.py:80-83)
        fac = ldlt(Ks, pivot_tol=opts.ldlt_pivot_tol)
    if d is not None:
        fac = fac._replace(row_scale=d.to(Ks.dtype))
    return fac


def _matvec(K, s):
    return torch.matmul(K, s.unsqueeze(-1)).squeeze(-1)


def refine(matvec, solve, rhs, opts: Options, improvement: bool = True,
           dtypes=None):
    """Solve K x = rhs per lane with iterative refinement
    (IpPDFullSpaceSolver.cpp:235-345), given the products ``matvec(x)`` = K x
    and the factorized solve ``solve(r)``; returns (sol, residual ratio).
    ``improvement=False`` drops the residual_improvement_factor test, as the
    reference's arrow and low-rank refinements do (``arrow_kkt.py:270-298``,
    ``lowrank_kkt.py:255-295``).  ``dtypes`` = (model, acc, fac) of the mixed
    precision modes (``refine_dtypes``): each solve's right-hand side goes to
    the factor's dtype, the solution accumulates and ``matvec`` forms the
    residuals in ``acc``, and the result is returned in the model's dtype
    (``step.py:93-140``); by default all three are rhs's."""
    model_dt, acc_dt, fac_dt = dtypes or (rhs.dtype,) * 3

    def solve_acc(r):
        return solve(r.to(fac_dt)).to(acc_dt)

    rhs = rhs.to(acc_dt)
    sol = solve_acc(rhs)
    B = rhs.shape[0]
    if opts.fast_step_computation:
        # no refinement and no residual check (IpPDFullSpaceSolver.cpp)
        return sol.to(model_dt), rhs.new_zeros((B,), dtype=model_dt)
    rhs_norm = torch.clamp(max_init(rhs.abs(), 0.0), min=1e-30)

    def ratio(s):
        return max_init((rhs - matvec(s)).abs(), 0.0) / rhs_norm

    i = torch.zeros((B,), dtype=torch.int64, device=rhs.device)
    rr = ratio(sol)
    imp = improvement and opts.residual_improvement_factor < 1e19
    while True:
        active = (i < opts.min_refinement_steps) | (
            (i < opts.max_refinement_steps) & (rr > opts.residual_ratio_max))
        if not host_bool(active.any()):
            break
        r = rhs - matvec(sol)
        sol2 = sol + solve_acc(r)
        rr2 = ratio(sol2)
        i2 = i + 1
        if imp:
            # stop when a step fails to improve the ratio enough
            improved = rr2 <= opts.residual_improvement_factor * rr
            keep = improved | (i < opts.min_refinement_steps)
            sol2 = tree_where(keep, sol2, sol)
            rr2 = torch.where(keep, rr2, rr)
            i2 = torch.where(keep, i2, torch.full_like(i, opts.max_refinement_steps))
        sol = tree_where(active, sol2, sol)
        rr = torch.where(active, rr2, rr)
        i = torch.where(active, i2, i)
    return sol.to(model_dt), rr.to(model_dt)


def refine_dtypes(opts: Options, model_dtype, fac_dtype):
    """(model, acc, fac) for ``refine``: ``refinement_precision="double"``
    accumulates in float64, else in the model's dtype (the assembled K's)."""
    acc = torch.float64 if opts.refinement_precision == "double" else model_dtype
    return model_dtype, acc, fac_dtype


def solve_with_refinement(K, fac: LDLTResult, rhs, opts: Options):
    """``refine`` on the dense augmented matrices K (B, N, N); the residuals
    are taken against K in the accumulation dtype, whatever the factor's."""
    dts = refine_dtypes(opts, K.dtype, fac.L.dtype)
    K_a = K.to(dts[1])
    return refine(lambda s: _matvec(K_a, s), lambda r: ldlt_solve(fac, r), rhs,
                  opts, dtypes=dts)


def perturbation_start(opts: Options, delta_w_last):
    """The first delta_x of an inertia-correction retry loop and its growth
    factor per lane (PDPerturbationHandler, ``step.py:208-239``): from
    first_hessian_perturbation and perturb_inc_fact_first after a step
    without one, else from delta_w_last decreased, growing by
    perturb_inc_fact."""
    start = torch.where(
        delta_w_last == 0,
        torch.full_like(delta_w_last, opts.first_hessian_perturbation),
        torch.clamp(delta_w_last * opts.perturb_dec_fact,
                    min=opts.min_hessian_perturbation))
    inc = torch.where(delta_w_last == 0,
                      torch.full_like(delta_w_last, opts.perturb_inc_fact_first),
                      torch.full_like(delta_w_last, opts.perturb_inc_fact))
    return start, inc


class RetryResult(NamedTuple):
    K: Any
    fac: Any
    delta_x: Any
    delta_c: Any
    trials: Any
    ok: Any
    gave_up: Any


def regularized_retry(opts: Options, factor, delta_cd, delta_w_last,
                      singular=lambda fac: fac.singular) -> RetryResult:
    """The inertia-correction loop of the always dual-regularized backends
    (chained, sharded chain, arrow, structured low-rank; the reference's
    ``chained_kkt.py:163-260``) around ``factor(delta_x, delta_c) -> (K,
    fac, ok)``.  Unpivoted block elimination needs every diagonal block
    invertible, which a full-rank Jacobian does not imply, so delta_c starts
    at ``delta_cd`` (B,) and, on repeated singularity (``singular(fac)``),
    escalates to at most 1e-4; delta_x follows ``perturbation_start``.  Each
    round factors every lane; a lane that is done keeps its matrix, factor
    and deltas."""
    dxv = torch.zeros_like(delta_cd)
    dcv = delta_cd
    with span("kkt.factorize"):
        K, fac, ok = factor(dxv, dcv)
    trials = torch.ones(delta_cd.shape, dtype=torch.int64, device=delta_cd.device)
    gave_up = torch.zeros(delta_cd.shape, dtype=torch.bool, device=delta_cd.device)
    while True:
        active = ~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)
        if not host_bool(active.any()):
            break
        was_singular = singular(fac)
        only_dc = was_singular & (dcv <= delta_cd)
        new_dc = torch.where(was_singular,
                             torch.clamp(torch.maximum(dcv * 100.0, delta_cd),
                                         max=1e-4), dcv)
        start_val, inc_fact = perturbation_start(opts, delta_w_last)
        bumped = torch.where(dxv == 0, start_val, dxv * inc_fact)
        new_dx = torch.where(only_dc, dxv, bumped)
        new_gave_up = new_dx > opts.max_hessian_perturbation
        with span("kkt.factorize"):
            K2, fac2, ok2 = factor(new_dx, new_dc)
        trials, dxv, dcv, K, fac, ok, gave_up = tree_where(
            active, (trials + 1, new_dx, new_dc, K2, fac2, ok2, new_gave_up),
            (trials, dxv, dcv, K, fac, ok, gave_up))
    return RetryResult(K=K, fac=fac, delta_x=dxv, delta_c=dcv, trials=trials,
                       ok=ok, gave_up=gave_up)


class FactorResult(NamedTuple):
    fac: LDLTResult
    K: Any
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate, ev: Evals,
                  W, mu, delta_w_last, delta_cd_override=None) -> FactorResult:
    """Assemble + factorize the augmented system with the inertia-correction
    retry loop (PDPerturbationHandler schedule, ``step.py:171-245``).
    ``delta_cd_override`` (B,) replaces the mu-based Jacobian regularization
    (the cg-penalty method's CGPerturbationHandler value)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    sig = sigmas(nlp, it)
    expected_pos = n + mi
    expected_neg = me + mi
    delta_cd = (delta_cd_override if delta_cd_override is not None
                else opts.jacobian_regularization_value
                * mu ** opts.jacobian_regularization_exponent)

    def factor(delta_x, delta_c):
        with span("kkt.factorize"):
            with span("kkt.assemble"):
                K = assemble_aug_system(W, ev.J_c, ev.J_d, sig, delta_x, delta_x,
                                        delta_c, delta_c)
            fac = _factorize(K, opts)
            ok = ((fac.num_pos == expected_pos) & (fac.num_neg == expected_neg)
                  & ~fac.singular)
        return K, fac, ok

    zero = torch.zeros_like(mu)
    delta_x = zero
    delta_c = delta_cd if opts.perturb_always_cd else zero
    K, fac, ok = factor(delta_x, delta_c)
    trials = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    gave_up = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    while True:
        active = ~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)
        if not host_bool(active.any()):
            break
        was_singular = fac.singular
        # Singular with no Jacobian regularization yet -> delta_c alone first
        # (IpPDFullSpaceSolver.cpp:527-545 PerturbForSingularity).
        only_dc = was_singular & (delta_c == 0)
        new_delta_c = torch.where(was_singular | (delta_c > 0),
                                  torch.maximum(delta_c, delta_cd), delta_c)
        first_try = delta_x == 0
        start_val, inc_fact = perturbation_start(opts, delta_w_last)
        bumped = torch.where(first_try, start_val, delta_x * inc_fact)
        new_delta_x = torch.where(only_dc, delta_x, bumped)
        new_gave_up = new_delta_x > opts.max_hessian_perturbation
        K2, fac2, ok2 = factor(new_delta_x, new_delta_c)
        trials, delta_x, delta_c, K, fac, ok, gave_up = tree_where(
            active,
            (trials + 1, new_delta_x, new_delta_c, K2, fac2, ok2, new_gave_up),
            (trials, delta_x, delta_c, K, fac, ok, gave_up))

    failed = ~ok
    new_delta_w_last = torch.where(delta_x > 0, delta_x, delta_w_last)
    return FactorResult(fac=fac, K=K, delta_x=delta_x, delta_c=delta_c,
                        delta_w_last=new_delta_w_last, failed=failed,
                        num_trials=trials)


def _backend(nlp: CanonicalNLP) -> str:
    """"dense" without a structure, "banded" for a ``BandedInfo`` and "nd"
    for an ``NDInfo`` (``sparse.canonicalize_sparse``), "arrow" for a
    scenario problem's ``ArrowInfo``, "btd" for a chain's ``ChainInfo``."""
    from ..sparse import BandedInfo
    from ..parallel.scenario import ArrowInfo
    from ..linalg.nested_dissection import NDInfo
    if nlp.chain is None:
        return "dense"
    if isinstance(nlp.chain, ArrowInfo):
        return "arrow"
    if isinstance(nlp.chain, NDInfo):
        return "nd"
    return "banded" if isinstance(nlp.chain, BandedInfo) else "btd"


def compute_hessian(nlp: CanonicalNLP, it: Iterate):
    """The exact Lagrangian Hessian at the current iterate, shaped for the
    backend: dense (B, n, n), the stage blocks (Wd, Wo) of a chain, the
    scenario blocks (W00, W0s, Wss) of an arrow problem, or the entry values
    (B, nnz) of the banded or multifrontal backend's pattern."""
    with span("eval.hessian"):
        be = _backend(nlp)
        if be == "btd":
            from ..chained import stage_hessians
            return stage_hessians(nlp, it.x, it.y_c, it.y_d)
        if be == "arrow":
            from ..parallel.scenario import scenario_hessians
            return scenario_hessians(nlp, it.x, it.y_c, it.y_d)
        if be in ("banded", "nd"):
            from ..sparse import sparse_hessian_values
            return sparse_hessian_values(nlp, it)
        return nlp.eval_lag_hess(it.x, it.y_c, it.y_d)


def _custom_solver(opts: Options):
    """The object registered for ``linear_solver="custom"`` (GenKKTSolver
    Interface / GenAugSystemSolver, ``step.py:300-306, 345-351``).  The
    contract, batch-first like the rest of the port:

    - ``factorize(nlp, opts, it, ev, hess, mu, delta_w_last)``: every tensor
      has a leading lane axis B (``it.x`` (B, n), ``mu`` (B,), ``hess`` the
      backend-shaped Hessian); returns an object with the fields of
      ``FactorResult``: ``fac`` and ``K`` (anything its own ``solve`` reads),
      and (B,) tensors ``delta_x``, ``delta_c``, ``delta_w_last``, ``failed``
      (bool) and ``num_trials`` (int).  The inertia-correction retry is the
      object's to do.
    - ``solve(nlp, opts, fac, K, parts)``: ``parts`` = (r_x (B, n), r_s (B,
      mi), r_c (B, me), r_d (B, mi)); returns ((dx, ds, dy_c, dy_d),
      residual_ratio (B,)).
    """
    from ..options import CUSTOM_KKT_REGISTRY
    try:
        return CUSTOM_KKT_REGISTRY[opts.custom_kkt_token]
    except KeyError:
        raise ValueError("linear_solver='custom' needs a solver: pass "
                         "solve(..., custom_kkt_solver=obj)") from None


def factorize_any(nlp: CanonicalNLP, opts: Options, it: Iterate, ev: Evals,
                  hess, mu, delta_w_last, delta_cd_override=None):
    """Backend dispatch of the inertia-corrected factorization; ``hess`` is
    backend-shaped, or a ``LowRankW`` (limited-memory Hessian).
    ``delta_cd_override`` replaces the mu-based Jacobian regularization
    (the cg-penalty method's; the structured backends still floor it).
    ``linear_solver="custom"`` hands the whole factorization, retry loop
    included, to the registered object (``custom_kkt_solver``)."""
    if opts.linear_solver == "custom":
        return _custom_solver(opts).factorize(nlp, opts, it, ev, hess, mu,
                                              delta_w_last)
    from .quasi_newton import LowRankW
    be = _backend(nlp)
    if isinstance(hess, LowRankW):
        if be != "dense":
            from .lowrank_struct import lowrank_struct_factorize
            return lowrank_struct_factorize(nlp, opts, it, hess, mu, delta_w_last)
        from .lowrank_kkt import lowrank_factorize_kkt
        return lowrank_factorize_kkt(nlp, opts, it, ev, hess, mu, delta_w_last)
    if be == "arrow":
        from .arrow_kkt import arrow_factorize_kkt
        from ..parallel.scenario import scenario_jacobians
        return arrow_factorize_kkt(nlp, opts, it, scenario_jacobians(nlp, it.x),
                                   hess, mu, delta_w_last, delta_cd_override)
    if be == "btd":
        from .chained_kkt import chained_factorize_kkt
        from ..chained import stage_jacobians
        return chained_factorize_kkt(nlp, opts, it, stage_jacobians(nlp, it.x),
                                     hess, mu, delta_w_last, delta_cd_override)
    if be == "banded":
        from ..sparse import banded_factorize_kkt
        return banded_factorize_kkt(nlp, opts, it, hess, mu, delta_w_last,
                                    delta_cd_override)
    if be == "nd":
        from ..sparse import nd_factorize_kkt
        return nd_factorize_kkt(nlp, opts, it, hess, mu, delta_w_last,
                                delta_cd_override)
    return factorize_kkt(nlp, opts, it, ev, hess, mu, delta_w_last,
                         delta_cd_override)


def solve_any(nlp: CanonicalNLP, opts: Options, fac, K, parts):
    """Solve the factorized augmented system for the four RHS blocks;
    returns ((dx, ds, dy_c, dy_d), residual_ratio)."""
    with span("kkt.backsolve"):
        if opts.linear_solver == "custom":
            return _custom_solver(opts).solve(nlp, opts, fac, K, parts)
        from .lowrank_kkt import LowRankKKT, lowrank_solve_refined
        from .lowrank_struct import StructLowRankKKT, lowrank_struct_solve_refined
        if isinstance(fac, LowRankKKT):
            return lowrank_solve_refined(fac, parts, opts)
        if isinstance(fac, StructLowRankKKT):
            return lowrank_struct_solve_refined(nlp, opts, fac, parts)
        be = _backend(nlp)
        if be == "arrow":
            from .arrow_kkt import pack_rhs_arrow, unpack_sol_arrow, arrow_solve_refined
            (w0, ws), rr = arrow_solve_refined(K, fac, *pack_rhs_arrow(nlp, *parts),
                                               opts)
            return unpack_sol_arrow(nlp, w0, ws), rr
        if be in ("btd", "banded"):
            from .chained_kkt import chained_solve_refined
            if be == "btd":
                from .chained_kkt import pack_rhs as pack, unpack_sol as unpack
            else:
                from ..sparse import pack_rhs_banded as pack, unpack_sol_banded as unpack
            sol, rr = chained_solve_refined(K, fac, pack(nlp, *parts), opts)
            return unpack(nlp, sol), rr
        if be == "nd":
            from ..sparse import nd_solve_parts
            return nd_solve_parts(nlp, opts, fac, K, parts)
        rhs = torch.cat(parts, dim=-1)
        sol, rr = solve_with_refinement(K, fac, rhs, opts)
        return split_aug_solution(sol, nlp.n, nlp.mi, nlp.me), rr


def direction_from_parts(nlp: CanonicalNLP, it: Iterate, xsplit, mu, failed):
    dx, ds, dy_c, dy_d = xsplit
    dz_L, dz_U, dv_L, dv_U = recover_bound_mult_steps(nlp, it, dx, ds, mu)
    step = Iterate(x=dx, s=ds, y_c=dy_c, y_d=dy_d,
                   z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
    # Zero the step on failure so downstream arithmetic stays finite.
    return tree_where(failed, Iterate(*(torch.zeros_like(v) for v in step)), step)


def compute_search_direction(nlp: CanonicalNLP, opts: Options, it: Iterate,
                             ev: Evals, W, mu, delta_w_last,
                             ev_rhs: Evals = None) -> StepResult:
    """Assemble + factorize (with inertia correction) + solve + recover
    duals, for every lane.  ``ev_rhs``: the float64 evaluations the
    right-hand side is formed from under ``refinement_precision="double"``;
    the factorization uses ``ev``."""
    fr = factorize_any(nlp, opts, it, ev, W, mu, delta_w_last)
    parts = condensed_rhs_parts(nlp, it, ev if ev_rhs is None else ev_rhs, mu,
                                opts.kappa_d)
    xsplit, rr = solve_any(nlp, opts, fr.fac, fr.K, parts)
    failed = fr.failed
    if (opts.neg_curv_test_tol > 0 and _backend(nlp) == "dense"
            and isinstance(W, torch.Tensor)):
        # Inertia-free curvature test (IpPDFullSpaceSolver.cpp:592-637).
        dx = xsplit[0]
        dxdx = (dx * dx).sum(-1)
        curv = (dx * _matvec(W, dx)).sum(-1)
        if opts.neg_curv_test_reg:
            curv = curv + fr.delta_x * dxdx
        curv_ok = curv >= opts.neg_curv_test_tol * dxdx
        failed = failed & ~curv_ok
    step = direction_from_parts(nlp, it, xsplit, mu, failed)
    return StepResult(step=step, delta_x=fr.delta_x, delta_c=fr.delta_c,
                      delta_w_last=fr.delta_w_last, failed=failed,
                      num_trials=fr.num_trials, residual_ratio=rr,
                      fac=fr.fac, K=fr.K)


def soc_direction(nlp: CanonicalNLP, opts: Options, it: Iterate, ev: Evals,
                  fac, K, mu, c_soc, dms_soc, alpha_soc=None):
    """Second-order correction direction with the saved factorization
    (IpFilterLSAcceptor.cpp:531).  soc_method 1 also scales the x and s rows
    of the rhs by the running SOC step size (IpFilterLSAcceptor.cpp:572-603)."""
    r_x = (grad_barrier_x(nlp, it, ev.grad_f, mu, opts.kappa_d)
           + jac_t(nlp, ev, it.y_c, it.y_d))
    r_s = grad_barrier_s(nlp, it, mu, opts.kappa_d) - it.y_d
    if opts.soc_method == 1 and alpha_soc is not None:
        r_x = col(alpha_soc) * r_x
        r_s = col(alpha_soc) * r_s
    xsplit, _ = solve_any(nlp, opts, fac, K, (-r_x, -r_s, -c_soc, -dms_soc))
    dx, ds, dy_c, dy_d = xsplit
    dz_L, dz_U, dv_L, dv_U = recover_bound_mult_steps(nlp, it, dx, ds, mu)
    return Iterate(x=dx, s=ds, y_c=dy_c, y_d=dy_d,
                   z_L=dz_L, z_U=dz_U, v_L=dv_L, v_U=dv_U)
