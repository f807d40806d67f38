"""The interior-point driver: IpoptAlgorithm::Optimize, over a batch.

Port of ``ipopt_tpu/algorithm/solver.py`` (``src/Algorithm/IpIpoptAlg.cpp:
292-417``) with the exact or the limited-memory Hessian; the direct step
with the filter or the l1-penalty line search, the Chen-Goldfarb penalty
method (``cg_penalty.py``), the matrix-free MINRES step (``matrix_free.py``)
and the inexact algorithm (``inexact.py``); on the dense, the chained
(block-tridiagonal), the banded (general sparsity, ``linear_solver=
"banded-bcr"``), the multifrontal (nested dissection, ``linear_solver=
"multifrontal"``) and the scenario (block-arrow) KKT backends:

    InitializeIterates -> CheckConvergence -> loop {
        UpdateHessian; UpdateBarrierParameter; ComputeSearchDirection;
        ComputeAcceptableTrialPoint; AcceptTrialPoint; CheckConvergence }

The ``lax.while_loop`` of the reference becomes a Python loop; each step
advances every running lane of the batch at once (``solve`` is the case
B = 1), and a lane that has finished is not stepped again.  Both barrier
strategies (monotone, and adaptive with its oracles, Mehrotra's mode and the
correctors), warm starts, the time limits and the mixed-precision modes
(``factorization_dtype``, ``refinement_precision="double"`` over a float32
iterate) and the chain axis sharded over devices (``chain_shard=True``,
``parallel/chain_shard.py``) are ported: the port refuses no option value.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..types import (Iterate, SolverReturn, col, max_init, tree_put, tree_take,
                     tree_where)
from ..problem import NLP, CanonicalNLP, canonicalize
from ..chained import ChainedNLP, canonicalize_chained
from ..parallel.scenario import ScenarioNLP, canonicalize_scenario
from ..options import Options
from .. import kkt
from ..profiling import host_bool, solve_span, span
from ..kkt import Evals, evaluate, kkt_residuals, optimality_error, slacks
from ..linalg import ldlt as _ldlt_mod
from ..linalg.block_tridiag import bcr_factorize
from ..linalg.nested_dissection import nd_factorize
from .step import (StepResult, compute_search_direction, compute_hessian,
                   _backend, factorize_any, solve_any, direction_from_parts)
from .linesearch import (FilterState, filter_init, line_search, filter_reset,
                         filter_augment, _theta)
from .mu import (MuState, mu_init_state, monotone_mu_update_components,
                 AdaptiveMuState, adaptive_mu_init, adaptive_mu_update,
                 avg_complementarity, loqo_mu, probing_mu, quality_function_mu)
from .init import default_initialize, warm_start_initialize, least_squares_y
from .convergence import check_convergence
from .quasi_newton import LBFGSState, lbfgs_init
from .cg_penalty import CGState, cg_init
from .inexact import decomposition_initial_cn

_CONTINUE = int(SolverReturn.CONTINUE)


class UnsupportedOptionError(ValueError):
    """An option value selects a feature the port does not have yet."""

    def __init__(self, name, value):
        super().__init__(f"option {name}={value!r} is not supported by "
                         f"ipopt_torch yet (status INVALID_OPTION)")
        self.name, self.value = name, value
        self.status = SolverReturn.INVALID_OPTION


# (option, supported values) of the features this port has: every value of
# the reference's Options is supported, so nothing is listed.
_SUPPORTED = ()


def check_supported(opts: Options) -> None:
    """Raise ``UnsupportedOptionError`` for an option the port lacks."""
    for name, ok in _SUPPORTED:
        if getattr(opts, name) not in ok:
            raise UnsupportedOptionError(name, getattr(opts, name))


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: the card unless the caller asks for the
    CPU.  Without CUDA and without ``device="cpu"`` this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ipopt_torch runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to solve on "
                           "the CPU")
    return dev


class Counters(NamedTuple):
    """Per-lane evaluation/factorization counters (SolveStatistics)."""

    n_obj_evals: Any
    n_grad_evals: Any
    n_hess_evals: Any
    n_factorizations: Any
    n_kkt_solves: Any


def counters_init(batch: int, device) -> Counters:
    z = torch.zeros((batch,), dtype=torch.int64, device=device)
    return Counters(z, z, z, z, z)


class IPMState(NamedTuple):
    it: Iterate
    mu: Any
    tau: Any
    iter_count: Any
    delta_w_last: Any
    fs: FilterState
    theta_min: Any
    theta_max: Any
    status: Any           # (B,) SolverReturn; CONTINUE while running
    acceptable_count: Any
    last_alpha_pr: Any
    last_alpha_du: Any
    last_ls_count: Any
    last_delta_x: Any
    last_step_norm: Any
    restoration_count: Any
    tiny_step_count: Any
    counters: Counters
    # watchdog (IpBacktrackingLineSearch Start/StopWatchDog)
    wd_active: Any
    wd_trials: Any
    wd_shortened_count: Any
    wd_ref: Iterate
    wd_ref_theta: Any
    wd_ref_phi: Any
    soft_resto_count: Any
    ev: Evals             # evaluations at ``it``
    filter_rej_count: Any
    n_filter_resets: Any
    last_rej_filter: Any
    accepted_point: Iterate
    ams: AdaptiveMuState  # the adaptive mu strategy's per-lane carry
    eip_active: Any       # expect_infeasible_problem heuristic still armed
    lbfgs: LBFGSState     # per-lane history (zero width with exact Hessians)
    penalty_nu: Any       # the l1-penalty acceptor's parameter (and inexact nu)
    cg: CGState           # the Chen-Goldfarb penalty carry (one slot when off)
    tr_omega: Any         # the inexact normal step's trust-region factor
    nu_low: Any           # the inexact flexible penalty's lower parameter
    inx_cn: Any           # the inexact adaptive decomposition bit, or None


def robust_state_init(opts: Options, it: Iterate, outer: bool = False) -> dict:
    """The filter-reset heuristic's carry, the previous accepted point, the
    adaptive mu carry, the infeasibility heuristic's flag, a fresh L-BFGS
    history (a restoration starts its own, ``restoration.py:232-235``) and
    the penalty methods' carries.  Only the ``outer`` solve starts nu at
    ``nu_init`` under the inexact algorithm and carries the adaptive
    decomposition bit; a restoration starts nu at 1 and always decomposes
    (``restoration.py:242-246``)."""
    B, dev, dtype = it.x.shape[0], it.x.device, it.x.dtype
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    hist = (opts.limited_memory_max_history
            if opts.hessian_approximation == "limited-memory" else 0)
    inexact = outer and opts.inexact_algorithm

    def full(v):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return dict(
        penalty_nu=full(opts.nu_init if inexact else 1.0),
        cg=cg_init(opts, B, dtype, dev), tr_omega=full(opts.omega_init),
        nu_low=full(opts.nu_low_init),
        inx_cn=decomposition_initial_cn(opts, B, dev) if inexact else None,
        lbfgs=lbfgs_init(B, it.x.shape[1], hist, it.x.dtype, dev,
                         opts.limited_memory_init_val),
        filter_rej_count=z, n_filter_resets=z,
        last_rej_filter=torch.zeros((B,), dtype=torch.bool, device=dev),
        accepted_point=it, ams=adaptive_mu_init(B, it.x.dtype, dev),
        eip_active=torch.full((B,), bool(opts.expect_infeasible_problem),
                              dtype=torch.bool, device=dev))


class SolveResult(NamedTuple):
    """SolveStatistics equivalent; every field has a leading batch axis
    (``solve`` drops it)."""

    x: Any
    obj: Any
    status: Any
    iter_count: Any
    mu: Any
    g: Any
    y: Any
    z_L: Any
    z_U: Any
    dual_inf: Any
    primal_inf: Any
    compl_inf: Any
    E_scaled: Any
    iterate: Any
    counters: Any
    restoration_count: Any
    # batched factorizations made by this solve: dense LDL^T calls (one K1
    # launch each on CUDA) and BCR factorizations (one K2 launch per level)
    batched_factorizations: Any = None


def _compl_max_fn(nlp: CanonicalNLP, it: Iterate, s_c):
    """f(mu) = max_i |slack_i*mult_i - mu| / s_c per lane."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    nan = float("nan")

    def pr(has, v):
        return torch.where(has, v, torch.full_like(v, nan))

    prods = torch.cat([pr(nlp.has_xL, sl_xL * it.z_L), pr(nlp.has_xU, sl_xU * it.z_U),
                       pr(nlp.has_dL, sl_sL * it.v_L), pr(nlp.has_dU, sl_sU * it.v_U)], -1)
    isnan = torch.isnan(prods)
    has_any = (~isnan).any(-1)

    def f(mu):
        vals = torch.where(isnan, torch.zeros_like(prods), (prods - col(mu)).abs())
        return torch.where(has_any, max_init(vals, 0.0), torch.zeros_like(s_c)) / s_c

    return f


def _kappa_sigma_clip(nlp: CanonicalNLP, it: Iterate, mu, kappa_sigma):
    """AcceptTrialPoint bound-multiplier correction (IpIpoptAlg.cpp:260)."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    m = col(mu)

    def clip(z, sl, has):
        lo = m / (kappa_sigma * sl)
        hi = kappa_sigma * m / sl
        return torch.where(has, torch.minimum(torch.maximum(z, lo), hi),
                           torch.zeros_like(z))

    return it._replace(z_L=clip(it.z_L, sl_xL, nlp.has_xL),
                       z_U=clip(it.z_U, sl_xU, nlp.has_xU),
                       v_L=clip(it.v_L, sl_sL, nlp.has_dL),
                       v_U=clip(it.v_U, sl_sU, nlp.has_dU))


# alpha_pr step-type tags (IpOrigIterationOutput.cpp): see the reference.
_STEP_TAGS = "fFhHwWsRe"
_INFO_CODES = "qdM"


def _print_iter(info: dict, opts: Options):
    """The classic log line (IpOrigIterationOutput.cpp:81), one per lane."""
    from ..journalist import default_journalist, EJournalLevel, EJournalCategory
    import math
    rows = {k: v.tolist() for k, v in info.items()}
    for b in range(len(rows["iter"])):
        i = rows["iter"][b]
        if opts.print_frequency_iter > 1 and i % opts.print_frequency_iter != 0:
            continue
        dx = rows["delta_x"][b]
        rg_s = f"{math.log10(max(dx, 1e-99)):5.1f}" if dx > 0 else "  - "
        tag = rows["tag"][b]
        tag_s = _STEP_TAGS[tag] if 0 <= tag < len(_STEP_TAGS) else " "
        line = (f"{i:4d} {rows['f'][b]:16.7e} {rows['inf_pr'][b]:8.2e} "
                f"{rows['inf_du'][b]:8.2e} "
                f"{math.log10(max(rows['mu'][b], 1e-99)):5.1f} "
                f"{rows['dnorm'][b]:8.2e} {rg_s} {rows['alpha_du'][b]:8.2e}"
                f" {rows['alpha_pr'][b]:8.2e}{tag_s}{rows['ls'][b]:3d}")
        if opts.print_info_string:
            info_s = "".join(c for k, c in enumerate(_INFO_CODES)
                             if rows["bits"][b] & (1 << k))
            if info_s:
                line += f"  {info_s}"
        default_journalist().printf(EJournalLevel.J_ITERSUMMARY,
                                    EJournalCategory.J_MAIN, line + "\n")


def _print_header():
    from ..journalist import default_journalist, EJournalLevel, EJournalCategory
    default_journalist().printf(
        EJournalLevel.J_ITERSUMMARY, EJournalCategory.J_MAIN,
        "iter    objective        inf_pr   inf_du   lg(mu)  ||d||   lg(rg)"
        " alpha_du alpha_pr  ls\n")


def ipm_step(nlp: CanonicalNLP, opts: Options, st: IPMState) -> IPMState:
    """One IPM iteration without restoration fallback (used inside the
    restoration phase itself)."""
    return _ipm_step_impl(nlp, opts, st, enable_resto=False)


def ipm_step_with_resto(nlp: CanonicalNLP, opts: Options, st: IPMState) -> IPMState:
    """One outer IPM iteration with the restoration-phase fallback."""
    return _ipm_step_impl(nlp, opts, st, enable_resto=True)


def _ipm_step_impl(nlp: CanonicalNLP, opts: Options, st: IPMState,
                   enable_resto: bool) -> IPMState:
    """One outer IPM iteration of every lane (``solver.py:320-1268``)."""
    it = st.it
    ev = st.ev
    B, dtype, dev = it.x.shape[0], it.x.dtype, it.x.device
    # refinement_precision="double" (solver.py:324-353): ``ev`` was taken at
    # the float64 point, and feeds the residuals, the oracles and the KKT
    # right-hand side; the factorization, line search and restoration read
    # its view in the iterate's dtype
    hp = _high_precision(nlp, opts)
    ev_lo = _model_view(ev, dtype) if hp else ev
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)

    # --- UpdateBarrierParameter -------------------------------------------
    s_d, s_c = kkt.error_scaling(nlp, it, opts.s_max)
    res0 = kkt_residuals(nlp, it, ev, 0.0)
    dual_inf = torch.maximum(kkt.norm_inf(res0.grad_lag_x),
                             kkt.norm_inf(res0.grad_lag_s))
    primal_inf = torch.maximum(kkt.norm_inf(res0.c), kkt.norm_inf(res0.d_minus_s))
    compl_fn = _compl_max_fn(nlp, it, s_c)
    # --- UpdateHessian (exact or limited-memory, IpIpoptAlg.cpp:351) -------
    W = _update_hessian(nlp, opts, st)
    adaptive = opts.mu_strategy == "adaptive" or opts.mehrotra_algorithm
    _check_step_combination(opts, adaptive)
    extra_solves = 2 if adaptive else 0
    ams = st.ams
    step_aff = None
    cg_state, cg_aux, inaux = st.cg, None, None
    new_tr_omega, nu_low_state = st.tr_omega, st.nu_low
    if adaptive:
        # AdaptiveMuUpdate: one factorization serves the affine solve, the
        # centering solve and the final step, since rhs(mu) = rhs(0) +
        # mu * (rhs(1) - rhs(0)) and the bound-multiplier recovery is
        # affine in mu too (solver.py:427-491).
        fr = factorize_any(nlp, opts, it, ev_lo, W, st.mu, st.delta_w_last)
        parts0 = kkt.condensed_rhs_parts(nlp, it, ev, 0.0, opts.kappa_d)
        parts1 = kkt.condensed_rhs_parts(nlp, it, ev, 1.0, opts.kappa_d)
        dparts = tuple(b - a for a, b in zip(parts0, parts1))
        split_aff, rr_a = solve_any(nlp, opts, fr.fac, fr.K, parts0)
        split_cent, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
        step_aff = direction_from_parts(nlp, it, split_aff, 0.0, fr.failed)
        step_at1 = direction_from_parts(
            nlp, it, tuple(a + b for a, b in zip(split_aff, split_cent)), 1.0,
            fr.failed)
        step_cent = Iterate(*(b - a for a, b in zip(step_aff, step_at1)))
        # mehrotra_probing (IpAlgBuilder.cpp:355-363) forces the probing
        # oracle in Mehrotra's mode
        oracle = ("probing" if opts.mehrotra_algorithm and opts.mehrotra_probing
                  else opts.mu_oracle)
        oracle_args = (step_aff, step_cent, dual_inf / s_d, primal_inf, st.tau)
        mu_orc = _oracle_mu(nlp, opts, it, oracle, *oracle_args)
        fix_mu_val = _oracle_mu(nlp, opts, it, opts.fixed_mu_oracle, *oracle_args)
        theta_curr = ev.c.abs().sum(-1) + (ev.d - it.s).abs().sum(-1)
        avg_compl_val, _ = avg_complementarity(nlp, it)
        dual1_avg = ((res0.grad_lag_x.abs().sum(-1) + res0.grad_lag_s.abs().sum(-1))
                     / max(nlp.n + nlp.mi, 1)).to(dtype)
        primal1_avg = ((res0.c.abs().sum(-1) + res0.d_minus_s.abs().sum(-1))
                       / max(nlp.me + nlp.mi, 1)).to(dtype)
        ams, ms = adaptive_mu_update(
            opts, st.ams, MuState(st.mu, st.tau), mu_orc, dual_inf / s_d,
            primal_inf, compl_fn, theta_curr, ev.f, avg_compl_val, dual1_avg,
            primal1_avg, fix_mu_val)
        mu, tau = ms.mu, ms.tau
        step = Iterate(*(a + col(mu) * c for a, c in zip(step_aff, step_cent)))
        sr = StepResult(step=step, delta_x=fr.delta_x, delta_c=fr.delta_c,
                        delta_w_last=fr.delta_w_last, failed=fr.failed,
                        num_trials=fr.num_trials, residual_ratio=rr_a,
                        fac=fr.fac, K=fr.K)
    else:
        # Monotone Fiacco-McCormick (IpMonotoneMuUpdate.cpp); without
        # mu_allow_fast_monotone_decrease one level per update except the
        # first (IpMonotoneMuUpdate.cpp:170-182)
        rounds = 30
        if not opts.mu_allow_fast_monotone_decrease:
            rounds = torch.where(st.iter_count == 0, 30, 1)
        ms = monotone_mu_update_components(opts, MuState(st.mu, st.tau),
                                           dual_inf / s_d, primal_inf, compl_fn,
                                           max_rounds=rounds)
        mu, tau = ms.mu, ms.tau
        if opts.inexact_algorithm:
            from .inexact import inexact_search_direction
            sr, new_tr_omega, inaux = inexact_search_direction(
                nlp, opts, it, ev_lo, mu, st.delta_w_last, st.tr_omega, st.penalty_nu,
                compute_normal=st.inx_cn, last_ls_count=st.last_ls_count)
        elif opts.linear_solver == "minres":
            from .matrix_free import mf_search_direction
            sr = mf_search_direction(nlp, opts, it, ev_lo, mu, st.delta_w_last)
        elif opts.line_search_method == "cg-penalty":
            from .cg_penalty import cg_search_direction
            sr, cg_state, cg_aux = cg_search_direction(nlp, opts, it, ev_lo, W, mu,
                                                       st.delta_w_last, st.cg)
        else:
            sr = compute_search_direction(nlp, opts, it, ev_lo, W, mu, st.delta_w_last,
                                          ev_rhs=ev)

    # --- Tiny-step detection (BacktrackingLineSearch tiny_step_tol) -------
    eps = torch.finfo(dtype).eps
    tiny_tol = opts.tiny_step_tol if opts.tiny_step_tol > 0 else 10.0 * eps
    step_scale = max_init(sr.step.x.abs() / (1.0 + it.x.abs()), 0.0)
    if nlp.mi:
        step_scale = torch.maximum(
            step_scale, max_init(sr.step.s.abs() / (1.0 + it.s.abs()), 0.0))
    near_feasible = primal_inf <= 10.0 * max(opts.constr_viol_tol, opts.tol)
    is_tiny = (step_scale <= tiny_tol) & near_feasible & ~sr.failed
    dy_norm = torch.maximum(max_init(sr.step.y_c.abs(), 0.0),
                            max_init(sr.step.y_d.abs(), 0.0))
    tiny_count = torch.where(is_tiny & (dy_norm < opts.tiny_step_y_tol),
                             st.tiny_step_count + 1,
                             torch.zeros_like(st.tiny_step_count))

    # --- Higher-order corrector (FilterLSAcceptor::TryCorrector,
    #     IpFilterLSAcceptor.cpp:655-880): the corrected full step, which the
    #     line search tries first
    corr = None
    own_search = opts.inexact_algorithm or opts.line_search_method == "cg-penalty"
    if (opts.corrector_type != "none" and not own_search
            and opts.linear_solver != "minres"):
        corr = _corrector(nlp, opts, it, ev, sr, mu, tau, step_aff,
                          ams.free_mode if adaptive else false)
        extra_solves += 1

    # --- Filter-reset heuristic (IpFilterLSAcceptor.cpp:402-420) ----------
    fs_in = st.fs
    frc_next = st.filter_rej_count
    nfr_next = st.n_filter_resets
    filter_ls = not (own_search or opts.line_search_method == "penalty")
    if opts.max_filter_resets > 0 and filter_ls:
        frc_next = torch.where(st.last_rej_filter, st.filter_rej_count + 1,
                               torch.zeros_like(st.filter_rej_count))
        do_reset = ((frc_next >= opts.filter_reset_trigger)
                    & (st.n_filter_resets < opts.max_filter_resets)
                    & ~st.wd_active)
        fs_in = tree_where(do_reset, filter_reset(st.fs), st.fs)
        frc_next = torch.where(do_reset, torch.zeros_like(frc_next), frc_next)
        nfr_next = st.n_filter_resets + do_reset.long()

    # --- Line search ------------------------------------------------------
    inx_cn_next = st.inx_cn
    with span("line_search"):
        if opts.inexact_algorithm:
            from .inexact import inexact_line_search, decomposition_next_cn
            ls, _, nu_low_state = inexact_line_search(nlp, opts, it, ev_lo, sr, mu, tau,
                                                      st.penalty_nu, st.nu_low, inaux)
            ls = ls._replace(filter=st.fs)  # the penalty search keeps no filter
            # the adaptive decomposition bit from the accepted step size, and
            # forced on when an undecomposed round gave no usable step
            # (IpInexactSearchDirCalc.cpp:196-200)
            inx_cn_next = decomposition_next_cn(opts, st.inx_cn, ls.alpha_primal)
            if inx_cn_next is not None:
                inx_cn_next = inx_cn_next | sr.failed
        elif opts.line_search_method == "cg-penalty":
            from .cg_penalty import cg_line_search
            ls, cg_state = cg_line_search(nlp, opts, it, ev_lo, sr, mu, tau, cg_state, cg_aux)
            ls = ls._replace(filter=st.fs,  # the CG method keeps no filter
                             accepted=ls.accepted & ~_multipliers_diverged(
                                 nlp, opts, it, ev_lo, ls, dual_inf))
        else:
            ls = line_search(nlp, opts, it, ev_lo, sr, mu, tau, fs_in, st.theta_min,
                             st.theta_max, corr=corr, penalty_nu=st.penalty_nu)
    lrf_next = ls.last_rej_filter

    # --- PerformDualStep: y step size per alpha_for_y (cg-penalty keeps its
    #     acceptor's rule)
    if (opts.alpha_for_y not in ("primal", "acceptor")
            and opts.line_search_method != "cg-penalty"):
        from .linesearch import compute_alpha_for_y
        a_y = col(compute_alpha_for_y(nlp, opts, it, sr.step, ls.trial,
                                      ls.alpha_primal, ls.alpha_dual))
        ls = ls._replace(trial=ls.trial._replace(
            y_c=it.y_c + a_y * sr.step.y_c, y_d=it.y_d + a_y * sr.step.y_d))

    # --- Watchdog: the full fraction-to-boundary trial is the line search's
    #     first trial, reused as is; the inexact and cg-penalty searches keep
    #     their own acceptors, so that trial is evaluated here, for the lanes
    #     that need it
    in_wd = st.wd_active & ~sr.failed
    ls_failed = ~(ls.accepted | is_tiny) & ~sr.failed
    extra_eval = false
    if not own_search:
        wd_trial = ls.first_trial
        wd_f, wd_c, wd_d = ls.first_f, ls.first_c, ls.first_d
        wd_theta, wd_phi = ls.first_theta, ls.first_phi
    else:
        a_pr, a_du = kkt.fraction_to_boundary(nlp, it, sr.step, tau)
        from .linesearch import _trial_point
        wd_trial = _trial_point(it, sr.step, a_pr, a_du)
        extra_eval = in_wd | ls_failed
        wd_f, wd_c, wd_d = inf, torch.full_like(ev_lo.c, float("inf")), \
            torch.full_like(ev_lo.d, float("inf"))
        wd_theta, wd_phi = inf, inf
        if host_bool(extra_eval.any()):
            f_w = nlp.eval_f(wd_trial.x)
            c_w, d_w = nlp.eval_cd(wd_trial.x)
            th_w = _theta(c_w, d_w, wd_trial.s, opts.constraint_violation_norm_type)
            ph_w = kkt.barrier_obj(nlp, wd_trial, f_w, mu, opts.kappa_d)
            wd_f, wd_c, wd_d, wd_theta, wd_phi = tree_where(
                extra_eval, (f_w, c_w, d_w, th_w, ph_w),
                (wd_f, wd_c, wd_d, wd_theta, wd_phi))
    wd_ok = ((wd_theta <= (1.0 - opts.gamma_theta) * st.wd_ref_theta)
             | (wd_phi <= st.wd_ref_phi - opts.gamma_phi * st.wd_ref_theta))
    wd_exhausted = st.wd_trials + 1 >= opts.watchdog_trial_iter_max

    # --- AcceptTrialPoint -------------------------------------------------
    accepted = (ls.accepted & ~sr.failed) | is_tiny
    wd_restore = in_wd & ~wd_ok & wd_exhausted
    accepted = accepted | in_wd

    # --- Soft restoration: accept the full step if it reduces the
    #     primal-dual error enough (the gradient at the trial point is
    #     evaluated only when some lane's line search failed).
    curr_pd = torch.maximum(dual_inf, primal_inf)
    wd_pd = inf
    if host_bool(ls_failed.any()):
        res_wd = kkt_residuals(nlp, wd_trial, kkt.gradient_evals(
            nlp, wd_trial.x, wd_f, wd_c, wd_d), mu)
        pd = torch.maximum(
            torch.maximum(kkt.norm_inf(res_wd.grad_lag_x),
                          kkt.norm_inf(res_wd.grad_lag_s)),
            torch.maximum(kkt.norm_inf(res_wd.c), kkt.norm_inf(res_wd.d_minus_s)))
        wd_pd = torch.where(ls_failed, pd, inf)
    soft_ok = (~accepted & ~sr.failed
               & (wd_pd <= opts.soft_resto_pderror_reduction_factor * curr_pd)
               & (st.soft_resto_count < opts.max_soft_resto_iters))
    soft_count = torch.where(soft_ok, st.soft_resto_count + 1,
                             torch.zeros_like(st.soft_resto_count))
    accepted = accepted | soft_ok

    # --- Forced restoration entries (IpBacktrackingLineSearch.cpp:332-345,
    #     788-793): start_with_resto skips the first line search;
    #     expect_infeasible_problem jumps to restoration when the multipliers
    #     pass ytol, or after 5 shortened steps unless the first trial was
    #     just accepted in full.
    force_resto = false
    if enable_resto and opts.start_with_resto:
        force_resto = force_resto | (st.iter_count == 0)
    if enable_resto and opts.expect_infeasible_problem:
        y_amax = torch.maximum(kkt.norm_inf(it.y_c), kkt.norm_inf(it.y_d))
        full_first = ls.accepted & (ls.n_backtracks <= 1)
        force_resto = (force_resto
                       | (st.eip_active & (y_amax > opts.expect_infeasible_problem_ytol))
                       | (st.eip_active & (st.wd_shortened_count >= 5) & ~full_first))
    accepted = accepted & ~force_resto

    new_it = tree_where(accepted, ls.trial, it)
    new_it = tree_where((in_wd | soft_ok) & ~force_resto, wd_trial, new_it)
    new_it = tree_where(wd_restore, st.wd_ref, new_it)
    # slack_move (IpIpoptCalculatedQuantities.cpp:164-171,520-528)
    if opts.slack_move > 0.0:
        move_L = opts.slack_move * torch.clamp(nlp.d_L.abs(), min=1.0)
        move_U = opts.slack_move * torch.clamp(nlp.d_U.abs(), min=1.0)
        s_fix = new_it.s
        s_fix = torch.where(nlp.has_dL & (s_fix - nlp.d_L <= 0.0),
                            nlp.d_L + move_L, s_fix)
        s_fix = torch.where(nlp.has_dU & (nlp.d_U - s_fix <= 0.0),
                            nlp.d_U - move_U, s_fix)
        new_it = new_it._replace(s=s_fix)
    new_it = _kappa_sigma_clip(nlp, new_it, mu, opts.kappa_sigma)

    # --- Fallback: restoration phase (IpIpoptAlg.cpp:384) -----------------
    need_resto = ~accepted
    status = st.status
    extra_iters = torch.zeros_like(st.iter_count)
    resto_obj_evals = None
    fs_after = ls.filter
    resto_count = st.restoration_count
    if nlp.struct.me + nlp.struct.mi == 0 or not opts.resto_phase:
        enable_resto = False
    backend = _backend(nlp)
    if backend in ("banded", "nd") and nlp.chain.resto is None:
        # a banded or multifrontal problem without the restoration's
        # analysis (the restoration NLP itself) cannot nest another one
        enable_resto = False
    if enable_resto:
        resto_opts = opts.resto_options()
        # entering restoration augments the outer filter with the current
        # point (A-9)
        fs_entry = filter_augment(fs_in, ls.theta_curr, ls.phi_curr,
                                  opts.gamma_theta, opts.gamma_phi)
        fs_after = tree_where(need_resto, fs_entry, ls.filter)
        if host_bool(need_resto.any()):
            with span("restoration"):
                idx = need_resto.nonzero().squeeze(-1)
                sub = nlp.take(idx)
                args = (opts, resto_opts, tree_take(it, idx), tree_take(ev_lo, idx),
                        mu[idx], tree_take(fs_entry, idx), ls.theta_curr[idx],
                        ls.phi_curr[idx], ipm_step)
                if backend == "btd":
                    from .chained_resto import perform_restoration_chained
                    rr = perform_restoration_chained(sub, *args)
                elif backend == "arrow":
                    from .arrow_resto import perform_restoration_arrow
                    rr = perform_restoration_arrow(sub, *args)
                elif backend in ("banded", "nd"):
                    from .banded_resto import perform_restoration_banded
                    rr = perform_restoration_banded(sub, *args)
                else:
                    from .restoration import build_resto_nlp, perform_restoration
                    rr = perform_restoration(sub, build_resto_nlp(sub, opts), *args)
                new_it = tree_put(new_it, idx, rr.it)
                st_sub = status[idx]
                st_sub = torch.where(rr.locally_infeasible,
                                     int(SolverReturn.LOCAL_INFEASIBILITY), st_sub)
                st_sub = torch.where(rr.failed, int(SolverReturn.RESTORATION_FAILURE),
                                     st_sub)
                # resto_failure_feasibility_threshold (IpIpoptAlg.cpp:112-118)
                rf_thresh = opts.resto_failure_feasibility_threshold
                if rf_thresh <= 0.0:
                    rf_thresh = 1e2 * opts.tol
                c_b, d_b = sub.eval_cd(rr.it.x)
                theta_back = torch.maximum(max_init(c_b.abs(), 0.0),
                                           max_init((d_b - rr.it.s).abs(), 0.0))
                st_sub = torch.where(rr.success & (theta_back > rf_thresh)
                                     & (theta_back > 0.9 * ls.theta_curr[idx]),
                                     int(SolverReturn.RESTORATION_FAILURE), st_sub)
                status = status.index_copy(0, idx, st_sub)
                extra_iters = extra_iters.index_copy(0, idx, rr.resto_iters)
        if opts.evaluate_orig_obj_at_resto_trial:
            resto_obj_evals = extra_iters
        if opts.line_search_method == "cg-penalty":
            # the penalties re-initialized on the return from a restoration
            # (IpCGSearchDirCalc.cpp:208-217)
            pen_new = torch.clamp(opts.pen_init_fac
                                  * 0.1 ** st.restoration_count.to(dtype), 1e1, 1e6)
            cg_state = cg_state._replace(
                penalty=torch.where(need_resto, pen_new, cg_state.penalty),
                kkt_penalty=torch.where(need_resto, pen_new, cg_state.kkt_penalty))
        resto_count = resto_count + need_resto.long()
    else:
        status = torch.where(need_resto & sr.failed,
                             int(SolverReturn.ERROR_IN_STEP_COMPUTATION), status)
        status = torch.where(need_resto & ~sr.failed,
                             int(SolverReturn.RESTORATION_FAILURE), status)

    step_norm = torch.maximum(max_init(sr.step.x.abs(), 0.0),
                              max_init(sr.step.s.abs(), 0.0))

    if opts.print_level >= 4 or (opts.output_file and opts.file_print_level >= 4):
        inf_pr_show = ls.theta_curr if opts.inf_pr_output == "internal" else primal_inf
        tag = torch.where(ls.ftype, torch.where(ls.used_soc, 1, 0),
                          torch.where(ls.used_soc, 3, 2))
        tag = torch.where(in_wd, 5, tag)
        tag = torch.where(wd_restore, 4, tag)
        tag = torch.where(soft_ok, 6, tag)
        tag = torch.where(~accepted, 8, tag)
        tag = torch.where(need_resto, 7, tag)
        bits = ((sr.residual_ratio > opts.residual_ratio_max).long()
                | ((sr.num_trials > 1).long() << 1)
                | (st.wd_active.long() << 2))
        _print_iter(dict(iter=st.iter_count, f=ev.f, inf_pr=inf_pr_show,
                         inf_du=dual_inf, mu=mu, dnorm=step_norm,
                         delta_x=sr.delta_x, alpha_du=ls.alpha_dual,
                         alpha_pr=ls.alpha_primal, ls=ls.n_backtracks,
                         tag=tag, bits=bits), opts)

    # --- intermediate_callback (TNLP::intermediate_callback, IpTNLP.hpp:665)
    from ..options import CALLBACK_REGISTRY
    user_cb = CALLBACK_REGISTRY.get(opts.callback_token)
    if user_cb is not None:
        vals = [v.tolist() for v in (st.iter_count, ev.f, primal_inf, dual_inf,
                                     mu, ls.alpha_primal, ls.alpha_dual,
                                     ls.n_backtracks)]
        extra = [{}] * B
        if opts.callback_curr_iterate:
            # get_curr_iterate / get_curr_violations (IpTNLP.hpp:665-793)
            blocks = dict(x=_x_user(nlp, it.x), s=it.s, y_c=it.y_c, y_d=it.y_d,
                          z_L=it.z_L, z_U=it.z_U)
            viol = dict(grad_lag_x=res0.grad_lag_x, compl_x_L=res0.compl_x_L,
                        compl_x_U=res0.compl_x_U, compl_s_L=res0.compl_s_L,
                        compl_s_U=res0.compl_s_U, c_violation=ev.c,
                        d_minus_s=ev.d - it.s)
            blocks, viol = ({k: v.detach().cpu().numpy() for k, v in d.items()}
                            for d in (blocks, viol))
            extra = [dict(curr_iterate={k: v[b] for k, v in blocks.items()},
                          curr_violations={k: v[b] for k, v in viol.items()})
                     for b in range(B)]
        keep = []
        for b in range(B):
            i, f_, pr, du, m_, apr, adu, lsn = (v[b] for v in vals)
            r = user_cb(iter_count=int(i), obj_value=float(f_), inf_pr=float(pr),
                        inf_du=float(du), mu=float(m_), alpha_pr=float(apr),
                        alpha_du=float(adu), ls_trials=int(lsn), **extra[b])
            keep.append(r is not False)
        stop = ~torch.tensor(keep, dtype=torch.bool, device=dev)
        status = torch.where((status == _CONTINUE) & stop,
                             int(SolverReturn.USER_REQUESTED_STOP), status)

    # --- adaptive_mu_restore_previous_iterate (IpAdaptiveMuUpdate.cpp:
    #     362-370): a lane that just fell back to monotone mode restarts from
    #     its previous accepted point
    if opts.adaptive_mu_restore_previous_iterate and adaptive:
        new_it = tree_where(ams.just_switched, st.accepted_point, new_it)

    # --- CheckConvergence at the NEW point --------------------------------
    ev_new = evaluate(nlp, new_it.x.to(torch.float64) if hp else new_it.x)

    # --- Watchdog bookkeeping ---------------------------------------------
    shortened = accepted & (ls.n_backtracks > 1)
    new_short_count = torch.where(in_wd | ~shortened,
                                  torch.zeros_like(st.wd_shortened_count),
                                  st.wd_shortened_count + 1)
    activate = (~in_wd & (new_short_count >= opts.watchdog_shortened_iter_trigger)
                if opts.watchdog_shortened_iter_trigger > 0 else false)
    if opts.expect_infeasible_problem:
        # no watchdog while the infeasibility heuristic is armed
        # (IpBacktrackingLineSearch.cpp:367)
        activate = activate & ~st.eip_active
    wd_done = wd_ok | wd_restore
    wd_active_next = torch.where(in_wd, ~wd_done, activate)
    wd_trials_next = torch.where(in_wd & ~wd_done, st.wd_trials + 1,
                                 torch.zeros_like(st.wd_trials))
    norm_type = opts.constraint_violation_norm_type
    theta_new = _theta(ev_new.c, ev_new.d, new_it.s, norm_type).to(dtype)
    phi_new = kkt.barrier_obj(nlp, new_it, ev_new.f, mu, opts.kappa_d).to(dtype)
    wd_ref_next = tree_where(activate, new_it, st.wd_ref)
    wd_ref_theta_next = torch.where(activate, theta_new, st.wd_ref_theta)
    wd_ref_phi_next = torch.where(activate, phi_new, st.wd_ref_phi)
    new_short_count = torch.where(activate, torch.zeros_like(new_short_count),
                                  new_short_count)

    # --- recalc_y (IpIpoptAlg.cpp:774-811): once nearly feasible, least-
    #     squares equality multipliers at the accepted point (dense backend)
    if (opts.recalc_y and nlp.chain is None and nlp.struct.me + nlp.struct.mi > 0
            and not opts.inexact_algorithm):
        theta_acc = _theta(ev_new.c, ev_new.d, new_it.s, norm_type)
        redo = theta_acc < opts.recalc_y_feas_tol
        if host_bool(redo.any()):
            y_c2, y_d2 = least_squares_y(nlp, new_it.x, new_it.s,
                                         ev_new.grad_f.to(dtype), ev_new.J_c.to(dtype),
                                         ev_new.J_d.to(dtype), new_it.z_L,
                                         new_it.z_U, new_it.v_L, new_it.v_U,
                                         float("inf"))
            new_it = new_it._replace(
                y_c=tree_where(redo, y_c2, new_it.y_c),
                y_d=tree_where(redo, y_d2, new_it.y_d))

    # --- expect_infeasible_problem: disarm once the violation is below ctol
    #     or after a restoration (IpBacktrackingLineSearch.cpp:615-652)
    eip_next = st.eip_active
    if opts.expect_infeasible_problem:
        theta_eip = _theta(ev_new.c, ev_new.d, new_it.s, norm_type)
        eip_next = (eip_next & (theta_eip > opts.expect_infeasible_problem_ctol)
                    & ~need_resto)

    # --- the L-BFGS pair update (LimMemQuasiNewtonUpdater), kept on the
    #     accepted lanes only (solver.py:1150-1175)
    lbfgs = st.lbfgs
    if opts.hessian_approximation == "limited-memory":
        from .quasi_newton import lbfgs_update
        # the same multipliers on both gradients
        s_vec = new_it.x - it.x
        y_vec = ((ev_new.grad_f + kkt.jac_t(nlp, ev_new, new_it.y_c, new_it.y_d))
                 - (ev.grad_f + kkt.jac_t(nlp, ev, new_it.y_c, new_it.y_d))).to(dtype)
        nl_mask = _nonlinear_mask(nlp, opts)
        if nl_mask is not None:
            s_vec, y_vec = s_vec * nl_mask, y_vec * nl_mask
        lbfgs = tree_where(accepted, lbfgs_update(lbfgs, s_vec, y_vec, opts), lbfgs)

    res_new = kkt_residuals(nlp, new_it, ev_new, 0.0)
    E, d_inf, p_inf, c_inf = optimality_error(nlp, new_it, res_new, opts.s_max)
    obj_change_rel = (ev_new.f - ev.f).abs() / torch.clamp(ev_new.f.abs(), min=1.0)
    conv = check_convergence(opts, st.iter_count + 1, st.acceptable_count,
                             E, d_inf, p_inf, c_inf,
                             max_init(new_it.x.abs(), 0.0),
                             obj_change_rel=obj_change_rel)
    status = torch.where(status == _CONTINUE, conv.status, status)
    status = torch.where((status == _CONTINUE) & (tiny_count >= 2),
                         int(SolverReturn.STOP_AT_TINY_STEP), status)
    # INVALID_NUMBER_DETECTED at the accepted iterate (IpIpoptAlg.cpp:531-537)
    finite_ok = (torch.isfinite(ev_new.f) & torch.isfinite(new_it.x).all(-1)
                 & torch.isfinite(ev_new.c).all(-1) & torch.isfinite(ev_new.d).all(-1)
                 & torch.isfinite(ev_new.grad_f).all(-1))
    if opts.check_derivatives_for_naninf:
        finite_ok = finite_ok & _derivatives_finite(nlp, new_it)
    status = torch.where((status == _CONTINUE) & ~finite_ok,
                         int(SolverReturn.INVALID_NUMBER_DETECTED), status)

    c = st.counters
    n_obj = c.n_obj_evals + 1 + ls.n_evals + extra_eval.long()
    if resto_obj_evals is not None:
        n_obj = n_obj + resto_obj_evals
    counters = Counters(
        n_obj_evals=n_obj,
        n_grad_evals=c.n_grad_evals + 1 + ls_failed.long(),
        n_hess_evals=c.n_hess_evals + int(opts.hessian_approximation == "exact"
                                          and not _matrix_free(opts)),
        n_factorizations=c.n_factorizations + sr.num_trials,
        n_kkt_solves=c.n_kkt_solves + 1 + ls.n_soc_rounds + extra_solves)
    return IPMState(
        it=new_it, mu=mu, tau=tau,
        iter_count=st.iter_count + 1 + extra_iters,
        delta_w_last=sr.delta_w_last, fs=fs_after,
        theta_min=st.theta_min, theta_max=st.theta_max, status=status,
        acceptable_count=conv.acceptable_count,
        last_alpha_pr=ls.alpha_primal, last_alpha_du=ls.alpha_dual,
        last_ls_count=ls.n_backtracks, last_delta_x=sr.delta_x,
        last_step_norm=step_norm, restoration_count=resto_count,
        tiny_step_count=tiny_count, counters=counters,
        wd_active=wd_active_next, wd_trials=wd_trials_next,
        wd_shortened_count=new_short_count, wd_ref=wd_ref_next,
        wd_ref_theta=wd_ref_theta_next, wd_ref_phi=wd_ref_phi_next,
        soft_resto_count=soft_count, ev=ev_new, filter_rej_count=frc_next,
        n_filter_resets=nfr_next, last_rej_filter=lrf_next, accepted_point=st.it,
        ams=ams, eip_active=eip_next, lbfgs=lbfgs, penalty_nu=ls.penalty_nu,
        cg=cg_state, tr_omega=new_tr_omega, nu_low=nu_low_state, inx_cn=inx_cn_next)


def _high_precision(nlp: CanonicalNLP, opts: Options) -> bool:
    """refinement_precision="double" on the dense, chained and banded
    backends with a direct step (``solver.py:324-337``, ``:1285-1290``): the
    evaluation at each accepted point runs in float64, so the convergence
    error and the KKT right-hand side resolve below the float32 iterate's
    rounding; the factorization and line search stay in its dtype."""
    return (opts.refinement_precision == "double"
            and _backend(nlp) in ("dense", "btd", "banded")
            and not opts.inexact_algorithm
            and opts.line_search_method != "cg-penalty"
            and opts.linear_solver not in ("minres", "custom"))


def _model_view(ev: Evals, dtype) -> Evals:
    """The evaluations in the iterate's dtype; a structured backend's
    transpose products stay at the float64 point (``kkt.jac_t`` casts
    them to this view's dtype)."""
    def to(v):
        return None if v is None else v.to(dtype)
    return Evals(f=to(ev.f), grad_f=to(ev.grad_f), c=to(ev.c), d=to(ev.d),
                 J_c=to(ev.J_c), J_d=to(ev.J_d), x=ev.x)


def _matrix_free(opts: Options) -> bool:
    """The step needs no Hessian matrix: MINRES or the inexact algorithm
    apply it by Hessian-vector products."""
    return opts.linear_solver == "minres" or opts.inexact_algorithm


def _check_step_combination(opts: Options, adaptive: bool) -> None:
    """The combinations of step paths the reference refuses, with its
    errors (``solver.py:404-420``)."""
    if opts.linear_solver == "minres" and adaptive:
        raise NotImplementedError("adaptive mu with linear_solver='minres' "
                                  "is not supported yet")
    if opts.line_search_method == "cg-penalty" and (
            adaptive or opts.linear_solver == "minres"):
        # the reference asserts !FreeMuMode (IpCGSearchDirCalc.cpp:144)
        raise NotImplementedError("cg-penalty requires monotone mu and a "
                                  "direct linear solver")
    if opts.inexact_algorithm and adaptive:
        # IpInexactAlgBuilder.cpp builds it with monotone mu only
        raise NotImplementedError("inexact_algorithm requires monotone mu")


def _multipliers_diverged(nlp: CanonicalNLP, opts: Options, it: Iterate, ev,
                          ls, dual_inf):
    """MultipliersDiverged (IpCGPenaltyLSAcceptor.cpp:678-708): at a still
    infeasible point with exploding multipliers and a collapsing primal
    step the trial is rejected, so that the restoration runs."""
    curr_inf2 = torch.sqrt((ev.c ** 2).sum(-1) + ((ev.d - it.s) ** 2).sum(-1))
    trial_inf2 = torch.sqrt((ls.trial_c ** 2).sum(-1)
                            + ((ls.trial_d - ls.trial.s) ** 2).sum(-1))
    y_amax = torch.maximum(kkt.norm_inf(it.y_c), kkt.norm_inf(it.y_d))
    n_bnd_mults = (nlp.has_xL.sum(-1) + nlp.has_xU.sum(-1) + nlp.has_dL.sum(-1)
                   + nlp.has_dU.sum(-1) + nlp.mi)
    a_pr = ls.alpha_primal
    big_y = (y_amax > opts.mult_diverg_y_tol) & ((n_bnd_mults == 0) | (a_pr < 1e-2))
    tiny_step_y = (a_pr < 1e-4) & (y_amax > 1e4)
    return ((curr_inf2 > opts.mult_diverg_feasibility_tol)
            & (trial_inf2 > opts.mult_diverg_feasibility_tol)
            & (dual_inf > 1e4) & (big_y | tiny_step_y))


def _nonlinear_mask(nlp: CanonicalNLP, opts: Options):
    """With num_linear_variables and hessian_approximation_space=
    "nonlinear-variables" (IpTNLPAdapter.cpp:2298-2315,
    IpOrigIpoptNLP.cpp:124-130), the mask (n,) of the nonlinear variables
    (the first num_linear_variables are linear); else None."""
    if not (opts.num_linear_variables > 0
            and opts.hessian_approximation_space == "nonlinear-variables"):
        return None
    s = nlp.struct
    full = np.arange(s.n_full) >= opts.num_linear_variables
    mask = full[s.free_idx] if s.n != s.n_full else full
    return torch.as_tensor(mask, device=nlp.device).to(nlp.dtype)


def _update_hessian(nlp: CanonicalNLP, opts: Options, st: IPMState):
    """The exact Hessian of the backend, or the limited-memory one of every
    lane (``solver.py:365-401``): its compact form for the SMW solvers (any
    structured backend, or ``limited_memory_aug_solver="sherman-morrison"``),
    else the dense matrix (``"extended"``)."""
    if opts.hessian_approximation != "limited-memory":
        if _matrix_free(opts):
            return None  # the Hessian appears only in products
        return compute_hessian(nlp, st.it)
    from .quasi_newton import lbfgs_compact, lbfgs_dense_W
    nl_mask = _nonlinear_mask(nlp, opts)
    if nlp.chain is not None or opts.limited_memory_aug_solver == "sherman-morrison":
        if nl_mask is not None:
            raise NotImplementedError(
                "num_linear_variables with the nonlinear-variables "
                "approximation space needs the dense low-rank path — "
                "set limited_memory_aug_solver='extended'")
        return lbfgs_compact(st.lbfgs, opts)
    return lbfgs_dense_W(st.lbfgs, opts, nl_mask=nl_mask)


def _oracle_mu(nlp: CanonicalNLP, opts: Options, it: Iterate, name: str,
               step_aff, step_cent, dual_s, primal_inf, tau):
    """The mu of the oracle ``name`` per lane; None for "average_compl"
    (the fixed-mode fallback of NewFixedMu)."""
    if name == "loqo":
        return loqo_mu(nlp, it, opts)
    if name == "probing":
        return probing_mu(nlp, it, opts, step_aff)
    if name == "quality-function":
        return quality_function_mu(nlp, it, opts, step_aff, step_cent, dual_s,
                                   primal_inf, tau)
    return None


def _corrector(nlp: CanonicalNLP, opts: Options, it: Iterate, ev, sr, mu, tau,
               step_aff, free_mode) -> dict:
    """The corrected first trial of FilterLSAcceptor::TryCorrector
    (IpFilterLSAcceptor.cpp:655-880, ``solver.py:548-641``): one more solve
    with the saved factorization, on a pure complementarity right-hand side
    reduced onto the condensed system.  ``step_aff`` is the affine step of
    the adaptive strategy, or None."""
    active = ~sr.failed
    if opts.skip_corr_in_monotone_mode:
        active = active & free_mode  # only in free mu mode (:663)
    if opts.skip_corr_if_neg_curv:
        active = active & (sr.delta_x == 0.0)  # not after a perturbation (:662)
    active = active & (avg_complementarity(nlp, it)[1] > 0)
    d_aff = step_aff
    if d_aff is None and opts.corrector_type == "affine":
        parts_a = kkt.condensed_rhs_parts(nlp, it, ev, 0.0, opts.kappa_d)
        split_a, _ = solve_any(nlp, opts, sr.fac, sr.K, parts_a)
        d_aff = direction_from_parts(nlp, it, split_a, 0.0, sr.failed)
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    stp = sr.step
    m = col(mu)

    def w(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    if opts.corrector_type == "affine":
        # the classic MPC second-order term (:689-748)
        r_zL = w(nlp.has_xL, -d_aff.x * d_aff.z_L)
        r_zU = w(nlp.has_xU, d_aff.x * d_aff.z_U)
        r_vL = w(nlp.has_dL, -d_aff.s * d_aff.v_L)
        r_vU = w(nlp.has_dU, d_aff.s * d_aff.v_U)
    else:
        # "primal-dual": the complementarity residual at the predicted point,
        # targeting mu (:751-798)
        r_zL = w(nlp.has_xL, m - (sl_xL + stp.x) * (it.z_L + stp.z_L))
        r_zU = w(nlp.has_xU, m - (sl_xU - stp.x) * (it.z_U + stp.z_U))
        r_vL = w(nlp.has_dL, m - (sl_sL + stp.s) * (it.v_L + stp.v_L))
        r_vU = w(nlp.has_dU, m - (sl_sU - stp.s) * (it.v_U + stp.v_U))
    B = it.x.shape[0]
    parts_c = (w(nlp.has_xL, r_zL / sl_xL) - w(nlp.has_xU, r_zU / sl_xU),
               w(nlp.has_dL, r_vL / sl_sL) - w(nlp.has_dU, r_vU / sl_sU),
               it.x.new_zeros((B, nlp.me)), it.x.new_zeros((B, nlp.mi)))
    (dx2, ds2, dyc2, dyd2), _ = solve_any(nlp, opts, sr.fac, sr.K, parts_c)
    d_corr = Iterate(
        x=stp.x + dx2, s=stp.s + ds2, y_c=stp.y_c + dyc2, y_d=stp.y_d + dyd2,
        z_L=stp.z_L + w(nlp.has_xL, (r_zL - it.z_L * dx2) / sl_xL),
        z_U=stp.z_U + w(nlp.has_xU, (r_zU + it.z_U * dx2) / sl_xU),
        v_L=stp.v_L + w(nlp.has_dL, (r_vL - it.v_L * ds2) / sl_sL),
        v_U=stp.v_U + w(nlp.has_dU, (r_vU + it.v_U * ds2) / sl_sU))
    a_pr, a_du = kkt.fraction_to_boundary(nlp, it, d_corr, tau)
    p, d = col(a_pr), col(a_du)
    trial = Iterate(
        x=it.x + p * d_corr.x, s=it.s + p * d_corr.s,
        y_c=it.y_c + p * d_corr.y_c, y_d=it.y_d + p * d_corr.y_d,
        z_L=it.z_L + d * d_corr.z_L, z_U=it.z_U + d * d_corr.z_U,
        v_L=it.v_L + d * d_corr.v_L, v_U=it.v_U + d * d_corr.v_U)
    if opts.corrector_type == "affine":
        # reject when the complementarity did not shrink enough
        # (corrector_compl_avrg_red_fact, :826-840)
        active = active & (avg_complementarity(nlp, trial)[0]
                           < opts.corrector_compl_avrg_red_fact
                           * avg_complementarity(nlp, it)[0])
    return dict(trial=trial, alpha_pr=a_pr, alpha_du=a_du, active=active)


def _derivatives_finite(nlp: CanonicalNLP, it: Iterate):
    """check_derivatives_for_naninf (IpTNLPAdapter.cpp:1180): the Jacobian
    and Lagrangian-Hessian actions on the ones vector are finite, per lane
    (J 1 and W 1 touch every stored entry)."""
    from torch.func import grad, jvp, vmap
    ones = torch.ones_like(it.x)
    jc1, jd1 = jvp(nlp.eval_cd, (it.x,), (ones,))[1]

    def w1(x, yc, yd, ln):
        g = grad(lambda z: nlp.lag1(z, yc, yd, ln))
        return jvp(g, (x,), (torch.ones_like(x),))[1]

    wv = vmap(w1)(it.x, it.y_c, it.y_d, nlp.lane())
    return (torch.isfinite(jc1).all(-1) & torch.isfinite(jd1).all(-1)
            & torch.isfinite(wv).all(-1))


def _x_user(nlp: CanonicalNLP, x):
    """The user-space x of every lane (fixed variables put back)."""
    s = nlp.struct
    if s.n == s.n_full:
        return x
    return torch.cat([x, nlp.x_fixed], -1)[:, s.index("perm", x.device)]


def initial_state(nlp: CanonicalNLP, opts: Options,
                  it0: Optional[Iterate] = None) -> IPMState:
    """The state before the first iteration: the default initialization, or
    the warm start from ``it0`` (``warm_start_init_point``; without it
    ``it0`` is taken as it is), with mu re-targeted by
    ``warm_start_target_mu`` on a warm start (``solver.py:1271-1328``)."""
    B, dtype, dev = nlp.batch, nlp.dtype, nlp.device
    if it0 is None:
        it = default_initialize(nlp, opts)
    elif opts.warm_start_init_point:
        it = warm_start_initialize(nlp, opts, it0)
    else:
        it = it0
    if it0 is not None and opts.warm_start_target_mu > 0.0:
        opts = opts.replace(mu_init=opts.warm_start_target_mu)
    ev = evaluate(nlp, it.x.to(torch.float64) if _high_precision(nlp, opts) else it.x)
    theta0 = _theta(ev.c, ev.d, it.s, opts.constraint_violation_norm_type).to(dtype)
    ms = mu_init_state(opts, B, dtype, dev)
    z = torch.zeros((B,), dtype=dtype, device=dev)
    zi = torch.zeros((B,), dtype=torch.int64, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    return IPMState(
        it=it, mu=ms.mu, tau=ms.tau, iter_count=zi, delta_w_last=z,
        fs=filter_init(B, opts.max_filter_size, dtype, dev),
        theta_min=opts.theta_min_fact * torch.clamp(theta0, min=1.0),
        theta_max=opts.theta_max_fact * torch.clamp(theta0, min=1.0),
        status=torch.full((B,), _CONTINUE, dtype=torch.int64, device=dev),
        acceptable_count=zi, last_alpha_pr=z, last_alpha_du=z,
        last_ls_count=zi, last_delta_x=z, last_step_norm=z,
        restoration_count=zi, tiny_step_count=zi,
        counters=counters_init(B, dev),
        wd_active=torch.zeros((B,), dtype=torch.bool, device=dev),
        wd_trials=zi, wd_shortened_count=zi, wd_ref=it,
        wd_ref_theta=inf, wd_ref_phi=inf, soft_resto_count=zi, ev=ev,
        **robust_state_init(opts, it, outer=True))


def initial_check(nlp: CanonicalNLP, opts: Options, st: IPMState) -> IPMState:
    """The convergence check before the first iteration (IpIpoptAlg.cpp:343)."""
    res = kkt_residuals(nlp, st.it, st.ev, 0.0)
    E, d_inf, p_inf, c_inf = optimality_error(nlp, st.it, res, opts.s_max)
    conv = check_convergence(opts, st.iter_count, st.acceptable_count,
                             E, d_inf, p_inf, c_inf, max_init(st.it.x.abs(), 0.0))
    done = (st.status == _CONTINUE) & (conv.status == int(SolverReturn.SUCCESS))
    return st._replace(status=torch.where(done, conv.status, st.status))


def guarded_step(nlp: CanonicalNLP, opts: Options, st: IPMState) -> IPMState:
    """One outer iteration of the running lanes; finished lanes keep their
    state bit for bit (``ipopt_tpu/batch.py:31-35``)."""
    running = st.status == _CONTINUE
    if host_bool(running.all()):
        return ipm_step_with_resto(nlp, opts, st)
    idx = running.nonzero().squeeze(-1)
    sub = ipm_step_with_resto(nlp.take(idx), opts, tree_take(st, idx))
    return tree_put(st, idx, sub)


def run_ipm(nlp: CanonicalNLP, opts: Options, st: IPMState,
            clocks: Optional[tuple] = None) -> IPMState:
    """The outer loop, while any lane is running.  With ``clocks`` (the wall
    and CPU times the solve started at), max_wall_time and max_cpu_time are
    checked before every iteration (IpOptErrorConvCheck.cpp:167-213): the
    running lanes end with WALLTIME_EXCEEDED or CPUTIME_EXCEEDED."""
    k = 0
    while host_bool((st.status == _CONTINUE).any()):
        if clocks is not None:
            over = None
            if time.perf_counter() - clocks[0] > opts.max_wall_time:
                over = SolverReturn.WALLTIME_EXCEEDED
            elif time.process_time() - clocks[1] > opts.max_cpu_time:
                over = SolverReturn.CPUTIME_EXCEEDED
            if over is not None:
                return st._replace(status=torch.where(
                    st.status == _CONTINUE, int(over), st.status))
        with span("iteration", k):
            st = guarded_step(nlp, opts, st)
        k += 1
    return st


def finalize(nlp: CanonicalNLP, opts: Options, st: IPMState) -> SolveResult:
    """Map back to user space, unscale, final statistics."""
    it = st.it
    s = nlp.struct
    B, dev = it.x.shape[0], it.x.device
    x = it.x
    if opts.honor_original_bounds:
        x = torch.where(nlp.has_xL, torch.maximum(x, nlp.x_L_orig), x)
        x = torch.where(nlp.has_xU, torch.minimum(x, nlp.x_U_orig), x)
    x_user = _x_user(nlp, x)
    ev = st.ev
    res = kkt_residuals(nlp, it, ev, 0.0)
    E, d_inf, p_inf, c_inf = optimality_error(nlp, it, res, opts.s_max)
    osc = col(nlp.obj_scale)
    g = it.x.new_zeros((B, s.m))
    y = it.x.new_zeros((B, s.m))
    if s.me:
        ei = s.index("eq_idx", dev)
        g[:, ei] = (ev.c / nlp.c_scale + nlp.c_rhs).to(g.dtype)
        y[:, ei] = it.y_c * nlp.c_scale / osc
    if s.mi:
        ii = s.index("ineq_idx", dev)
        g[:, ii] = (ev.d / nlp.d_scale).to(g.dtype)
        y[:, ii] = it.y_d * nlp.d_scale / osc
    zl = it.x.new_zeros((B, s.n_full))
    zu = it.x.new_zeros((B, s.n_full))
    fi = s.index("free_idx", dev)
    zl[:, fi] = it.z_L / osc
    zu[:, fi] = it.z_U / osc
    return SolveResult(
        x=x_user, obj=ev.f / nlp.obj_scale, status=st.status,
        iter_count=st.iter_count, mu=st.mu, g=g, y=y, z_L=zl, z_U=zu,
        dual_inf=d_inf, primal_inf=p_inf, compl_inf=c_inf, E_scaled=E,
        iterate=it, counters=st.counters,
        restoration_count=st.restoration_count)


def solve_canonical(nlp: CanonicalNLP, opts: Options,
                    initial_convergence_check: bool = True,
                    it0: Optional[Iterate] = None) -> SolveResult:
    """Solve every lane of a canonical batch, from ``it0`` if given; counts
    the batched factorizations."""
    check_supported(opts)
    clocks = None
    if opts.max_wall_time < 1e19 or opts.max_cpu_time < 1e6:
        clocks = (time.perf_counter(), time.process_time())

    def calls():
        return _ldlt_mod.ldlt.calls + bcr_factorize.calls + nd_factorize.calls

    calls0 = calls()
    with solve_span(opts.timing_statistics or opts.print_timing_statistics):
        st = initial_state(nlp, opts, it0)
        if initial_convergence_check:
            st = initial_check(nlp, opts, st)
        st = run_ipm(nlp, opts, st, clocks)
        res = finalize(nlp, opts, st)
    return res._replace(batched_factorizations=calls() - calls0)


def _unbatch(res: SolveResult) -> SolveResult:
    def first(v):
        if isinstance(v, torch.Tensor):
            return v[0]
        if isinstance(v, tuple):
            return type(v)(*(first(u) for u in v))
        return v
    return SolveResult(*(first(v) for v in res[:-1]), res.batched_factorizations)


def prepare_options(options: Optional[Options], option_kwargs: dict) -> Options:
    """Options + keyword overrides + the ``ipopt.opt`` file, as the reference
    does (IpIpoptApplication.cpp:160-347: explicit values win)."""
    opts = options or Options()
    if option_kwargs:
        opts = opts.replace(**option_kwargs)
    if opts.option_file_name:
        import os
        if os.path.exists(opts.option_file_name):
            from ..options import parse_options_file
            with open(opts.option_file_name) as fh:
                file_vals = parse_options_file(fh.read())
            defaults = Options()
            fill = {k: v for k, v in file_vals.items()
                    if getattr(opts, k) == getattr(defaults, k)}
            if fill:
                opts = opts.replace(**fill)
    if opts.suppress_all_output:
        opts = opts.replace(print_level=0, file_print_level=0,
                            print_timing_statistics=False)
    check_supported(opts)
    return opts


def _warm_iterate_from_nlp(problem: NLP, cnlp: CanonicalNLP) -> Iterate:
    """The warm iterate of the user's starting multipliers ``y0``, ``z_L0``,
    ``z_U0`` (TNLP::get_starting_point with init_z / init_lambda,
    ``solver.py:1588-1620``), in the scaled internal space."""
    s = cnlp.struct
    x = cnlp.x0
    dev, dtype = x.device, x.dtype
    osc = col(cnlp.obj_scale)
    y_c = x.new_zeros((1, s.me))
    y_d = x.new_zeros((1, s.mi))
    if problem.y0 is not None and s.m:
        y_all = torch.as_tensor(np.asarray(problem.y0, dtype=np.float64),
                                dtype=dtype, device=dev)[None]
        if s.me:
            y_c = y_all[:, s.index("eq_idx", dev)] * osc / cnlp.c_scale
        if s.mi:
            y_d = y_all[:, s.index("ineq_idx", dev)] * osc / cnlp.d_scale

    def zfree(z0):
        if z0 is None:
            return torch.ones_like(x)
        z = torch.as_tensor(np.asarray(z0, dtype=np.float64), dtype=dtype,
                            device=dev)[None]
        return z[:, s.index("free_idx", dev)] * osc

    def w(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    one_s = x.new_ones((1, s.mi))
    return Iterate(x=x, s=cnlp.eval_d(x), y_c=y_c, y_d=y_d,
                   z_L=w(cnlp.has_xL, zfree(problem.z_L0)),
                   z_U=w(cnlp.has_xU, zfree(problem.z_U0)),
                   v_L=w(cnlp.has_dL, one_s), v_U=w(cnlp.has_dU, one_s))


def solve(problem, options: Optional[Options] = None, device=None, it0=None,
          intermediate_callback=None, custom_kkt_solver=None,
          **option_kwargs) -> SolveResult:
    """Solve one NLP (IpoptApplication::OptimizeTNLP equivalent).

    ``problem`` is an ``NLP`` (on the dense backend, or with
    ``linear_solver="banded-bcr"`` or ``"multifrontal"`` on the banded or
    nested-dissection backend of ``ipopt_torch.sparse``), a ``ChainedNLP``
    (solved on the block-tridiagonal backend), a ``ScenarioNLP`` (solved on
    the block-arrow backend) or a canonical problem with one lane.  The
    solve runs on ``device``, by default the CUDA device; pass
    ``device="cpu"`` for the CPU.  Keyword arguments override options by
    their Ipopt names.  ``it0`` is a starting iterate, such as the
    ``iterate`` of an earlier result: with ``warm_start_init_point=True`` it
    is pushed inside the bounds as a warm start (ReOptimizeTNLP), otherwise
    taken as it is.  ``intermediate_callback(iter_count=, obj_value=,
    inf_pr=, inf_du=, mu=, alpha_pr=, alpha_du=, ls_trials=)`` runs once per
    iteration (with ``callback_curr_iterate`` also ``curr_iterate=`` and
    ``curr_violations=``, dicts of numpy arrays); returning False stops with
    USER_REQUESTED_STOP.  ``custom_kkt_solver`` is an object with the
    ``factorize`` and ``solve`` halves of the KKT step (the contract is in
    ``step._custom_solver``); it selects ``linear_solver="custom"``.
    ``derivative_test`` prints the derivative checker's verdict before the
    first iteration (``deriv_check.py``).
    """
    opts = prepare_options(options, option_kwargs)
    dev = resolve_device(device)
    from ..journalist import configure_from_options
    configure_from_options(opts)
    if intermediate_callback is not None:
        from ..options import register_callback
        opts = opts.replace(callback_token=register_callback(intermediate_callback))
    if custom_kkt_solver is not None:
        # the GenKKTSolverInterface hook (solver.py:1528-1533)
        from ..options import register_custom_kkt
        opts = opts.replace(linear_solver="custom",
                            custom_kkt_token=register_custom_kkt(custom_kkt_solver))
    if _matrix_free(opts):
        # no saved factorization to reuse for second-order corrections
        opts = opts.replace(max_soc=0)
    if isinstance(problem, NLP) and (opts.replace_bounds or opts.inexact_algorithm):
        # NLPBoundsRemover (IpNLPBoundsRemover.hpp:23); the inexact algorithm
        # requires it (IpInexactAlgBuilder.cpp:64-130): with Sigma_x = 0 the
        # barrier terms live in the slack-scaled s-block only
        from ..interfaces.transforms import remove_bounds
        problem = remove_bounds(problem)
    if isinstance(problem, NLP) and opts.dependency_detector != "none":
        # TNLPAdapter's dependent-equality detection (IpTNLPAdapter.cpp:628)
        from ..interfaces.dependency import detect_dependent_constraints
        from ..interfaces.transforms import reduce_constraints
        from ..journalist import default_journalist, EJournalLevel, EJournalCategory
        deps = detect_dependent_constraints(problem, opts)
        if deps:
            jn = default_journalist()
            jn.printf(EJournalLevel.J_WARNING, EJournalCategory.J_INITIALIZATION,
                      f"Detected {len(deps)} linearly dependent equality "
                      f"constraints; taking those out.\n")
            for k, i in enumerate(deps):
                jn.printf(EJournalLevel.J_DETAILED,
                          EJournalCategory.J_INITIALIZATION, f"c_dep[{k}] = {i}\n")
            problem = reduce_constraints(problem, deps)
    if isinstance(problem, NLP) and opts.linear_solver in ("banded-bcr",
                                                           "multifrontal"):
        from ..sparse import canonicalize_sparse
        cnlp = canonicalize_sparse(problem, opts, device=dev)
    elif isinstance(problem, NLP):
        cnlp = canonicalize(problem, opts, device=dev)
    elif isinstance(problem, ChainedNLP):
        cnlp = canonicalize_chained(problem, opts, device=dev)
    elif isinstance(problem, ScenarioNLP):
        cnlp = canonicalize_scenario(problem, opts, device=dev)
    else:
        cnlp = problem.to(dev)
    if cnlp.batch != 1:
        raise ValueError("solve() takes one problem; use solve_batched")
    if it0 is not None:
        it0 = Iterate(*(torch.as_tensor(v).to(device=dev, dtype=cnlp.dtype)
                        .reshape(1, v.shape[-1]) for v in it0))
    elif (isinstance(problem, NLP) and opts.warm_start_init_point
          and (problem.y0 is not None or problem.z_L0 is not None
               or problem.z_U0 is not None)):
        it0 = _warm_iterate_from_nlp(problem, cnlp)
    if opts.derivative_test != "none":
        from ..deriv_check import check_derivatives, report
        from ..journalist import default_journalist, EJournalLevel, EJournalCategory
        for line in report(check_derivatives(cnlp, opts, device=dev)):
            default_journalist().printf(EJournalLevel.J_SUMMARY,
                                        EJournalCategory.J_NLP, line)
    if opts.print_level >= 4 or (opts.output_file and opts.file_print_level >= 4):
        _print_header()
    res = _unbatch(solve_canonical(cnlp, opts, it0=it0))
    if opts.print_timing_statistics or (opts.timing_statistics and opts.print_level > 0):
        from ..profiling import last_spans, timing_report
        timing_report(last_spans(), res.counters).print()
    return res


def print_counters(c: Counters, out=print) -> None:
    """The evaluation and KKT counters of print_timing_statistics
    (IpIpoptApplication.cpp:628-634), summed over the lanes."""
    out(f"Function evaluations (f,g)..........: {int(c.n_obj_evals.sum())}")
    out(f"Gradient evaluations................: {int(c.n_grad_evals.sum())}")
    out(f"Hessian evaluations.................: {int(c.n_hess_evals.sum())}")
    out(f"KKT factorizations..................: {int(c.n_factorizations.sum())}")
    out(f"KKT backsolve batches...............: {int(c.n_kkt_solves.sum())}")
