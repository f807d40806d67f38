"""Typed option registry + option store.

Reference parity: Ipopt's two-tier config system — ``RegisteredOptions`` (typed
schema with bounds/enums/docs, ``src/Common/IpRegOptions.hpp:683``) and
``OptionsList`` (string store with prefix scoping and ``ipopt.opt`` file parsing,
``src/Common/IpOptionsList.hpp:32``).  Here the schema is a declarative registry
of ``OptionSpec`` and the resolved store is an immutable ``Options`` dataclass
(hashable, so it can be a static jit argument).  Ipopt option *names and default
values* are preserved so existing Ipopt users can carry their settings over.

The ``resto.`` prefix scoping of the reference (restoration sub-algorithm reads
``resto.*`` variants, ``IpAlgBuilder.cpp:900-935``) is supported via
``Options.with_prefix_overrides``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Tuple

_REGISTRY: Dict[str, "OptionSpec"] = {}


@dataclass(frozen=True)
class OptionSpec:
    name: str
    default: Any
    category: str
    doc: str
    lower: Optional[float] = None
    upper: Optional[float] = None
    lower_strict: bool = False
    upper_strict: bool = False
    choices: Optional[Tuple[str, ...]] = None

    def validate(self, value) -> None:
        if self.choices is not None:
            if value not in self.choices:
                raise ValueError(
                    f"option '{self.name}': value {value!r} not in {self.choices}")
            return
        if isinstance(self.default, bool):
            if not isinstance(value, bool):
                raise ValueError(f"option '{self.name}': expected bool, got {value!r}")
            return
        if isinstance(self.default, (int, float)):
            if not isinstance(value, (int, float)):
                raise ValueError(
                    f"option '{self.name}': expected number, got {value!r}")
            if self.lower is not None:
                if self.lower_strict and not value > self.lower:
                    raise ValueError(f"option '{self.name}': must be > {self.lower}")
                if not self.lower_strict and not value >= self.lower:
                    raise ValueError(f"option '{self.name}': must be >= {self.lower}")
            if self.upper is not None:
                if self.upper_strict and not value < self.upper:
                    raise ValueError(f"option '{self.name}': must be < {self.upper}")
                if not self.upper_strict and not value <= self.upper:
                    raise ValueError(f"option '{self.name}': must be <= {self.upper}")


def _opt(default, category, doc, lower=None, upper=None, lower_strict=False,
         upper_strict=False, choices=None):
    """Declare a registered option as a dataclass field (metadata carries the spec)."""
    return field(default=default, metadata=dict(
        category=category, doc=doc, lower=lower, upper=upper,
        lower_strict=lower_strict, upper_strict=upper_strict,
        choices=tuple(choices) if choices else None))


@dataclass(frozen=True)
class Options:
    """All solver options, with Ipopt names and defaults.

    Frozen + hashable so an Options instance can be passed as a static argument
    to jit'd solver entry points; numeric values used inside traced code are
    baked in as compile-time constants (as in Ipopt, options never change during
    a solve).
    """

    # ---- Output (IpIpoptApplication.cpp) ----
    print_level: int = _opt(5, "Output", "Verbosity 0..12 (J_* levels).", 0, 12)
    print_frequency_iter: int = _opt(1, "Output", "Print every N iterations.", 1)
    timing_statistics: bool = _opt(
        False, "Output", "Record the solve's spans (profiling.last_spans) and, "
        "at print_level > 0, print the timing-statistics table after it.")
    print_timing_statistics: bool = _opt(
        False, "Output", "Print the timing-statistics table after the solve "
        "(IpIpoptApplication.cpp:628-634), from its spans; implies "
        "timing_statistics.")
    file_print_level: int = _opt(5, "Output", "Print level for the output_file "
                                 "journal (FileJournal, IpJournalist.hpp:416).", 0, 12)
    output_file: str = _opt("", "Output", "Append iteration log lines to this "
                            "file (FileJournal equivalent).", choices=None)

    # ---- Termination (IpIpoptData.cpp:27, IpOptErrorConvCheck.cpp) ----
    tol: float = _opt(1e-8, "Termination", "Desired scaled NLP error.", 0.0, lower_strict=True)
    max_iter: int = _opt(3000, "Termination", "Maximum iterations.", 0)
    max_wall_time: float = _opt(1e20, "Termination", "Wall clock limit (s).", 0.0, lower_strict=True)
    max_cpu_time: float = _opt(1e6, "Termination", "CPU time limit (s).", 0.0, lower_strict=True)
    dual_inf_tol: float = _opt(1.0, "Termination", "Unscaled dual infeasibility tol.", 0.0, lower_strict=True)
    constr_viol_tol: float = _opt(1e-4, "Termination", "Unscaled constraint violation tol.", 0.0, lower_strict=True)
    compl_inf_tol: float = _opt(1e-4, "Termination", "Unscaled complementarity tol.", 0.0, lower_strict=True)
    s_max: float = _opt(100.0, "Termination", "Scaling threshold s_max in E_mu.", 0.0, lower_strict=True)
    acceptable_tol: float = _opt(1e-6, "Termination", "Acceptable scaled NLP error.", 0.0, lower_strict=True)
    acceptable_iter: int = _opt(15, "Termination", "Consecutive acceptable iters before stop.", 0)
    acceptable_dual_inf_tol: float = _opt(1e10, "Termination", "Acceptable dual infeasibility.", 0.0, lower_strict=True)
    acceptable_constr_viol_tol: float = _opt(1e-2, "Termination", "Acceptable constraint violation.", 0.0, lower_strict=True)
    acceptable_compl_inf_tol: float = _opt(1e-2, "Termination", "Acceptable complementarity.", 0.0, lower_strict=True)
    acceptable_obj_change_tol: float = _opt(1e20, "Termination", "Acceptable relative objective change.", 0.0)
    diverging_iterates_tol: float = _opt(1e20, "Termination", "Divergence threshold on ||x||_inf.", 0.0, lower_strict=True)
    mu_target: float = _opt(0.0, "Termination", "Target barrier parameter.", 0.0)

    # ---- NLP (IpOrigIpoptNLP.cpp, IpTNLPAdapter.cpp) ----
    nlp_lower_bound_inf: float = _opt(-1e19, "NLP", "Bounds <= this count as -inf.")
    nlp_upper_bound_inf: float = _opt(1e19, "NLP", "Bounds >= this count as +inf.")
    bound_relax_factor: float = _opt(1e-8, "NLP", "Relative bound relaxation at setup.", 0.0)
    honor_original_bounds: bool = _opt(False, "NLP", "Project final x onto original bounds.")
    check_derivatives_for_naninf: bool = _opt(False, "NLP", "NaN/Inf guards on derivatives.")
    fixed_variable_treatment: str = _opt(
        "make_parameter", "NLP", "How to handle x_L==x_U variables.",
        choices=("make_parameter", "make_parameter_nodual", "make_constraint", "relax_bounds"))
    kappa_d: float = _opt(1e-5, "NLP", "Weight for linear damping term.", 0.0)

    # ---- NLP scaling (IpGradientScaling.cpp) ----
    nlp_scaling_method: str = _opt(
        "gradient-based", "NLP Scaling", "Scaling technique for the NLP.",
        choices=("none", "user-scaling", "gradient-based", "equilibration-based"))
    obj_scaling_factor: float = _opt(1.0, "NLP Scaling", "Extra objective scaling factor.")
    nlp_scaling_max_gradient: float = _opt(100.0, "NLP Scaling", "Gradient cap defining scaling.", 0.0, lower_strict=True)
    nlp_scaling_min_value: float = _opt(1e-8, "NLP Scaling", "Minimum scaling value.", 0.0)

    # ---- Initialization (IpDefaultIterateInitializer.cpp) ----
    bound_push: float = _opt(0.01, "Initialization", "kappa_1: absolute initial bound push.", 0.0, lower_strict=True)
    bound_frac: float = _opt(0.01, "Initialization", "kappa_2: relative initial bound push.", 0.0, 0.5, lower_strict=True)
    slack_bound_push: float = _opt(0.01, "Initialization", "kappa_1 for slacks.", 0.0, lower_strict=True)
    slack_bound_frac: float = _opt(0.01, "Initialization", "kappa_2 for slacks.", 0.0, 0.5, lower_strict=True)
    bound_mult_init_val: float = _opt(1.0, "Initialization", "Initial bound multiplier value.", 0.0, lower_strict=True)
    bound_mult_init_method: str = _opt(
        "constant", "Initialization", "How to initialize bound multipliers.",
        choices=("constant", "mu-based"))
    constr_mult_init_max: float = _opt(1e3, "Initialization", "Max least-squares y before reset to 0.", 0.0)
    least_square_init_primal: bool = _opt(False, "Initialization", "Least-squares initial primals.")
    least_square_init_duals: bool = _opt(False, "Initialization", "Least-squares all duals.")
    warm_start_init_point: bool = _opt(False, "Warm Start", "Use user-provided primal-dual point.")

    # ---- Warm start (IpWarmStartIterateInitializer.cpp) ----
    warm_start_bound_push: float = _opt(1e-3, "Warm Start", "Bound push for warm starts.", 0.0, lower_strict=True)
    warm_start_bound_frac: float = _opt(1e-3, "Warm Start", "Bound frac for warm starts.", 0.0, 0.5, lower_strict=True)
    warm_start_slack_bound_push: float = _opt(1e-3, "Warm Start", "Slack bound push for warm starts.", 0.0, lower_strict=True)
    warm_start_slack_bound_frac: float = _opt(1e-3, "Warm Start", "Slack bound frac for warm starts.", 0.0, 0.5, lower_strict=True)
    warm_start_mult_bound_push: float = _opt(1e-3, "Warm Start", "Multiplier push for warm starts.", 0.0, lower_strict=True)
    warm_start_mult_init_max: float = _opt(1e6, "Warm Start", "Max warm-start multiplier magnitude.")
    warm_start_entire_iterate: bool = _opt(False, "Warm Start", "Restore full iterate incl. slacks.")

    # ---- Barrier parameter (IpMonotoneMuUpdate.cpp, IpAdaptiveMuUpdate.cpp) ----
    mu_strategy: str = _opt("monotone", "Barrier", "Update strategy for mu.",
                            choices=("monotone", "adaptive"))
    mu_oracle: str = _opt("quality-function", "Barrier", "Oracle for adaptive mu.",
                          choices=("probing", "loqo", "quality-function"))
    fixed_mu_oracle: str = _opt("average_compl", "Barrier", "Oracle for fixed-mode mu.",
                                choices=("probing", "loqo", "quality-function", "average_compl"))
    mu_init: float = _opt(0.1, "Barrier", "Initial barrier parameter.", 0.0, lower_strict=True)
    mu_max_fact: float = _opt(1e3, "Barrier", "Factor for mu_max from avg compl.", 0.0, lower_strict=True)
    mu_max: float = _opt(1e5, "Barrier", "Max mu in adaptive mode.", 0.0, lower_strict=True)
    mu_min: float = _opt(1e-11, "Barrier", "Min mu in adaptive mode.", 0.0, lower_strict=True)
    barrier_tol_factor: float = _opt(10.0, "Barrier", "kappa_epsilon: barrier problem tol = factor*mu.", 0.0, lower_strict=True)
    mu_linear_decrease_factor: float = _opt(0.2, "Barrier", "kappa_mu.", 0.0, 1.0, True, True)
    mu_superlinear_decrease_power: float = _opt(1.5, "Barrier", "theta_mu.", 1.0, 2.0, True, True)
    tau_min: float = _opt(0.99, "Barrier", "Min fraction-to-boundary tau.", 0.0, 1.0, True, True)
    mu_allow_fast_monotone_decrease: bool = _opt(True, "Barrier", "Allow mu decrease without a step.")
    adaptive_mu_globalization: str = _opt(
        "obj-constr-filter", "Barrier", "Globalization for adaptive mu.",
        choices=("kkt-error", "obj-constr-filter", "never-monotone-mode"))
    adaptive_mu_kkterror_red_iters: int = _opt(4, "Barrier", "Max iters without kkt-error decrease.", 0)
    adaptive_mu_kkterror_red_fact: float = _opt(0.9999, "Barrier", "Required kkt-error reduction.", 0.0, 1.0, True, True)
    adaptive_mu_monotone_init_factor: float = _opt(0.8, "Barrier", "Initial mu factor after switch to monotone.", 0.0, lower_strict=True)
    quality_function_max_section_steps: int = _opt(8, "Barrier", "Golden-section iterations.", 0)
    quality_function_section_sigma_tol: float = _opt(0.01, "Barrier", "Section search sigma tolerance.", 0.0, 1.0, upper_strict=True)
    quality_function_section_qf_tol: float = _opt(0.0, "Barrier", "Section search qf tolerance.", 0.0, 1.0, upper_strict=True)
    sigma_max: float = _opt(100.0, "Barrier", "Max centering sigma.", 0.0, lower_strict=True)
    sigma_min: float = _opt(1e-6, "Barrier", "Min centering sigma.", 0.0)
    mehrotra_algorithm: bool = _opt(False, "Barrier", "Mehrotra predictor-corrector mode.")

    # ---- Line search (IpFilterLSAcceptor.cpp, IpBacktrackingLineSearch.cpp) ----
    line_search_method: str = _opt("filter", "Line Search", "Globalization method.",
                                   choices=("filter", "penalty", "cg-penalty", "none"))
    alpha_red_factor: float = _opt(0.5, "Line Search", "Step reduction factor.", 0.0, 1.0, True, True)
    max_soc: int = _opt(4, "Line Search", "Max second-order correction steps.", 0)
    kappa_soc: float = _opt(0.99, "Line Search", "SOC sufficient-reduction factor.", 0.0, lower_strict=True)
    theta_max_fact: float = _opt(1e4, "Line Search", "theta_max = fact*max(1,theta0).", 0.0, lower_strict=True)
    theta_min_fact: float = _opt(1e-4, "Line Search", "theta_min = fact*max(1,theta0).", 0.0, lower_strict=True)
    eta_phi: float = _opt(1e-8, "Line Search", "Armijo factor.", 0.0, 0.5, True, True)
    delta: float = _opt(1.0, "Line Search", "Switching rule multiplier.", 0.0, lower_strict=True)
    s_phi: float = _opt(2.3, "Line Search", "Switching rule phi exponent.", 1.0, lower_strict=True)
    s_theta: float = _opt(1.1, "Line Search", "Switching rule theta exponent.", 1.0, lower_strict=True)
    gamma_phi: float = _opt(1e-8, "Line Search", "Filter margin factor (phi).", 0.0, 1.0, True, True)
    gamma_theta: float = _opt(1e-5, "Line Search", "Filter margin factor (theta).", 0.0, 1.0, True, True)
    alpha_min_frac: float = _opt(0.05, "Line Search", "gamma_alpha for alpha_min.", 0.0, 1.0, True, True)
    max_backtracking_steps: int = _opt(40, "Line Search", "Max trial steps per iteration (static bound; "
                                       "Ipopt's watchdog_trial_iter bound analog).", 1)
    obj_max_inc: float = _opt(5.0, "Line Search", "Max orders of magnitude barrier increase.", 1.0, lower_strict=True)
    max_filter_resets: int = _opt(5, "Line Search", "Max filter reset heuristic count.", 0)
    filter_reset_trigger: int = _opt(5, "Line Search", "Iterations triggering filter reset.", 1)
    accept_every_trial_step: bool = _opt(False, "Line Search", "Disable line search (full steps).")
    alpha_for_y: str = _opt(
        "primal", "Line Search", "Step size for equality-constraint "
        "multipliers y (IpBacktrackingLineSearch.cpp:85-97,905-990).",
        choices=("primal", "bound-mult", "min", "max", "full",
                 "min-dual-infeas", "safer-min-dual-infeas",
                 "primal-and-full", "dual-and-full", "acceptor"))
    alpha_for_y_tol: float = _opt(
        10.0, "Line Search", "Step-size tolerance triggering a full y step "
        "for alpha_for_y=primal-and-full/dual-and-full.", 0.0)
    constraint_violation_norm_type: str = _opt(
        "1-norm", "Line Search", "Norm for the constraint violation theta "
        "in the line search (IpIpoptCalculatedQuantities.cpp:175).",
        choices=("1-norm", "2-norm", "max-norm"))
    magic_steps: bool = _opt(
        False, "Line Search", "Slack 'magic steps' on trial points: move s "
        "toward d(x) within its bounds to reduce theta without changing x "
        "(IpBacktrackingLineSearch.cpp:1003-1099).")
    slack_move: float = _opt(
        2.2e-12, "Line Search", "Correction size for nonpositive slacks "
        "(mach_eps^0.75; IpIpoptCalculatedQuantities.cpp:164-171).", 0.0)

    # ---- Inexact algorithm (src/Algorithm/Inexact/, Curtis-Schenk-Waechter;
    #      IpInexactAlgBuilder.cpp:64-130 gate, IpInexactDoglegNormal.cpp:30-45,
    #      IpInexactPDTerminationTester.cpp:31-80, IpInexactLSAcceptor.cpp) ----
    inexact_algorithm: bool = _opt(False, "Inexact", "Normal/tangential decomposition with "
                                   "inexact iterative KKT solves (PDE-scale mode).")
    omega_init: float = _opt(100.0, "Inexact", "Initial normal-step trust-region factor.", 0.0, lower_strict=True)
    omega_max: float = _opt(1e20, "Inexact", "Max trust-region factor.", 0.0, lower_strict=True)
    tcc_psi: float = _opt(1e-1, "Inexact", "Tangential component condition psi.", 0.0, lower_strict=True)
    tcc_theta: float = _opt(1e-12, "Inexact", "Tangential component condition theta.", 0.0, lower_strict=True)
    tcc_theta_mu_exponent: float = _opt(0.0, "Inexact", "mu exponent with tcc_theta.", 0.0)
    tcc_zeta: float = _opt(1e-1, "Inexact", "Tangential component condition zeta.", 0.0, lower_strict=True)
    tt_kappa1: float = _opt(1e-3, "Inexact", "Termination tests 1/3 kappa1.", 0.0, lower_strict=True)
    tt_kappa2: float = _opt(1e-1, "Inexact", "Termination test 2 kappa2.", 0.0, lower_strict=True)
    tt_eps2: float = _opt(1.0, "Inexact", "Termination test 2 eps2.", 0.0, lower_strict=True)
    tt_eps3: float = _opt(0.9, "Inexact", "Termination test 3 eps3.", 0.0, lower_strict=True)
    inexact_desired_pd_residual: float = _opt(1e-3, "Inexact", "Target relative PD residual.", 0.0, lower_strict=True)
    inexact_desired_pd_residual_iter: int = _opt(1, "Inexact", "Iterations for desired residual.", 0)
    nu_init: float = _opt(1e-6, "Inexact", "Initial penalty parameter (PenaltyLSAcceptor).", 0.0, lower_strict=True)
    nu_inc: float = _opt(1e-4, "Inexact", "Penalty increment.", 0.0, lower_strict=True)
    rho: float = _opt(1e-1, "Inexact", "Penalty update formula value.", 0.0, 1.0, True, True)
    flexible_penalty_function: bool = _opt(True, "Inexact", "Curtis-Nocedal flexible penalty.")
    nu_low_init: float = _opt(1e-6, "Inexact", "Initial lower penalty (flexible).", 0.0, lower_strict=True)
    nu_low_fact: float = _opt(1e-2, "Inexact", "Lower-penalty update factor.", 0.0, lower_strict=True)
    nu_update_inf_skip_tol: float = _opt(1e-9, "Inexact", "Skip nu update below this infeasibility.", 0.0, lower_strict=True)

    # ---- Chen-Goldfarb penalty line search (src/contrib/CGPenalty/:
    #      IpCGSearchDirCalc.cpp:42-112, IpCGPenaltyLSAcceptor.cpp:47-170) ----
    penalty_init_min: float = _opt(1.0, "CG Penalty", "Min initial penalty.", 0.0, lower_strict=True)
    penalty_init_max: float = _opt(1e5, "CG Penalty", "Max initial penalty.", 0.0, lower_strict=True)
    penalty_max: float = _opt(1e30, "CG Penalty", "Max penalty parameter.", 0.0, lower_strict=True)
    pen_des_fact: float = _opt(2e-1, "CG Penalty", "Penalty descent factor.", 0.0, lower_strict=True)
    kappa_x_dis: float = _opt(1e2, "CG Penalty", "Fast-direction x-discrepancy test.", 0.0, lower_strict=True)
    kappa_y_dis: float = _opt(1e4, "CG Penalty", "Fast-direction y-discrepancy test.", 0.0, lower_strict=True)
    vartheta: float = _opt(0.5, "CG Penalty", "Fast-direction test exponent.", 0.0, lower_strict=True)
    delta_y_max: float = _opt(1e12, "CG Penalty", "Fast-direction y-norm cap.", 0.0, lower_strict=True)
    fast_des_fact: float = _opt(1e-1, "CG Penalty", "Fast-direction descent test factor.", 0.0, lower_strict=True)
    never_use_fact_cgpen_direction: bool = _opt(False, "CG Penalty", "Disable the fast CG direction.")
    never_use_piecewise_penalty_ls: bool = _opt(False, "CG Penalty", "Disable PLPF acceptance.")
    eta_penalty: float = _opt(1e-8, "CG Penalty", "Armijo relaxation for the penalty function.", 0.0, 0.5, True, True)
    penalty_update_infeasibility_tol: float = _opt(1e-9, "CG Penalty", "Infeasibility threshold in penalty update.", 0.0, lower_strict=True)
    eta_min: float = _opt(1e1, "CG Penalty", "Min eta tolerance in penalty update.", 0.0, lower_strict=True)
    pen_theta_max_fact: float = _opt(1e4, "CG Penalty", "Constraint-violation cap factor.", 0.0, lower_strict=True)
    penalty_update_compl_tol: float = _opt(1e1, "CG Penalty", "Complementarity window in penalty update.", 0.0, lower_strict=True)
    chi_hat: float = _opt(2.0, "CG Penalty", "Penalty increase factor (infeasible).", 0.0, lower_strict=True)
    chi_tilde: float = _opt(5.0, "CG Penalty", "Penalty increase factor (near-feasible).", 0.0, lower_strict=True)
    chi_cup: float = _opt(1.5, "CG Penalty", "Penalty vs multiplier-norm factor.", 0.0, lower_strict=True)
    gamma_hat: float = _opt(0.04, "CG Penalty", "eta init factor.", 0.0, lower_strict=True)
    gamma_tilde: float = _opt(4.0, "CG Penalty", "eta init cap.", 0.0, lower_strict=True)
    epsilon_c: float = _opt(1e-2, "CG Penalty", "Infeasibility switch in penalty increase.", 0.0, lower_strict=True)
    piecewisepenalty_gamma_obj: float = _opt(1e-13, "CG Penalty", "PLPF objective margin.", 0.0, lower_strict=True)
    piecewisepenalty_gamma_infeasi: float = _opt(1e-13, "CG Penalty", "PLPF infeasibility margin.", 0.0, lower_strict=True)
    min_alpha_primal: float = _opt(1e-13, "CG Penalty", "Force-accept below this step size.", 0.0, lower_strict=True)
    max_piece_number: int = _opt(16, "CG Penalty", "PLPF list capacity (static; reference hardcodes 100).", 1)
    accept_after_max_steps: int = _opt(-1, "Line Search", "Accept after N backtracks regardless.", -1)
    watchdog_shortened_iter_trigger: int = _opt(10, "Line Search", "Shortened iters before watchdog.", 0)
    watchdog_trial_iter_max: int = _opt(3, "Line Search", "Max watchdog trial iterations.", 1)
    tiny_step_tol: float = _opt(0.0, "Line Search", "Tiny step detection tol (0 = 10*machine_eps of dtype).", 0.0)
    tiny_step_y_tol: float = _opt(1e-2, "Line Search", "Tiny step dual tolerance.", 0.0)
    max_filter_size: int = _opt(100, "Line Search", "Static filter capacity (TPU-specific).", 4)
    kappa_sigma: float = _opt(1e10, "Line Search", "Bound multiplier clipping factor.", 0.0, lower_strict=True)
    recalc_y: bool = _opt(False, "Line Search", "Recompute y by least squares after steps.")
    recalc_y_feas_tol: float = _opt(1e-6, "Line Search", "Feasibility threshold for recalc_y.", 0.0, lower_strict=True)
    expect_infeasible_problem: bool = _opt(False, "Line Search", "Enable infeasibility heuristics.")
    expect_infeasible_problem_ctol: float = _opt(1e-3, "Line Search", "Infeasibility heuristic trigger tol.", 0.0)
    expect_infeasible_problem_ytol: float = _opt(1e8, "Line Search", "Multiplier threshold for resto trigger.", 0.0, lower_strict=True)
    soft_resto_pderror_reduction_factor: float = _opt(0.9999, "Restoration", "Soft resto required pd-error reduction.", 0.0)
    max_soft_resto_iters: int = _opt(10, "Restoration", "Max soft restoration iterations.", 0)

    # ---- Restoration phase (IpRestoMinC_1Nrm.cpp, IpRestoIpoptNLP.cpp) ----
    start_with_resto: bool = _opt(False, "Restoration", "Start directly in restoration.")
    required_infeasibility_reduction: float = _opt(0.9, "Restoration", "Required theta reduction in resto.", 0.0, 1.0, upper_strict=True)
    max_resto_iter: int = _opt(3000000, "Restoration", "Max cumulative restoration iterations.", 0)
    dependency_detector: str = _opt(
        "none", "NLP",
        "Detect linearly dependent equality constraints at x0 and remove "
        "them (TNLPAdapter; solver-name choices map to the TPU-native "
        "Gram-Schmidt detector).",
        choices=("none", "qr", "mumps", "wsmp", "ma28"))
    dependency_detection_with_rhs: bool = _opt(
        False, "NLP",
        "Consider right-hand sides during dependency detection (keep "
        "inconsistent duplicates).")
    max_resto_resto_iters: int = _opt(
        3, "Restoration",
        "Max restoration-of-restoration activations (RestoRestoPhase resets "
        "of the p/n slacks inside one nested resto solve; TPU-specific bound).", 0)
    resto_penalty_parameter: float = _opt(1000.0, "Restoration", "rho in the resto objective.", 0.0, lower_strict=True)
    resto_proximity_weight: float = _opt(1.0, "Restoration", "Weight of proximity term (zeta scale).", 0.0)
    bound_mult_reset_threshold: float = _opt(1000.0, "Restoration", "Reset z after resto if larger.", 0.0)
    constr_mult_reset_threshold: float = _opt(0.0, "Restoration", "Reset y after resto if larger.", 0.0)
    resto_failure_feasibility_threshold: float = _opt(0.0, "Restoration", "0 means 1e2*tol.", 0.0)

    # ---- Linear solver / step computation (IpPDFullSpaceSolver.cpp) ----
    linear_solver: str = _opt("dense-ldlt", "Linear Solver",
                              "KKT factorization backend (TPU-native); "
                              "'custom' dispatches to a user-registered "
                              "solver (GenKKTSolverInterface hook).",
                              choices=("dense-ldlt", "dense-ldlt-blocked",
                                       "condensed-cholesky", "minres",
                                       "banded-bcr", "multifrontal",
                                       "custom"))
    chain_shard: bool = _opt(
        False, "Linear Solver",
        "Distribute the chained/BTD factorization over the mesh axis "
        "registered with parallel.chain_shard.set_chain_mesh (explicit "
        "shard_map SPIKE/Schur decomposition; the MUMPS-over-MPI role). "
        "Exact-Hessian chained backend only.")
    min_refinement_steps: int = _opt(1, "Linear Solver", "Min iterative refinement steps.", 0)
    max_refinement_steps: int = _opt(10, "Linear Solver", "Max iterative refinement steps.", 0)
    residual_ratio_max: float = _opt(1e-10, "Linear Solver", "Acceptable residual ratio.", 0.0, lower_strict=True)
    residual_ratio_singular: float = _opt(1e-5, "Linear Solver", "Residual ratio declaring singularity.", 0.0, lower_strict=True)
    residual_improvement_factor: float = _opt(1.0, "Linear Solver", "Required refinement improvement.", 0.0, lower_strict=True)
    neg_curv_test_tol: float = _opt(0.0, "Linear Solver", "Inertia-free negative curvature tol.", 0.0)
    neg_curv_test_reg: bool = _opt(True, "Linear Solver", "Use primal regularization in curvature test.")
    fast_step_computation: bool = _opt(False, "Linear Solver", "Trust solves; skip residual checks.")
    mehrotra_probing: bool = _opt(False, "Linear Solver", "internal", )
    ldlt_pivot_tol: float = _opt(0.0, "Linear Solver", "Static-pivot zero threshold (0: dtype eps based).", 0.0)
    linear_system_scaling: str = _opt("none", "Linear Solver",
                                      "Equilibration of the KKT matrix (MC19 analog, "
                                      "IpMc19TSymScalingMethod.cpp). The reference "
                                      "defaults to mc19 because MA27's threshold "
                                      "pivoting needs balanced entries; our static-"
                                      "pivot LDLT + iterative refinement does not, "
                                      "and A/B runs show mc19 increases factorization "
                                      "counts on banded L-BFGS problems (r3 verdict). "
                                      "Off by default; opt in per problem.",
                                      choices=("none", "mc19"))

    # ---- Inertia correction (IpPDPerturbationHandler.cpp) ----
    max_hessian_perturbation: float = _opt(1e20, "Hessian Perturbation", "delta_w^max.", 0.0, lower_strict=True)
    min_hessian_perturbation: float = _opt(1e-20, "Hessian Perturbation", "delta_w^min.", 0.0)
    perturb_inc_fact_first: float = _opt(100.0, "Hessian Perturbation", "kappa_w^+ bar (first).", 1.0, lower_strict=True)
    perturb_inc_fact: float = _opt(8.0, "Hessian Perturbation", "kappa_w^+.", 1.0, lower_strict=True)
    perturb_dec_fact: float = _opt(1.0 / 3.0, "Hessian Perturbation", "kappa_w^-.", 0.0, 1.0, True, True)
    first_hessian_perturbation: float = _opt(1e-4, "Hessian Perturbation", "delta_0.", 0.0, lower_strict=True)
    jacobian_regularization_value: float = _opt(1e-8, "Hessian Perturbation", "delta_c bar.", 0.0)
    jacobian_regularization_exponent: float = _opt(0.25, "Hessian Perturbation", "kappa_c.", 0.0)
    perturb_always_cd: bool = _opt(False, "Hessian Perturbation", "Always perturb c/d blocks.")
    max_inertia_correction_rounds: int = _opt(40, "Hessian Perturbation",
                                              "Static bound on correction loop (TPU-specific).", 1)

    # ---- Hessian approximation (IpLimMemQuasiNewtonUpdater.cpp) ----
    hessian_approximation: str = _opt("exact", "Hessian Approximation", "Exact AD Hessian or L-BFGS.",
                                      choices=("exact", "limited-memory"))
    limited_memory_update_type: str = _opt("bfgs", "Hessian Approximation", "Quasi-Newton formula.",
                                           choices=("bfgs", "sr1"))
    limited_memory_max_history: int = _opt(6, "Hessian Approximation", "L-BFGS history length.", 0)
    limited_memory_max_skipping: int = _opt(2, "Hessian Approximation", "Max skipped updates before reset.", 1)
    limited_memory_init_val: float = _opt(1.0, "Hessian Approximation", "Initial diagonal sigma.", 0.0, lower_strict=True)
    limited_memory_init_val_max: float = _opt(1e8, "Hessian Approximation", "Max sigma.", 0.0, lower_strict=True)
    limited_memory_init_val_min: float = _opt(1e-8, "Hessian Approximation", "Min sigma.", 0.0, lower_strict=True)
    limited_memory_initialization: str = _opt("scalar1", "Hessian Approximation", "Sigma strategy.",
                                              choices=("scalar1", "scalar2", "scalar3", "scalar4", "constant"))
    limited_memory_aug_solver: str = _opt(
        "sherman-morrison", "Hessian Approximation",
        "Low-rank aug-system treatment: Sherman-Morrison-Woodbury on the "
        "diagonal base system (LowRankAugSystemSolver) or dense "
        "materialization (extended-system stand-in).",
        choices=("sherman-morrison", "extended"))

    # ---- Derivative checker (IpTNLPAdapter.cpp:2983) ----
    derivative_test: str = _opt("none", "Derivative Checker", "FD-vs-AD verification mode.",
                                choices=("none", "first-order", "second-order", "only-second-order"))
    derivative_test_perturbation: float = _opt(1e-8, "Derivative Checker", "FD step size.", 0.0, lower_strict=True)
    derivative_test_tol: float = _opt(1e-4, "Derivative Checker", "Relative error threshold.", 0.0, lower_strict=True)

    # ---- Callbacks (token into the registry below; participates in the jit
    #      key so different callbacks compile distinct programs) ----
    callback_token: int = _opt(0, "Output", "internal: intermediate_callback id.", 0)
    custom_kkt_token: int = _opt(0, "Linear Solver", "internal: custom KKT solver id.", 0)
    callback_curr_iterate: bool = _opt(
        False, "Output",
        "Pass curr_iterate / curr_violations dicts to intermediate_callback "
        "(get_curr_iterate/get_curr_violations parity, IpTNLP.hpp:665-793; "
        "adds a per-iteration device->host copy).")

    # ---- Option-parity additions (OPTIONS_PARITY.md; reference defaults) --
    # Output / application (IpIpoptApplication.cpp, IpJournalist)
    print_user_options: bool = _opt(False, "Output", "Print non-default options before solving.")
    print_options_documentation: bool = _opt(False, "Output", "Dump the full options documentation before solving.")
    print_options_mode: str = _opt("text", "Output", "Format of the options documentation dump.",
                                   choices=("text", "latex", "doxygen"))
    print_advanced_options: bool = _opt(False, "Output", "Include advanced options in the documentation dump.")
    print_info_string: bool = _opt(False, "Output", "Append diagnostic info tags to the iteration line.")
    print_frequency_time: float = _opt(0.0, "Output", "Minimum seconds between iteration lines "
                                       "(0 = every print_frequency_iter'th; host-side clocks are "
                                       "unavailable inside jit, so enforced only in chunked mode).", 0.0)
    inf_pr_output: str = _opt("original", "Output", "Which primal infeasibility to show in the iteration line "
                              "(IpOrigIterationOutput.cpp).", choices=("internal", "original"))
    file_append: bool = _opt(False, "Output", "Append to output_file instead of truncating.")
    suppress_all_output: bool = _opt(False, "Output", "Suppress every journal (sb yes analog).")
    debug_print_level: int = _opt(0, "Output", "Verbosity of the debug journal (IPOPT_CHECKLEVEL analog; "
                                  "jax_debug_nans / jax.debug tooling replaces most of it).", 0, 12)
    option_file_name: str = _opt("ipopt.opt", "Output", "Options file read by solve() at startup "
                                 "('' disables; OptionsList::ReadFromStream).")
    skip_finalize_solution_call: bool = _opt(False, "Output", "C API: skip the finalize_solution callback.")
    replace_bounds: bool = _opt(False, "NLP", "Convert variable bounds into inequality constraints "
                                "(NLPBoundsRemover, IpNLPBoundsRemover.hpp:23).")
    # NLP evaluation hints (IpOrigIpoptNLP.hpp:570-578).  Under XLA the whole
    # iteration is one fused program and re-evaluation of affine callables
    # costs nothing extra after CSE, so these are accepted for compatibility.
    grad_f_constant: bool = _opt(False, "NLP", "Hint: objective gradient is constant (accepted; XLA CSE).")
    jac_c_constant: bool = _opt(False, "NLP", "Hint: equality Jacobian is constant (accepted; XLA CSE).")
    jac_d_constant: bool = _opt(False, "NLP", "Hint: inequality Jacobian is constant (accepted; XLA CSE).")
    hessian_constant: bool = _opt(False, "NLP", "Hint: Lagrangian Hessian is constant (accepted; XLA CSE).")
    # Derivative approximation (IpTNLPAdapter.hpp:258-266).  Derivatives come
    # from JAX autodiff (exact by construction); gradient_approximation=
    # finite-difference-values nevertheless switches the objective gradient
    # to vmapped forward differences with findiff_perturbation (useful to
    # reproduce FD-noise behavior of the reference's GradientApproximation).
    gradient_approximation: str = _opt("exact", "NLP", "Objective gradient source.",
                                       choices=("exact", "finite-difference-values"))
    jacobian_approximation: str = _opt("exact", "NLP", "Constraint Jacobian source.",
                                       choices=("exact", "finite-difference-values"))
    findiff_perturbation: float = _opt(1e-7, "NLP", "FD perturbation for the approximation options.",
                                       0.0, lower_strict=True)
    num_linear_variables: int = _opt(0, "NLP", "Number of leading linear variables (L-BFGS hint).", 0)
    # NLP scaling targets (IpGradientScaling.cpp)
    nlp_scaling_obj_target_gradient: float = _opt(0.0, "NLP Scaling",
                                                  "Target max-norm of the scaled objective gradient (0 = cap mode).", 0.0)
    nlp_scaling_constr_target_gradient: float = _opt(0.0, "NLP Scaling",
                                                     "Target max-norm of the scaled constraint gradients (0 = cap mode).", 0.0)
    # Warm start (IpWarmStartIterateInitializer.cpp)
    warm_start_same_structure: bool = _opt(False, "Warm Start", "Reuse the problem structure from the previous solve "
                                           "(the jit compilation cache provides this automatically).")
    warm_start_target_mu: float = _opt(0.0, "Warm Start", "Barrier parameter to re-target on warm start (<=0: off).")
    # Adaptive-mu extras (IpAdaptiveMuUpdate.cpp, IpQualityFunctionMuOracle.cpp)
    adaptive_mu_kkt_norm_type: str = _opt("2-norm-squared", "Barrier", "Norm for the adaptive-mu KKT error.",
                                          choices=("1-norm", "2-norm-squared", "max-norm", "2-norm"))
    adaptive_mu_restore_previous_iterate: bool = _opt(False, "Barrier",
                                                      "Restore the last accepted iterate when entering monotone mode.")
    adaptive_mu_safeguard_factor: float = _opt(0.0, "Barrier", "Safeguard factor for the adaptive-mu globalization.", 0.0)
    filter_margin_fact: float = _opt(1e-5, "Barrier", "Margin width factor for the obj-constr-filter globalization.",
                                     0.0, 1.0, True, True)
    filter_max_margin: float = _opt(1.0, "Barrier", "Maximum margin width for the obj-constr-filter globalization.",
                                    0.0, lower_strict=True)
    quality_function_norm_type: str = _opt("2-norm-squared", "Barrier", "Norm in the quality function.",
                                           choices=("1-norm", "2-norm-squared", "max-norm", "2-norm"))
    quality_function_centrality: str = _opt("none", "Barrier", "Centrality penalty in the quality function.",
                                            choices=("none", "log", "reciprocal", "cubed-reciprocal"))
    quality_function_balancing_term: str = _opt("none", "Barrier", "Balancing term in the quality function.",
                                                choices=("none", "cubic"))
    # Higher-order correctors (IpFilterLSAcceptor.cpp corrector_* options)
    corrector_type: str = _opt("none", "Line Search", "Corrector step type in adaptive-mu mode.",
                               choices=("none", "affine", "primal-dual"))
    corrector_compl_avrg_red_fact: float = _opt(1.0, "Line Search",
                                                "Allowed complementarity increase for accepting a corrector step.",
                                                0.0, lower_strict=True)
    skip_corr_if_neg_curv: bool = _opt(True, "Line Search", "Skip the corrector on negative-curvature iterations.")
    skip_corr_in_monotone_mode: bool = _opt(True, "Line Search", "Skip the corrector in monotone mode.")
    soc_method: int = _opt(0, "Line Search", "SOC variant: 0 = implementation paper, 1 = alpha-scaled x/s rhs.", 0, 1)
    # Restoration extras
    evaluate_orig_obj_at_resto_trial: bool = _opt(True, "Restoration",
                                                  "Evaluate the original objective at restoration trial points.")
    limited_memory_special_for_resto: bool = _opt(False, "Restoration",
                                                  "Dedicated L-BFGS handling inside the restoration phase.")
    # Linear system extras
    linear_scaling_on_demand: bool = _opt(True, "Linear Solver", "Only equilibrate when the solve struggles "
                                          "(the Ruiz pass is cheap under XLA, so scaling follows "
                                          "linear_system_scaling unconditionally).")
    # Inexact algorithm extras (src/Algorithm/Inexact/)
    inexact_step_decomposition: str = _opt("adaptive", "Inexact", "Normal/tangential step decomposition policy.",
                                           choices=("always", "adaptive", "switch-once"))
    inexact_decomposition_activate_tol: float = _opt(1e-3, "Inexact", "Stepsize threshold activating decomposition.",
                                                     0.0, 1.0, True, False)
    inexact_decomposition_inactivate_tol: float = _opt(1e-3, "Inexact", "Stepsize threshold deactivating decomposition.",
                                                       0.0, 1.0, True, False)
    inexact_normal_tol: float = _opt(1e-3, "Inexact", "Relative residual tol of the normal-step Krylov solve.",
                                     0.0, lower_strict=True)
    inexact_normal_max_iter: int = _opt(200, "Inexact", "Max Krylov iterations for the normal step.", 0)
    inexact_regularization_ls_count_trigger: int = _opt(1, "Inexact",
                                                        "Previous-iteration LS count triggering Hessian regularization.", 1)
    inexact_linear_system_scaling: str = _opt("slack-based", "Inexact", "Scaling of the inexact KKT system.",
                                              choices=("none", "slack-based"))
    modify_hessian_with_slacks: bool = _opt(False, "Inexact", "Regularize with slacks^-2 instead of identity.")
    slack_scale_max: float = _opt(1.0, "Inexact", "Upper bound on slack-based scaling parameters.",
                                  0.0, lower_strict=True)
    # CG-penalty extras (src/contrib/CGPenalty/)
    theta_min: float = _opt(1e-6, "CG Penalty", "Piecewise-penalty theta threshold.", 0.0, lower_strict=True)
    mult_diverg_feasibility_tol: float = _opt(1e-7, "CG Penalty", "Feasibility tol for multiplier-divergence test.",
                                              0.0, lower_strict=True)
    mult_diverg_y_tol: float = _opt(1e8, "CG Penalty", "Multiplier-divergence threshold.", 0.0, lower_strict=True)
    pen_init_fac: float = _opt(50.0, "CG Penalty", "Initial penalty factor for the regularized Newton method.",
                               0.0, lower_strict=True)
    # sIPOPT (contrib/sIPOPT/src/SensApplication.cpp:58-100)
    run_sens: bool = _opt(False, "sIPOPT", "Run the sIPOPT sensitivity "
                          "algorithm after the solve (AMPL sens_* suffixes).")
    n_sens_steps: int = _opt(1, "sIPOPT", "Number of sensitivity steps.", 0)
    sens_boundcheck: bool = _opt(False, "sIPOPT", "Re-solve the Schur "
                                 "decomposition when the predicted point "
                                 "violates bounds.")
    sens_bound_eps: float = _opt(1e-3, "sIPOPT", "Bound accuracy within "
                                 "which a bound is still considered valid.",
                                 0.0, lower_strict=True)
    compute_red_hessian: bool = _opt(False, "sIPOPT", "Compute the reduced "
                                     "Hessian on the red_hessian-suffixed "
                                     "variables.")
    # Derivative checker extras (IpTNLPAdapter.cpp:179-211)
    derivative_test_first_index: int = _opt(-2, "Derivative Checker", "First variable index to check (-2 = all).", -2)
    derivative_test_print_all: bool = _opt(False, "Derivative Checker", "Print all comparisons, not just failures.")
    point_perturbation_radius: float = _opt(10.0, "Derivative Checker", "Random perturbation radius for the test point.", 0.0)
    hessian_approximation_space: str = _opt("nonlinear-variables", "Hessian Approximation",
                                            "Variables the L-BFGS approximation acts on.",
                                            choices=("nonlinear-variables", "all-variables"))

    # ---- TPU-specific ----
    dtype: str = _opt("float64", "TPU", "Compute dtype for the IPM core.",
                      choices=("float32", "float64"))
    factorization_dtype: str = _opt("", "TPU", "Dtype for KKT factorization ('' = same as dtype).",
                                    choices=("", "float32", "float64"))
    refinement_precision: str = _opt("same", "TPU",
                                     "Residual precision in iterative "
                                     "refinement: 'double' accumulates the "
                                     "solution and computes residuals in "
                                     "float64 so an f32 factorization "
                                     "reaches ~1e-7 tolerances "
                                     "(IpPDFullSpaceSolver.cpp:235-345; "
                                     "double-build tol 1e-8, "
                                     "IpIpoptData.cpp:27-38).",
                                     choices=("same", "double"))
    kkt_block_size: int = _opt(128, "TPU", "Block size for blocked/Pallas factorizations.", 8)
    use_pallas: bool = _opt(True, "TPU", "Use Pallas kernels where available "
                            "(auto-disabled off-TPU).")
    resto_phase: bool = _opt(True, "TPU", "Trace the restoration-phase "
                             "fallback into the program.  Disabling halves "
                             "compile size/time for huge structured problems "
                             "whose feasible path never needs restoration "
                             "(line-search failure then reports "
                             "RESTORATION_FAILURE, as when resto fails).")

    # ------------------------------------------------------------------
    def __post_init__(self):
        for f in fields(self):
            spec = spec_of(f.name)
            spec.validate(getattr(self, f.name))

    def replace(self, **kwargs) -> "Options":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Options":
        return cls().replace(**d)

    def with_prefix_overrides(self, prefix_values: Dict[str, Any]) -> "Options":
        """Apply e.g. {'resto.max_iter': 50} style scoped overrides."""
        plain = {k.split(".", 1)[1]: v for k, v in prefix_values.items()}
        return self.replace(**plain)

    # Restoration-phase defaults, mirroring IpAlgBuilder.cpp:858-1043 where the
    # resto sub-algorithm gets its own OptionsList with the "resto." prefix and
    # altered defaults (resto.constr_mult_init_max=0 etc.).
    def resto_options(self) -> "Options":
        overrides = dict(
            constr_mult_init_max=0.0,
            expect_infeasible_problem=False,
            nlp_scaling_method="none",
            # the feasibility sub-problem never needs the f64 critical path
            # (its exit tolerances are coarse); keeping it in the model
            # dtype also keeps the nested carry homogeneous
            refinement_precision="same",
        )
        if (self.limited_memory_special_for_resto
                and self.hessian_approximation == "limited-memory"):
            # limited_memory_special_for_resto
            # (IpLimMemQuasiNewtonUpdater.cpp:136-147): approximate only the
            # ORIGINAL part of the resto Lagrangian Hessian with a plain
            # scalar-initialized L-BFGS (fresh memory, no damping carryover)
            overrides["limited_memory_initialization"] = "constant"
            overrides["limited_memory_init_val"] = 1.0
        # The CG penalty acceptor never runs a restoration phase of its own
        # (CGPenaltyLSAcceptor::NeverRestorationPhase); the nested resto
        # algorithm always uses the filter search.
        if self.line_search_method == "cg-penalty":
            overrides["line_search_method"] = "filter"
        return self.replace(**overrides)


def spec_of(name: str) -> OptionSpec:
    if not _REGISTRY:
        for f in fields(Options):
            md = f.metadata
            _REGISTRY[f.name] = OptionSpec(
                name=f.name, default=f.default, category=md["category"],
                doc=md["doc"], lower=md["lower"], upper=md["upper"],
                lower_strict=md["lower_strict"], upper_strict=md["upper_strict"],
                choices=md["choices"])
    return _REGISTRY[name]


def all_specs() -> Dict[str, OptionSpec]:
    spec_of("tol")  # populate
    return dict(_REGISTRY)


def print_options_documentation(mode: str = "text",
                                advanced: bool = False) -> str:
    """Mirrors Ipopt's print_options_documentation (IpRegOptions dump).

    ``mode`` follows print_options_mode ("text" | "latex" | "doxygen",
    RegisteredOptions::OutputLatex/OutputDoxygen); ``advanced`` follows
    print_advanced_options (include the registration internals — bounds
    strictness and value types — beyond the user-facing summary)."""
    by_cat: Dict[str, list] = {}
    for spec in all_specs().values():
        by_cat.setdefault(spec.category, []).append(spec)
    lines = []

    def _rng(spec):
        if spec.choices:
            return f" one of {spec.choices}"
        if spec.lower is not None or spec.upper is not None:
            lo = "(" if spec.lower_strict else "["
            hi = ")" if spec.upper_strict else "]"
            return f" range {lo}{spec.lower}, {spec.upper}{hi}"
        return ""

    for cat in sorted(by_cat):
        if mode == "latex":
            lines.append(f"\n\\subsection{{{cat}}}\n")
        elif mode == "doxygen":
            lines.append(f"\n\\subpage {cat.replace(' ', '_')} {cat}\n")
        else:
            lines.append(f"\n### {cat}\n")
        for spec in sorted(by_cat[cat], key=lambda s: s.name):
            if mode == "latex":
                lines.append(
                    f"\\paragraph{{{spec.name}}} (default "
                    f"\\texttt{{{spec.default!r}}}){_rng(spec)}\\\\\n"
                    f"{spec.doc}")
            elif mode == "doxygen":
                lines.append(f"- \\b {spec.name} (default {spec.default!r})"
                             f"{_rng(spec)}: {spec.doc}")
            else:
                lines.append(f"{spec.name} (default {spec.default!r})"
                             f"{_rng(spec)}\n    {spec.doc}")
            if advanced:
                lines.append(
                    f"    [type {type(spec.default).__name__};"
                    f" lower_strict={spec.lower_strict}"
                    f" upper_strict={spec.upper_strict}]")
    return "\n".join(lines)


def parse_options_file(text: str) -> Dict[str, Any]:
    """Parse an ``ipopt.opt``-style file (OptionsList::ReadFromStream,
    IpOptionsList.hpp:341): '# comment' lines, 'name value' pairs."""
    out: Dict[str, Any] = {}
    specs = all_specs()
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise ValueError(f"cannot parse option line: {raw!r}")
        name, sval = parts[0], parts[1].strip()
        base = name.split(".", 1)[-1]
        if base not in specs:
            raise ValueError(f"unknown option: {name}")
        spec = specs[base]
        if spec.choices is not None:
            out[name] = sval
        elif isinstance(spec.default, bool):
            out[name] = sval.lower() in ("yes", "true", "1")
        elif isinstance(spec.default, int) and not isinstance(spec.default, bool):
            out[name] = int(sval)
        else:
            out[name] = float(sval)
    return out


# Registry for intermediate callbacks: Options stays hashable (the token is a
# plain int field) while the callable lives here (IpTNLP::intermediate_callback
# equivalent).
CALLBACK_REGISTRY: Dict[int, Any] = {}


def register_callback(fn) -> int:
    token = id(fn)
    CALLBACK_REGISTRY[token] = fn
    return token


# User-pluggable KKT solver hook (GenKKTSolverInterface /
# GenAugSystemSolver parity, src/Algorithm/LinearSolvers/
# IpGenKKTSolverInterface.hpp, IpGenAugSystemSolver.hpp): an object with
#   factorize(nlp, opts, it, ev, W, mu, delta_w_last) -> FactorResult-like
#   solve(nlp, opts, fac, K, parts) -> ((dx, ds, dy_c, dy_d), resid_ratio)
# selected by linear_solver="custom"; both callables must be jax-traceable.
CUSTOM_KKT_REGISTRY: Dict[int, Any] = {}


def register_custom_kkt(solver) -> int:
    token = id(solver)
    CUSTOM_KKT_REGISTRY[token] = solver
    return token
