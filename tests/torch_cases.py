"""The solves that the port's parity tests hold against the reference's
recorded results: each case names a problem, built by either package, and
its options.  ``tools/torch_reference_values.py`` solves every case with
the JAX reference (float64, CPU) and writes the results to
``tests/torch_reference_values.json``; ``tests/test_torch_adaptive.py``,
``test_torch_options.py`` and ``test_torch_suites.py`` solve the same cases
with the port and compare.  A case with ``warm`` starts from the iterate of
the case it names, solved by the same package.

This module imports neither package at its top, so that the tool can load
it with the reference alone.
"""
import numpy as np

# Lanes of the HS071 family (modellib.hs071_family(0.005 * lane)) whose
# limited-memory solve ends one iteration apart under a 1e-15 relative
# perturbation of the SMW matrix
FAMILY_LBFGS_SENSITIVE = (286, 287, 294)
BENCH = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10)
WARM = dict(warm_start_init_point=True, mu_init=1e-6, bound_mult_init_val=1e-3)
ADAPTIVE = dict(mu_strategy="adaptive")
MEHROTRA = dict(mehrotra_algorithm=True)

# The robustness set of tests/problems.py:289 and two HS problems, as
# (f, g, bounds) in the functions of either package: ``m`` is the module
# (jax.numpy or torch) and ``arr`` builds a 1-D array of it.
HS_SPECS = {
    "hs002": lambda m, arr: dict(
        f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
        x_L=np.array([-np.inf, 1.5]), x0=np.array([-2.0, 1.0])),
    "hs003": lambda m, arr: dict(
        f=lambda x: x[1] + 1e-5 * (x[1] - x[0]) ** 2,
        x_L=np.array([-np.inf, 0.0]), x0=np.array([10.0, 1.0])),
    "hs004": lambda m, arr: dict(
        f=lambda x: (x[0] + 1.0) ** 3 / 3.0 + x[1],
        x_L=np.array([1.0, 0.0]), x0=np.array([1.125, 0.15])),
    "hs005": lambda m, arr: dict(
        f=lambda x: (m.sin(x[0] + x[1]) + (x[0] - x[1]) ** 2
                     - 1.5 * x[0] + 2.5 * x[1] + 1.0),
        x_L=np.array([-1.5, -3.0]), x_U=np.array([4.0, 3.0]),
        x0=np.array([0.0, 0.0])),
    "hs010": lambda m, arr: dict(
        f=lambda x: x[0] - x[1],
        g=lambda x: arr([-3.0 * x[0] ** 2 + 2.0 * x[0] * x[1] - x[1] ** 2 + 1.0]),
        g_L=np.array([0.0]), g_U=np.array([np.inf]), x0=np.array([-10.0, 10.0])),
    "hs011": lambda m, arr: dict(
        f=lambda x: (x[0] - 5.0) ** 2 + x[1] ** 2 - 25.0,
        g=lambda x: arr([-x[0] ** 2 + x[1]]),
        g_L=np.array([0.0]), g_U=np.array([np.inf]), x0=np.array([4.9, 0.1])),
    "hs014": lambda m, arr: dict(
        f=lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
        g=lambda x: arr([x[0] - 2.0 * x[1] + 1.0,
                         -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0]),
        g_L=np.array([0.0, 0.0]), g_U=np.array([0.0, np.inf]),
        x0=np.array([2.0, 2.0])),
    "hs033": lambda m, arr: dict(
        f=lambda x: (x[0] - 1.0) * (x[0] - 2.0) * (x[0] - 3.0) + x[2],
        g=lambda x: arr([x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
                         x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0]),
        g_L=np.array([0.0, 0.0]), g_U=np.array([np.inf, np.inf]),
        x_L=0.0, x_U=np.array([np.inf, np.inf, 5.0]), x0=np.array([0.0, 0.0, 3.0])),
    "hs048": lambda m, arr: dict(
        f=lambda x: (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2,
        g=lambda x: arr([x[0] + x[1] + x[2] + x[3] + x[4] - 5.0,
                         x[2] - 2.0 * (x[3] + x[4]) + 3.0]),
        g_L=np.zeros(2), g_U=np.zeros(2), x0=np.array([3.0, 5.0, -3.0, 2.0, -2.0])),
    "hs110": lambda m, arr: dict(
        f=lambda x: (m.sum(m.log(x - 2.0) ** 2 + m.log(10.0 - x) ** 2)
                     - m.prod(x) ** 0.2),
        x_L=2.001, x_U=9.999, x0=np.full(10, 9.0)),
    "hs035": lambda m, arr: dict(
        f=lambda x: (9.0 - 8 * x[0] - 6 * x[1] - 4 * x[2] + 2 * x[0] ** 2
                     + 2 * x[1] ** 2 + x[2] ** 2 + 2 * x[0] * x[1]
                     + 2 * x[0] * x[2]),
        g=lambda x: arr([3.0 - x[0] - x[1] - 2 * x[2]]),
        g_L=np.array([0.0]), g_U=np.array([np.inf]), x_L=0.0,
        x0=np.array([0.5, 0.5, 0.5])),
    # Rosenbrock from the classic start (tests/test_wired_options.py:27)
    "rosenbrock": lambda m, arr: dict(
        f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
        x0=np.array([-1.2, 1.0])),
    # with one active equality (test_wired_options.py:95)
    "rosenbrock_eq": lambda m, arr: dict(
        f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
        g=lambda x: arr([x[0] + x[1]]), g_L=np.array([0.5]), g_U=np.array([0.5]),
        x0=np.array([-1.2, 1.0])),
    # infeasible: x in [0, 1]^2 but x1 + x2 = 5 (test_wired_options.py:68)
    "infeasible": lambda m, arr: dict(
        f=lambda x: m.sum(x ** 2), g=lambda x: arr([x[0] + x[1]]),
        g_L=np.array([5.0]), g_U=np.array([5.0]), x_L=0.0, x_U=1.0,
        x0=np.array([0.5, 0.5])),
    # the constant-derivative problems of test_wired_options.py:380-425
    "linear_obj": lambda m, arr: dict(
        f=lambda x: 2.0 * x[0] + 3.0 * x[1],
        g=lambda x: arr([x[0] ** 2 + x[1] ** 2]), g_L=np.array([1.0]),
        g_U=np.array([1.0]), x0=np.array([0.5, 0.5])),
    "linear_eq": lambda m, arr: dict(
        f=lambda x: (x[0] - 1.0) ** 4 + (x[1] + 2.0) ** 2,
        g=lambda x: arr([x[0] + 2.0 * x[1]]), g_L=np.array([3.0]),
        g_U=np.array([3.0]), x0=np.array([0.0, 0.0])),
    "qp": lambda m, arr: dict(
        f=lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + x[0] * x[1] - 4.0 * x[0],
        g=lambda x: arr([x[0] + x[1]]), g_L=np.array([1.0]),
        g_U=np.array([2e19]), x0=np.array([2.0, 2.0])),
    # a Jacobian that blows up at x = 0 (test_wired_options.py:497)
    "sqrt_row": lambda m, arr: dict(
        f=lambda x: m.sum((x - 2.0) ** 2), g=lambda x: arr([m.sqrt(x[0])]),
        x_L=np.array([-5.0]), x_U=np.array([5.0]), g_L=np.array([-10.0]),
        g_U=np.array([10.0]), x0=np.array([1.0])),
    # hs048 with its first row twice: one dependent equality
    "hs048_dup": lambda m, arr: dict(
        f=lambda x: (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2,
        g=lambda x: arr([x[0] + x[1] + x[2] + x[3] + x[4] - 5.0,
                         x[2] - 2.0 * (x[3] + x[4]) + 3.0,
                         2.0 * (x[0] + x[1] + x[2] + x[3] + x[4] - 5.0)]),
        g_L=np.zeros(3), g_U=np.zeros(3), x0=np.array([3.0, 5.0, -3.0, 2.0, -2.0])),
    # HS071 with its equality moved to 40 + d (test_warmstart_derivcheck.py:11)
    "hs071_d0": lambda m, arr: _hs071_spec(m, arr, 0.0),
    "hs071_d001": lambda m, arr: _hs071_spec(m, arr, 0.01),
    # HS071 with starting multipliers for a warm start from them
    "hs071_y0": lambda m, arr: dict(
        _hs071_spec(m, arr, 0.0), y0=np.array([-0.55, 0.16]),
        z_L0=np.array([1.09, 0.0, 0.0, 0.0]), z_U0=np.zeros(4)),
}


# the flat twin of the scenario problem stochastic_qp (tests/test_scenario.py:41)
HS_SPECS["stoch_qp_flat"] = lambda m, arr: _stoch_qp_flat(m, arr)
# Colville, bounds only (tests/problems.py:82), and the problem whose first
# variable is linear (test_wired_options.py:586-602)
HS_SPECS["hs038"] = lambda m, arr: dict(
    f=lambda x: (100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
                 + 90 * (x[3] - x[2] ** 2) ** 2 + (1 - x[2]) ** 2
                 + 10.1 * ((x[1] - 1) ** 2 + (x[3] - 1) ** 2)
                 + 19.8 * (x[1] - 1) * (x[3] - 1)),
    x_L=-10.0, x_U=10.0, x0=np.array([-3.0, -1.0, -3.0, -1.0]))
HS_SPECS["linear_x0"] = lambda m, arr: dict(
    f=lambda x: x[0] + (x[1] - 1.0) ** 4, x_L=np.array([0.0, -5.0]),
    x_U=np.array([5.0, 5.0]), x0=np.array([2.0, 2.0]))


def _stoch_qp_data(S, ns, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((S, ns)), rng.standard_normal((S, 1))


def _stoch_qp_flat(m, arr, S=4, ns=3, seed=0):
    t, b = (m.asarray(v) for v in _stoch_qp_data(S, ns, seed))
    n0 = 2

    def f(x):
        return 0.5 * m.sum(x[:n0] ** 2) + 0.5 * m.sum((x[n0:].reshape(S, ns) - t) ** 2)

    def g(x):
        return x[0] + x[n0:].reshape(S, ns).sum(1) - b[:, 0]

    return dict(f=f, g=g, x0=np.zeros(n0 + S * ns), g_L=np.zeros(S), g_U=np.zeros(S),
                x_L=np.concatenate([np.full(n0, -np.inf), np.full(S * ns, -5.0)]))


# Scenario problems (ScenarioNLP keyword arguments), in the functions of
# either package: the two-stage stochastic QP of tests/test_scenario.py:11
# and the inconsistent scenario equalities of tests/test_arrow_resto.py:34.
SCENARIO_SPECS = {
    "stoch_qp": lambda m, arr, S=4, ns=3, seed=0: dict(
        f_scen=lambda x0, xs, th: 0.5 * m.sum((xs - th["t"]) ** 2),
        g_scen=lambda x0, xs, th: arr([x0[0] + m.sum(xs)]) - th["b"],
        f0=lambda x0: 0.5 * m.sum(x0 ** 2),
        x0_init=np.zeros(2), xs_init=np.zeros((S, ns)),
        g_L=np.zeros((S, 1)), g_U=np.zeros((S, 1)), xs_L=-5.0,
        theta=dict(zip(("t", "b"), _stoch_qp_data(S, ns, seed))), name="stoch_qp"),
    # equality and inequality rows, x0 coupled into the scenario Hessians
    "scen_mixed": lambda m, arr, S=4, ns=3, seed=1: dict(
        f_scen=lambda x0, xs, th: (0.5 * m.sum((xs - th["t"]) ** 2)
                                   + 0.1 * x0[1] * m.sum(xs ** 2)),
        g_scen=lambda x0, xs, th: arr([x0[0] + m.sum(xs) - th["b"][0],
                                       xs[0] * xs[1] + x0[1]]),
        f0=lambda x0: 0.5 * m.sum(x0 ** 2),
        x0_init=np.array([0.5, 0.5]), xs_init=np.full((S, ns), 0.5),
        g_L=np.array([0.0, -1.0]), g_U=np.array([0.0, np.inf]),
        x0_L=np.array([-np.inf, 0.0]), xs_L=-5.0,
        theta=dict(zip(("t", "b"), _stoch_qp_data(S, ns, seed)))),
    "scen_infeasible": lambda m, arr, S=4, ns=3: dict(
        f_scen=lambda x0, xs, th: 0.5 * m.sum(xs ** 2),
        g_scen=lambda x0, xs, th: arr([xs[0] - 1.0, xs[0] + 1.0]),
        x0_init=np.zeros(1), xs_init=np.zeros((S, ns)),
        g_L=np.zeros((S, 2)), g_U=np.zeros((S, 2))),
}


# lanes 0, 255 and 511 of the 512-instance HS071 family (bench.py:121-133),
# and the lanes whose L-BFGS solve moves by one iteration with the rounding
# (tests/test_torch_lbfgs.py::test_family_lanes_are_rounding_sensitive)
for _i in (0, 255, 511) + FAMILY_LBFGS_SENSITIVE:
    HS_SPECS[f"hs071_fam{_i}"] = (lambda m, arr, d=0.005 * _i:
                                  _hs071_spec(m, arr, d))


def _hs071_spec(m, arr, d):
    return dict(f=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
                g=lambda x: arr([x[0] * x[1] * x[2] * x[3],
                                 x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2]),
                x_L=1.0, x_U=5.0, g_L=np.array([25.0, 40.0 + d]),
                g_U=np.array([2e19, 40.0 + d]), x0=np.array([1.0, 5.0, 5.0, 1.0]))


def build(problem, pkg: str):
    """The problem ``problem`` built by ``pkg`` ("ref" or "port"): a key of
    HS_SPECS, a ("scenario", key of SCENARIO_SPECS, args) triple, or a
    (modellib function, args) pair."""
    if pkg == "ref":
        import jax.numpy as m
        import ipopt_tpu as P
        arr = m.array
    else:
        import torch as m
        import ipopt_torch as P
        arr = m.stack
    if isinstance(problem, str):
        return P.NLP(name=problem, **HS_SPECS[problem](m, arr))
    if problem[0] == "scenario":
        return P.ScenarioNLP(**SCENARIO_SPECS[problem[1]](m, arr, *problem[2]))
    fn, args = problem
    return getattr(P.modellib, fn)(*args)


def _c(problem, opts=None, warm=None, suite="options", **flags):
    return dict(problem=problem, opts=dict(opts or {}), warm=warm, suite=suite,
                **flags)


CASES = {}
# -- adaptive mu (tests/test_adaptive_mu.py, test_wired_options.py) --------
for _name, _opts in {
        "hs071_probing": dict(ADAPTIVE, mu_oracle="probing"),
        "hs071_loqo": dict(ADAPTIVE, mu_oracle="loqo"),
        "hs071_glob_kkt_error": dict(ADAPTIVE, adaptive_mu_globalization="kkt-error"),
        "hs071_glob_never": dict(ADAPTIVE,
                                 adaptive_mu_globalization="never-monotone-mode"),
        "hs071_mehrotra": MEHROTRA,
        "hs071_mehrotra_full_steps": dict(MEHROTRA, accept_every_trial_step=True),
        "hs071_corr_primal_dual": dict(MEHROTRA, corrector_type="primal-dual"),
        "hs071_corr_monotone": dict(corrector_type="affine",
                                    skip_corr_in_monotone_mode=False),
        "hs071_qf_1norm": dict(ADAPTIVE, quality_function_norm_type="1-norm"),
        "hs071_qf_max_log": dict(ADAPTIVE, quality_function_norm_type="max-norm",
                                 quality_function_centrality="log"),
        "hs071_qf_2norm_recip_cubic": dict(
            ADAPTIVE, quality_function_norm_type="2-norm",
            quality_function_centrality="reciprocal",
            quality_function_balancing_term="cubic"),
        "hs071_qf_cubed_recip": dict(ADAPTIVE,
                                     quality_function_centrality="cubed-reciprocal"),
        "hs071_qf_sigma_tol": dict(ADAPTIVE, quality_function_section_sigma_tol=0.9),
        "hs071_safeguard": dict(ADAPTIVE, adaptive_mu_safeguard_factor=0.01),
        "hs071_mu_max_fact": dict(ADAPTIVE, mu_max_fact=1e-3),
        "hs071_mu_max": dict(ADAPTIVE, mu_max=10.0),
        "hs071_fixed_oracle_probing": dict(ADAPTIVE, fixed_mu_oracle="probing",
                                           adaptive_mu_globalization="kkt-error"),
        "hs071_kkt_1norm_restore": dict(
            ADAPTIVE, adaptive_mu_globalization="kkt-error",
            adaptive_mu_kkt_norm_type="1-norm",
            adaptive_mu_restore_previous_iterate=True),
        "hs071_kkt_max_norm": dict(ADAPTIVE, adaptive_mu_kkt_norm_type="max-norm"),
}.items():
    CASES[_name] = _c("hs071_d0", _opts, suite="adaptive")
CASES["hs035_adaptive"] = _c("hs035", ADAPTIVE, suite="adaptive")
# the lanes that chip_smoke.py holds against the reference (phase E1)
for _i in (0, 255, 511):
    CASES[f"fam{_i}_adaptive"] = _c(f"hs071_fam{_i}", dict(BENCH, **ADAPTIVE),
                                    suite="adaptive")
    CASES[f"fam{_i}_mehrotra"] = _c(f"hs071_fam{_i}", dict(BENCH, **MEHROTRA),
                                    suite="adaptive")
# chip_smoke.py's phase E2 (too long for the CPU test run)
CASES["lv1_4096_adaptive"] = _c(("luksan_vlcek1", (4096, 32)),
                                dict(BENCH, **ADAPTIVE), suite="chip")
CASES["hs014_adaptive"] = _c("hs014", ADAPTIVE, suite="adaptive")
CASES["infeasible_adaptive"] = _c("infeasible", ADAPTIVE, suite="adaptive")
# The boundary control's trajectories are chaotic: a change of 1e-15 in x0
# changes the iteration count of either package (test_torch_suites.py shows
# it for the port), so these cases hold status and objective only (rtol 1e-7)
CASES["mitt10_adaptive"] = _c(("mittelmann_bndry_control", (10, 1)),
                              dict(BENCH, **ADAPTIVE), suite="adaptive", chaotic=True)

# -- warm starts (test_warmstart_derivcheck.py:19-31) ----------------------
CASES["hs071_cold_d0"] = _c("hs071_d0")
CASES["hs071_cold_d001"] = _c("hs071_d001")
CASES["hs071_warm_d001"] = _c("hs071_d001", WARM, warm="hs071_cold_d0")
CASES["hs071_warm_target_mu"] = _c("hs071_d001", dict(WARM, warm_start_target_mu=1e-4),
                                   warm="hs071_cold_d0")
CASES["hs071_warm_entire"] = _c("hs071_d001", dict(WARM, warm_start_entire_iterate=True),
                                warm="hs071_cold_d0")
CASES["hs071_y0"] = _c("hs071_y0", WARM)
CASES["mitt10_ex1"] = _c(("mittelmann_bndry_control", (10, 1)), suite="suites",
                         chaotic=True, record_iterate=True)
CASES["mitt10_ex3"] = _c(("mittelmann_bndry_control", (10, 3)), suite="suites",
                         chaotic=True)
# from the reference's final iterate of example 1 (recorded), in both
# packages; chaotic too (1e-15 in that iterate changes the port's count)
CASES["mitt10_ex3_warm"] = _c(("mittelmann_bndry_control", (10, 3)), WARM,
                              warm="mitt10_ex1", chaotic=True)

# -- the other options (test_wired_options.py, test_termination.py) --------
for _name, (_prob, _opts) in {
        "counters": ("hs071_d0", dict(tol=1e-8)),
        "wall_generous": ("hs071_d0", dict(tol=1e-8, max_wall_time=3600.0)),
        "magic_steps": ("hs071_d0", dict(magic_steps=True)),
        "magic_steps_hs014": ("hs014", dict(magic_steps=True)),
        "recalc_y": ("rosenbrock_eq", dict(tol=1e-8, recalc_y=True,
                                           recalc_y_feas_tol=1e-1)),
        "expect_infeasible": ("infeasible", dict(expect_infeasible_problem=True,
                                                 expect_infeasible_problem_ytol=1e-8)),
        "expect_infeasible_feasible": ("hs071_d0", dict(expect_infeasible_problem=True)),
        "start_with_resto": ("hs071_d0", dict(tol=1e-8, start_with_resto=True)),
        "accept_after_max_steps": ("rosenbrock", dict(tol=1e-8,
                                                      accept_after_max_steps=0)),
        "accept_every_trial_step": ("hs071_d0", dict(accept_every_trial_step=True)),
        "soc_method_1": ("hs014", dict(soc_method=1)),
        "soc_method_1_hs010": ("hs010", dict(soc_method=1)),
        "ls_init_primal": ("hs071_d0", dict(tol=1e-8, least_square_init_primal=True)),
        "ls_init_duals": ("hs071_d0", dict(tol=1e-8, least_square_init_duals=True)),
        "mult_init_mu_based": ("hs071_d0", dict(bound_mult_init_method="mu-based")),
        "equilibration": ("hs071_d0", dict(nlp_scaling_method="equilibration-based")),
        "user_scaling": ("hs071_d0", dict(nlp_scaling_method="user-scaling",
                                          obj_scaling_factor=0.5)),
        "grad_f_constant": ("linear_obj", dict(tol=1e-8, grad_f_constant=True)),
        "jac_c_constant": ("linear_eq", dict(tol=1e-8, jac_c_constant=True)),
        "hessian_constant": ("qp", dict(tol=1e-8, hessian_constant=True)),
        "slow_monotone": ("hs071_d0", dict(tol=1e-8,
                                           mu_allow_fast_monotone_decrease=False)),
        "fast_step": ("hs071_d0", dict(fast_step_computation=True)),
        "naninf_check": ("sqrt_row", dict(max_iter=50, check_derivatives_for_naninf=True,
                                          bound_relax_factor=0.0)),
        "honor_bounds": ("hs071_d0", dict(honor_original_bounds=True)),
        "replace_bounds": ("hs071_d0", dict(replace_bounds=True)),
        "dependency": ("hs048_dup", dict(dependency_detector="mumps")),
}.items():
    CASES[_name] = _c(_prob, _opts)

# -- slice F: the scenario (block-arrow) backend and limited-memory Hessians
#    (tests/test_scenario.py, test_arrow_resto.py, test_lbfgs.py,
#    test_structured_combos.py:31-61, test_wired_options.py:148-207, 574-602)
LBFGS = dict(hessian_approximation="limited-memory")
for _name, (_prob, _opts) in {
        "scen_qp": (("scenario", "stoch_qp", ()), {}),
        "scen_mixed": (("scenario", "scen_mixed", ()), {}),
        "scen_mixed_lbfgs_sr1": (("scenario", "scen_mixed", ()), dict(
            LBFGS, limited_memory_update_type="sr1", max_iter=300)),
        "scen_qp_flat": ("stoch_qp_flat", {}),
        "scen_qp_lbfgs": (("scenario", "stoch_qp", ()), dict(LBFGS, tol=1e-6,
                                                             max_iter=300)),
        "scen_infeasible": (("scenario", "scen_infeasible", ()), dict(tol=1e-8)),
        "scen_infeasible_lbfgs": (("scenario", "scen_infeasible", ()),
                                  dict(LBFGS, tol=1e-8)),
        "hs071_lbfgs": ("hs071_d0", dict(LBFGS, max_iter=300)),
        "hs071_lbfgs_extended": ("hs071_d0", dict(LBFGS, max_iter=300,
                                                  limited_memory_aug_solver="extended")),
        "hs038_lbfgs": ("hs038", dict(LBFGS, max_iter=500)),
        "hs035_lbfgs": ("hs035", dict(LBFGS, max_iter=300)),
        "lv1_64_lbfgs": (("luksan_vlcek1", (64, 4)), dict(LBFGS, tol=1e-6,
                                                          max_iter=300)),

        "rosenbrock_lbfgs": ("rosenbrock", dict(LBFGS, tol=1e-6)),
        "hs071_lbfgs_sr1": ("hs071_d0", dict(LBFGS, max_iter=300,
                                             limited_memory_update_type="sr1")),
        "masked_qn": ("linear_x0", dict(LBFGS, tol=1e-6, num_linear_variables=1,
                                        limited_memory_aug_solver="extended")),
        "infeasible_lbfgs": ("infeasible", dict(LBFGS, max_iter=100)),
        "hs071_lbfgs_special_resto": ("hs071_d0", dict(
            LBFGS, tol=1e-8, start_with_resto=True,
            limited_memory_special_for_resto=True)),
}.items():
    CASES[_name] = _c(_prob, _opts, suite="arrow" if _name.startswith("scen")
                      else "lbfgs")
# its objective is 1.8e-11 at tol 1e-6: held to 1e-12 absolute
CASES["lv5_64_lbfgs_banded"] = _c(("luksan_vlcek5", (64,)), dict(
    LBFGS, tol=1e-6, max_iter=300, linear_solver="banded-bcr"), suite="lbfgs",
    obj_atol=1e-12)
# F4's CPU sizes of chip_smoke.py (hessian_approximation="limited-memory",
# tol 1e-6, max_iter 300): the chained and the banded L-BFGS solves
CASES["lv1_256_lbfgs"] = _c(("luksan_vlcek1", (256, 32)), dict(
    LBFGS, tol=1e-6, max_iter=300), suite="lbfgs_f4")
CASES["lv1flat_2000_lbfgs_banded"] = _c(("luksan_vlcek1_flat", (2000,)), dict(
    LBFGS, tol=1e-6, max_iter=300, linear_solver="banded-bcr"), suite="lbfgs_f4")
# and F4's full sizes, recorded for chip_smoke.py F4 (too slow for the CPU
# tests): both end near objective 0, another local solution than 6.23
CASES["lv1_4096_lbfgs"] = _c(("luksan_vlcek1", (4096, 32)), dict(
    LBFGS, tol=1e-6, max_iter=300), suite="lbfgs_full")
CASES["lv1flat_1e5_lbfgs_banded"] = _c(("luksan_vlcek1_flat", (100_000,)), dict(
    LBFGS, tol=1e-6, max_iter=300, linear_solver="banded-bcr"), suite="lbfgs_full")
for _i in FAMILY_LBFGS_SENSITIVE:
    CASES[f"hs071_fam{_i}_lbfgs"] = _c(f"hs071_fam{_i}", dict(LBFGS, max_iter=300),
                                       suite="lbfgs_sensitive")
for _strat in ("scalar2", "scalar3", "scalar4", "constant"):
    CASES[f"hs071_lbfgs_{_strat}"] = _c(
        "hs071_d0", dict(LBFGS, max_iter=300, limited_memory_initialization=_strat,
                         limited_memory_init_val=2.5), suite="lbfgs")

# -- the problem suites (tests/problems.py:289, test_robustness_suite.py,
#    test_scalable_suite.py) ---------------------------------------------
for _hs in ("hs002", "hs003", "hs004", "hs005", "hs010", "hs011", "hs014",
            "hs033", "hs048", "hs110"):
    CASES[f"robust_{_hs}"] = _c(_hs, suite="suites")
for _k, _n in ((2, 20), (3, 20), (4, 16), (5, 16), (6, 17), (7, 16)):
    for _eq in (True, False):
        CASES[f"lv{_k}{'E' if _eq else 'I'}"] = _c(
            (f"luksan_vlcek{_k}", (_n, _eq)), suite="suites")


# -- slice G: the multifrontal backend (tests/test_nested_dissection.py) and
#    the matrix-free, inexact and penalty step paths (tests/test_inexact.py,
#    test_matrix_free.py, test_cg_penalty.py, test_structured_combos.py:63,
#    test_wired_options.py:467) -------------------------------------------
# min (1-x1)^2 s.t. 10 (x2 - x1^2) = 0 (tests/problems.py:45)
HS_SPECS["hs006"] = lambda m, arr: dict(
    f=lambda x: (1.0 - x[0]) ** 2, g=lambda x: arr([10.0 * (x[1] - x[0] ** 2)]),
    g_L=np.array([0.0]), g_U=np.array([0.0]), x0=np.array([-1.2, 1.0]))
# the restoration case of tests/test_nested_dissection.py:108
HS_SPECS["nd_resto"] = lambda m, arr: dict(
    f=lambda x: m.sum((x - 2.0) ** 2), g=lambda x: arr([x[0] ** 2 + x[1] ** 2]),
    x_L=-5.0, x_U=5.0, g_L=np.array([1.0]), g_U=np.array([1.0]),
    x0=np.array([3.0, 0.1, 0.0]))


def _control_1d(m, arr, n=60):
    """The 1-D discretized control of tests/test_inexact.py:43-71: the
    tridiagonal state equation A x = u, n states and n controls."""
    h = 1.0 / (n + 1)
    target = np.sin(np.pi * np.linspace(h, 1.0 - h, n))
    torch_pkg = m.__name__ == "torch"

    def const(x, v):
        if torch_pkg:
            return m.as_tensor(v, dtype=x.dtype, device=x.device)
        return m.asarray(v)

    def f(z):
        x, u = z[:n], z[n:]
        return 0.5 * m.sum((x - const(z, target)) ** 2) + 0.5e-3 * m.sum(u ** 2)

    def g(z):
        x, u = z[:n], z[n:]
        zero = x[:1] * 0.0
        lap = (2.0 * x - m.concatenate([x[1:], zero])
               - m.concatenate([zero, x[:-1]])) / h ** 2
        return lap - u

    return dict(f=f, g=g, g_L=np.zeros(n), g_U=np.zeros(n), x0=np.zeros(2 * n))


HS_SPECS["control_1d"] = _control_1d
MF = dict(linear_solver="multifrontal")
for _name, _prob in {
        "nd3d_6": ("mittelmann_dist_control_3d", (6,)),
        "nd3d_10": ("mittelmann_dist_control_3d", (10,)),
        "nd_lv1_64": ("luksan_vlcek1_flat", (64,)),
        "nd_mitt12": ("mittelmann_dist_control", (12,)),
        "nd_hs071": "hs071_d0",
        "nd_resto": "nd_resto",
        # enters the restoration phase on the multifrontal backend
        "nd_infeasible": "infeasible"}.items():
    CASES[_name] = _c(_prob, MF, suite="nd")
INEXACT = dict(inexact_algorithm=True)
for _prob, _it in (("hs071_d0", 300), ("hs035", 300), ("hs006", 500),
                   ("hs038", 500)):
    _short = _prob.split("_")[0]
    CASES[f"{_short}_minres"] = _c(_prob, dict(linear_solver="minres", tol=1e-7),
                                   suite="inexact")
    CASES[f"{_short}_inexact"] = _c(_prob, dict(INEXACT, max_iter=_it),
                                    suite="inexact")
    CASES[f"{_short}_cgpen"] = _c(_prob, dict(line_search_method="cg-penalty",
                                              max_iter=_it), suite="inexact")
    CASES[f"{_short}_penalty"] = _c(_prob, dict(line_search_method="penalty",
                                                max_iter=_it), suite="inexact")
for _policy in ("adaptive", "switch-once"):
    CASES[f"hs071_inexact_{_policy}"] = _c("hs071_d0", dict(
        INEXACT, tol=1e-6, inexact_step_decomposition=_policy), suite="inexact")
# "always" (no decomposition bit in the carry) on a smaller problem.  On
# hs006 the reference's jitted solve takes 45 factorizations and its eager
# one 21, as the port: the MINRES residuals there are rounding noise
CASES["hs035_inexact_always"] = _c("hs035", dict(
    INEXACT, tol=1e-6, inexact_step_decomposition="always"), suite="inexact")
# -- the chain axis sharded over devices (tests/test_chain_shard.py:59-78):
#    K+1 = 32 stages over CHAIN_SHARDS shards, 4 blocks each ---------------
CHAIN_SHARDS = 8
CASES["lv1_128_chain_shard"] = _c(("luksan_vlcek1", (128, 4)), dict(
    chain_shard=True, resto_phase=False), suite="chain_shard")
CASES["lv1_128_chain_shard_mc19"] = _c(("luksan_vlcek1", (128, 4)), dict(
    chain_shard=True, resto_phase=False, linear_system_scaling="mc19"),
    suite="chain_shard")
# dist_factorize_retry on shard_retry_problem() over CHAIN_SHARDS shards:
# name -> (dtype, linear_system_scaling); the tool records the reference's
# (delta_x, delta_c, trials, ok, gave_up, num_pos, num_neg, num_zero) as
# "shard_retry:<name>"
# the scenario case of tests/test_scenario.py:70-97 (S = 16, ns = 4, seed 3),
# which test_torch_distributed.py solves over 8 scenario groups
CASES["scen_qp_16"] = _c(("scenario", "stoch_qp", (16, 4, 3)), suite="distributed")
# the batch of tests/test_batch.py:48-61 (HS071 with the equality's right-hand
# side at 40 + delta); the tool records the reference's solve_batched of it
# over an 8-device mesh as "batch:hs071_shifted" (status, iterations,
# objective, x per lane)
BATCH_DELTAS = tuple(0.1 * i for i in range(8))
SHARD_RETRY = {"float64_mc19": ("float64", "mc19"), "float32": ("float32", "none")}


def shard_retry_problem(nb=40, b=8, n=5, seed=3):
    """(diag, sub, kind, exp_pos, exp_neg): a BTD whose x blocks have
    negative curvature, so that the zero-delta inertia is wrong and the
    retry loop must raise delta_x; kind 0 on the x slots, 1 on the y slots."""
    rng = np.random.RandomState(seed)
    diag = np.zeros((nb, b, b))
    H = rng.standard_normal((nb, n, n))
    diag[:, :n, :n] = 0.5 * (H + H.transpose(0, 2, 1)) * 0.05 + 0.02 * np.eye(n)
    diag[::4, 0, 0] -= 0.05
    J = rng.standard_normal((nb, b - n, n))
    diag[:, n:, :n] = J
    diag[:, :n, n:] = J.transpose(0, 2, 1)
    sub = np.zeros((nb, b, b))
    sub[:, :n, :n] = 0.01 * rng.standard_normal((nb, n, n))
    sub[-1] = 0
    kind = np.zeros((nb, b), np.int8)
    kind[:, n:] = 1
    return diag, sub, kind, nb * n, nb * (b - n)


# HS071 through solve_from_c with ctypes callbacks, with the user's
# derivatives ("user") or finite differences ("fd"); the tool records the
# reference's (status, x, obj) as "capi:<name>"
CAPI = ("user", "fd")


def capi_callbacks(mod):
    """HS071's callbacks in the C signatures of ``mod`` (either package's
    ``interfaces.capi``): the ctypes objects, to keep alive, and their
    addresses."""
    import ctypes as ct

    @mod._EVAL_F
    def f(n, x, obj, ud):
        obj[0] = x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]
        return 1

    @mod._EVAL_G
    def g(n, x, m, out, ud):
        out[0] = x[0] * x[1] * x[2] * x[3]
        out[1] = x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2
        return 1

    @mod._EVAL_GRAD_F
    def gf(n, x, out, ud):
        out[0] = x[3] * (2 * x[0] + x[1] + x[2])
        out[1] = x[0] * x[3]
        out[2] = x[0] * x[3] + 1.0
        out[3] = x[0] * (x[0] + x[1] + x[2])
        return 1

    @mod._EVAL_JAC_G
    def jg(n, x, m, J, ud):
        vals = [x[1] * x[2] * x[3], x[0] * x[2] * x[3], x[0] * x[1] * x[3],
                x[0] * x[1] * x[2], 2 * x[0], 2 * x[1], 2 * x[2], 2 * x[3]]
        for i, v in enumerate(vals):
            J[i] = v
        return 1
    keep = (f, g, gf, jg)
    return keep, [ct.cast(c, ct.c_void_p).value for c in keep]


def capi_solve(mod, name):
    """``mod.solve_from_c`` on HS071 -> (status, x, obj, ...)."""
    keep, (f, g, gf, jg) = capi_callbacks(mod)
    user = name == "user"
    return mod.solve_from_c(4, 2, [1.0, 5.0, 5.0, 1.0], [1.0] * 4, [5.0] * 4,
                            [25.0, 40.0], [2e19, 40.0], f, g,
                            gf if user else 0, jg if user else 0, 0,
                            "{'tol': 1e-7, 'print_level': 0}")
CASES["hs071_ls_none"] = _c("hs071_d0", dict(line_search_method="none"),
                            suite="inexact")
# hs035 under the l1-penalty acceptor: nu reaches ~4e15 against a constraint
# violation of ~1e-16, so the acceptance is decided by the last bits of
# g(x): a relative change of 1e-15 in x0 changes either package's outcome
# (the reference's recorded nominal solve ends in status 6, its perturbed
# ones in status 0; test_torch_inexact.py shows it).  The perturbed starts
# are held to status and objective.
for _k in (1, 2, 3):
    HS_SPECS[f"hs035_p{_k}"] = (lambda m, arr, k=_k: dict(
        HS_SPECS["hs035"](m, arr), x0=np.array([0.5, 0.5, 0.5])
        * (1.0 + 1e-15 * np.random.RandomState(k).standard_normal(3))))
    CASES[f"hs035_penalty_p{_k}"] = _c(f"hs035_p{_k}", dict(
        line_search_method="penalty", max_iter=300), suite="inexact", chaotic=True)
CASES["hs035_penalty"]["suite"] = "chaotic"
CASES["control_1d_inexact"] = _c("control_1d", dict(INEXACT, max_iter=300, tol=1e-7),
                                 suite="inexact")
CASES["lv1_64_cgpen"] = _c(("luksan_vlcek1", (64, 4)), dict(
    tol=1e-6, line_search_method="cg-penalty"), suite="inexact")
# chip_smoke.py G1: the 3-D control at N = 16 on the card against these
CASES["nd3d_16"] = _c(("mittelmann_dist_control_3d", (16,)), dict(BENCH, **MF),
                      suite="chip")
# chip_smoke.py G3: the 2-D control at N = 30 on the multifrontal backend
# (the banded backend's solve ends at another point, in the reference too)
CASES["nd_mitt30"] = _c(("mittelmann_dist_control", (30,)), dict(BENCH, **MF),
                        suite="chip")
# chip_smoke.py G4: cg-penalty on the chained path at bench.py's size
CASES["lv1_4096_cgpen"] = _c(("luksan_vlcek1", (4096, 32)), dict(
    BENCH, line_search_method="cg-penalty"), suite="chip")


# -- slice H: mixed precision (tests/test_mixed_precision.py:23-60), the
#    blocked dense LDL^T, the hooks and sensitivity (tests/test_sens.py,
#    test_wired_options.py:307-345) -----------------------------------------
def _lv1_dense(m, arr, n=100):
    """tests/problems.py:146-169, the dense LuksanVlcek1 (KKT 2n - 2 wide)."""
    def f(x):
        return m.sum(100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2)

    def g(x):
        xk, xk1, xk2 = x[:-2], x[1:-1], x[2:]
        return (3.0 * xk1 ** 3 + 2.0 * xk2 - 5.0
                + m.sin(xk1 - xk2) * m.sin(xk1 + xk2)
                + 4.0 * xk1 - xk * m.exp(xk - xk1) - 3.0)

    x0 = np.full(n, -1.0)
    x0[1::2] = 1.0
    return dict(f=f, g=g, g_L=np.zeros(n - 2), g_U=np.zeros(n - 2), x0=x0)


HS_SPECS["lv1_dense100"] = _lv1_dense
# parametric problems of tests/test_sens.py
SENS_OPTS = dict(nlp_scaling_method="none", bound_relax_factor=0.0)
HS_SPECS["sens_pqp"] = lambda m, arr: dict(
    f=lambda x, p: 0.5 * m.sum(x ** 2) - m.dot(p, x),
    g=lambda x, p: arr([x[0] + x[1]]), g_L=np.array([1.0]),
    g_U=np.array([1.0]), x0=np.zeros(2), params=np.array([1.0, 2.0]))
HS_SPECS["sens_diagqp"] = lambda m, arr: dict(
    f=lambda x: 0.5 * (x[0] ** 2 + 4.0 * x[1] ** 2), x0=np.array([1.0, 1.0]))
HS_SPECS["sens_bqp"] = lambda m, arr: dict(
    f=lambda x, p: 0.5 * m.sum(x ** 2) - m.dot(p, x),
    x_L=np.array([-2.0, -2.0]), x_U=np.array([0.8, 2.0]), x0=np.zeros(2),
    params=np.array([0.5, 0.5]))
HS_SPECS["sens_bpqp"] = lambda m, arr: dict(
    HS_SPECS["sens_pqp"](m, arr), x_L=np.array([-5.0, -5.0]),
    x_U=np.array([0.1, 5.0]))
F32FAC = dict(factorization_dtype="float32", tol=1e-7)
F32IT = dict(dtype="float32", refinement_precision="double", tol=1e-7)
for _name, (_prob, _opts) in {
        "mp_hs071_f32fac": ("hs071_d0", F32FAC),
        "mp_lv1_128_f32fac": (("luksan_vlcek1", (128, 4)),
                              dict(F32FAC, resto_phase=False)),
        "mp_lv1flat_256_f32fac": (("luksan_vlcek1_flat", (256,)), dict(
            F32FAC, resto_phase=False, linear_solver="banded-bcr",
            linear_system_scaling="mc19")),
        "mp_lv1_128_f32it": (("luksan_vlcek1", (128, 4)),
                             dict(F32IT, resto_phase=False)),
        "mp_hs071_f32it": ("hs071_d0", F32IT),
        "mp_nd3d_6_f32fac": (("mittelmann_dist_control_3d", (6,)),
                             dict(F32FAC, **MF))}.items():
    CASES[_name] = _c(_prob, _opts, suite="precision")
CASES["blk_lv1d100"] = _c("lv1_dense100", dict(linear_solver="dense-ldlt-blocked"),
                          suite="hooks")
CASES["cc_hs071"] = _c("hs071_d0", dict(linear_solver="condensed-cholesky"),
                       suite="hooks")
# Finite differences at tol 1e-7: at 1e-8 the forward differences' noise
# (1/h = 1e7 times the evaluations' rounding) decides the last iterations,
# and the reference's jitted solves end elsewhere than its eager ones
# (ROADMAP Queue 3)
FD = "finite-difference-values"
FD_TOL = dict(tol=1e-7)
CASES["fd_grad_hs071"] = _c("hs071_d0", dict(FD_TOL, gradient_approximation=FD),
                            suite="hooks")
CASES["fd_jac_hs071"] = _c("hs071_d0", dict(FD_TOL, jacobian_approximation=FD),
                           suite="hooks")
CASES["fd_both_hs071"] = _c("hs071_d0", dict(FD_TOL, gradient_approximation=FD,
                                             jacobian_approximation=FD), suite="hooks")
# the reference's own FD gradient test (tests/test_wired_options.py:377-393):
# the stationary point moves by -eps/2 on a separable quadratic
HS_SPECS["fd_quad"] = lambda m, arr: dict(
    f=lambda x: m.sum((x - 2.0) ** 2), x_L=-10.0, x_U=10.0, x0=np.zeros(3))
CASES["fd_quad"] = _c("fd_quad", dict(tol=1e-8, gradient_approximation=FD,
                                      findiff_perturbation=1e-2), suite="hooks")
CASES["dt_hs071"] = _c("hs071_d0", dict(derivative_test="second-order"),
                       suite="hooks")
CASES["custom_hs071"] = _c("hs071_d0", dict(tol=1e-8), suite="hooks", custom="eigh")
for _name, _prob, _opts in (
        ("sens_pqp", "sens_pqp", SENS_OPTS), ("sens_diagqp", "sens_diagqp", SENS_OPTS),
        ("sens_bqp", "sens_bqp", dict(SENS_OPTS, tol=1e-10)),
        ("sens_bpqp", "sens_bpqp", dict(SENS_OPTS, tol=1e-10)),
        ("sens_mitt1d", ("mittelmann_bndry_control_1d", (64, 4)), {})):
    CASES[_name] = _c(_prob, _opts, suite="sens", record_iterate=True)
# chip_smoke.py H1/H2/H5: the card's solves at a size the CPU reference runs
for _i in (0, 255, 511):
    CASES[f"fam{_i}_f32fac"] = _c(f"hs071_fam{_i}", F32FAC, suite="chip")
    CASES[f"fam{_i}_f32it"] = _c(f"hs071_fam{_i}", F32IT, suite="chip")
    CASES[f"fam{_i}_fd"] = _c(f"hs071_fam{_i}", dict(
        FD_TOL, gradient_approximation=FD, jacobian_approximation=FD), suite="chip")
CASES["lv1_256_f32fac"] = _c(("luksan_vlcek1", (256, 32)), F32FAC, suite="chip")
CASES["lv1_256_f32it"] = _c(("luksan_vlcek1", (256, 32)), F32IT, suite="chip")
CASES["lv1flat_2000_f32fac"] = _c(("luksan_vlcek1_flat", (2000,)), dict(
    F32FAC, linear_solver="banded-bcr", linear_system_scaling="mc19"), suite="chip")

# tests/test_torch_chained.py::test_lv1_solve_matches_reference and
# test_torch_sparse.py::test_banded_solve_with_mc19_matches_reference: the
# reference's solves with their per-iteration trace and final x
for _n in (64, 60):
    CASES[f"lv1_{_n}_trace"] = _c(("luksan_vlcek1", (_n, 4)), BENCH,
                                  suite="trace", record_trace=True)
CASES["mitt12_mc19_trace"] = _c(("mittelmann_dist_control", (12,)), dict(
    BENCH, linear_solver="banded-bcr", resto_phase=False,
    linear_system_scaling="mc19"), suite="trace", record_trace=True)

# The sensitivity computations recorded at each case's final iterate:
# (case, function of sens.py, argument, keywords).  dtheta moves alpha, the
# 1-D control's penalty on its first boundary control.
_DTHETA = np.zeros((15, 1))
_DTHETA[0, 0] = 1e-3
SENS = {
    "step": ("sens_pqp", "sensitivity_step", np.array([0.1, -0.05]), {}),
    "perturbed": ("sens_pqp", "perturbed_solution", np.array([1.2, 2.1]), {}),
    "path": ("sens_pqp", "sensitivity_path",
             [np.array([1.0, 2.0]) + k * np.array([0.1, -0.05]) for k in (1, 2, 3)],
             {}),
    "rhs": ("sens_pqp", "sensitivity_step_rhs", np.array([0.1]), {}),
    "rhs_path": ("sens_pqp", "perturbed_solution_rhs", np.array([1.1]),
                 dict(n_steps=2)),
    "rhs_boundcheck": ("sens_bpqp", "perturbed_solution_rhs", np.array([1.3]),
                       dict(boundcheck=True)),
    "redhess": ("sens_diagqp", "reduced_hessian", np.array([0, 1]), {}),
    "boundcheck": ("sens_bqp", "sensitivity_step_boundcheck", np.array([0.7, 0.0]),
                   dict(bound_eps=1e-4)),
    "chain_step": ("sens_mitt1d", "sensitivity_step", {"theta": _DTHETA}, {}),
    "chain_redhess": ("sens_mitt1d", "reduced_hessian", np.array([0, 63]), {}),
}


def eigh_kkt(pkg: str):
    """The custom KKT solver of tests/test_wired_options.py:307-345 for
    ``pkg`` ("ref" or "port"): an eigendecomposition of the augmented
    matrix with delta_c = 1e-8, its inertia from the eigenvalues' signs."""
    if pkg == "ref":
        import jax.numpy as jnp
        from ipopt_tpu.algorithm.step import FactorResult
        from ipopt_tpu.kkt import sigmas, assemble_aug_system, split_aug_solution

        class EighKKT:
            def factorize(self, nlp, opts, it, ev, W, mu, dwl):
                z = jnp.zeros((), it.x.dtype)
                dc = jnp.asarray(1e-8, it.x.dtype)
                K = assemble_aug_system(W, ev.J_c, ev.J_d, sigmas(nlp, it), z, z, dc, dc)
                w, V = jnp.linalg.eigh(K)
                ok = ((jnp.sum(w > 0) == nlp.n + nlp.mi)
                      & (jnp.sum(w < 0) == nlp.me + nlp.mi))
                return FactorResult(fac=(w, V), K=K, delta_x=z, delta_c=dc,
                                    delta_w_last=dwl, failed=~ok,
                                    num_trials=jnp.ones((), jnp.int32))

            def solve(self, nlp, opts, fac, K, parts):
                w, V = fac
                rhs = jnp.concatenate(parts).astype(w.dtype)
                sol = V @ ((V.T @ rhs) / w)
                return (split_aug_solution(sol, nlp.n, nlp.mi, nlp.me),
                        jnp.zeros((), rhs.dtype))
        return EighKKT()
    import torch
    from ipopt_torch.algorithm.step import FactorResult
    from ipopt_torch.kkt import sigmas, assemble_aug_system, split_aug_solution

    class EighKKT:
        def factorize(self, nlp, opts, it, ev, W, mu, dwl):
            z = torch.zeros_like(mu)
            dc = torch.full_like(mu, 1e-8)
            K = assemble_aug_system(W, ev.J_c, ev.J_d, sigmas(nlp, it), z, z, dc, dc)
            w, V = torch.linalg.eigh(K)
            ok = (((w > 0).sum(-1) == nlp.n + nlp.mi)
                  & ((w < 0).sum(-1) == nlp.me + nlp.mi))
            return FactorResult(fac=(w, V), K=K, delta_x=z, delta_c=dc,
                                delta_w_last=dwl, failed=~ok,
                                num_trials=torch.ones_like(mu, dtype=torch.int64))

        def solve(self, nlp, opts, fac, K, parts):
            w, V = fac
            rhs = torch.cat(parts, -1).to(w.dtype)
            coef = torch.matmul(V.transpose(-1, -2), rhs[..., None])[..., 0] / w
            sol = torch.matmul(V, coef[..., None])[..., 0]
            return (split_aug_solution(sol, nlp.n, nlp.mi, nlp.me),
                    rhs.new_zeros(rhs.shape[0]))
    return EighKKT()


def suite_cases(suite: str):
    return sorted(k for k, v in CASES.items() if v["suite"] == suite)


def recorded() -> dict:
    """The reference's recorded results (tests/torch_reference_values.json)."""
    global _RECORDED
    if _RECORDED is None:
        import json
        import os
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "torch_reference_values.json")) as fh:
            _RECORDED = json.load(fh)
    return _RECORDED


_RECORDED = None


def solve_port(name: str, iterates: dict):
    """Solve case ``name`` with the port on the CPU; ``iterates`` holds the
    final iterates of the cases solved so far (a warm case solves its source
    first).  Returns (result, record) with the keys of the recorded file."""
    import ipopt_torch
    case = CASES[name]
    it0 = None
    if case["warm"] is not None and CASES[case["warm"]].get("record_iterate"):
        it0 = [np.asarray(v) for v in recorded()[case["warm"]]["iterate"]]
    elif case["warm"] is not None:
        if case["warm"] not in iterates:
            solve_port(case["warm"], iterates)
        it0 = iterates[case["warm"]]
    mus, trials = [], []

    def cb(**k):
        mus.append(float(k["mu"]))
        trials.append(int(k["ls_trials"]))
        return True

    from ipopt_torch.parallel.chain_shard import set_chain_mesh
    if case["opts"].get("chain_shard"):
        set_chain_mesh(["cpu"] * CHAIN_SHARDS)
    try:
        res = ipopt_torch.solve(build(case["problem"], "port"), device="cpu",
                                print_level=0, it0=it0, intermediate_callback=cb,
                                custom_kkt_solver=(eigh_kkt("port") if case.get("custom")
                                                   else None),
                                **case["opts"])
    finally:
        set_chain_mesh(None)
    iterates[name] = res.iterate
    c = res.counters
    return res, dict(
        status=int(res.status), iter_count=int(res.iter_count), obj=float(res.obj),
        n_obj_evals=int(c.n_obj_evals), n_grad_evals=int(c.n_grad_evals),
        n_hess_evals=int(c.n_hess_evals), n_factorizations=int(c.n_factorizations),
        n_kkt_solves=int(c.n_kkt_solves), restoration_count=int(res.restoration_count),
        mu=mus, ls_trials=trials)
