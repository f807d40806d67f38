"""The options of the PyTorch port that slice E wires (warm starts, the time
limits, the counters, and the options of tests/test_wired_options.py that
the port has), as twins of the reference's tests: the port gives the
reference's status, iterations, factorizations and restorations, and the
objective to rtol 1e-9 where the solve converges.  The reference's results
are the recorded ones of ``tests/torch_reference_values.json``
(``tools/torch_reference_values.py``); the warm-start cases start from the
iterate of the cold case, solved by the same package.  Float64 on the CPU.
"""
import numpy as np
import pytest
import torch

import ipopt_torch
from ipopt_torch import SolverReturn, modellib
from ipopt_torch.algorithm.solver import check_supported
import torch_cases
from test_torch_adaptive import RECORDED, assert_matches_recorded

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solved():
    """Port results by case name, solved once per module."""
    iterates, cache = {}, {}

    def get(name):
        if name not in cache:
            cache[name] = torch_cases.solve_port(name, iterates)
        return cache[name]
    return get


@pytest.mark.parametrize("name", torch_cases.suite_cases("options"))
def test_matches_recorded_reference(name, solved):
    assert_matches_recorded(name, solved(name)[1])


# -- warm starts (tests/test_warmstart_derivcheck.py:19-31) -----------------

def test_warm_start_fewer_iterations(solved):
    cold = solved("hs071_cold_d001")[1]
    warm = solved("hs071_warm_d001")[1]
    assert warm["status"] == 0
    np.testing.assert_allclose(warm["obj"], cold["obj"], rtol=1e-7)
    assert warm["iter_count"] < cold["iter_count"]


def test_chained_warm_start(solved):
    """mittelmann_bndry_control(10, 1) warm-starts example 3, whose bounds
    and target differ: the warm start pushes the iterate inside them."""
    warm = solved("mitt10_ex3_warm")[1]
    cold = RECORDED["mitt10_ex3"]
    assert warm["status"] == 0
    assert_matches_recorded("mitt10_ex3_warm", warm)
    # the reference's own warm and cold objectives differ by 2.8e-7 (tol 1e-8
    # bounds the scaled KKT error, not the objective)
    np.testing.assert_allclose(warm["obj"], cold["obj"], rtol=1e-6)


def test_warm_start_from_user_multipliers(solved):
    """NLP.y0 / z_L0 / z_U0 are read with warm_start_init_point."""
    res, rec = solved("hs071_y0")
    assert rec["iter_count"] < RECORDED["hs071_cold_d0"]["iter_count"]
    plain = ipopt_torch.solve(torch_cases.build("hs071_y0", "port"), device="cpu",
                              print_level=0)
    assert int(plain.iter_count) == RECORDED["hs071_cold_d0"]["iter_count"]


# -- tests/test_termination.py ------------------------------------------------

@pytest.mark.parametrize("opt,status", [
    ("max_wall_time", SolverReturn.WALLTIME_EXCEEDED),
    ("max_cpu_time", SolverReturn.CPUTIME_EXCEEDED)])
def test_time_limits(opt, status):
    res = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                            **{opt: 1e-9})
    assert int(res.status) == int(status)
    assert int(res.iter_count) == 0
    batch = ipopt_torch.solve_batched([modellib.hs071_family(d) for d in (0.0, 0.5)],
                                      device="cpu", **{opt: 1e-9})
    assert batch.status.tolist() == [int(status)] * 2


def test_counters_exact_hs071(solved):
    """One gradient, one Hessian and two objective evaluations per iteration
    on hs071, which neither backtracks nor corrects its inertia."""
    rec = solved("counters")[1]
    iters = rec["iter_count"]
    assert rec["n_grad_evals"] == iters
    assert rec["n_hess_evals"] == iters
    assert rec["n_obj_evals"] == 2 * iters
    assert rec["n_factorizations"] == iters
    assert rec["n_kkt_solves"] == iters
    for k in ("n_obj_evals", "n_grad_evals", "n_hess_evals"):
        assert rec[k] == RECORDED["counters"][k], k


def test_adaptive_counts_two_extra_solves(solved):
    """Adaptive mu solves three times per factorization: the affine, the
    centering and (with a corrector) the corrector's right-hand sides."""
    rec = RECORDED["hs071_corr_primal_dual"]
    assert rec["n_kkt_solves"] == 4 * rec["iter_count"]


# -- tests/test_wired_options.py ---------------------------------------------

def test_accept_after_max_steps(solved):
    base = ipopt_torch.solve(torch_cases.build("rosenbrock", "port"), device="cpu",
                             print_level=0, tol=1e-8,
                             intermediate_callback=lambda **k: True)
    rec = solved("accept_after_max_steps")[1]
    assert max(rec["ls_trials"]) <= 1
    assert int(base.iter_count) != rec["iter_count"]
    assert rec["ls_trials"] == RECORDED["accept_after_max_steps"]["ls_trials"]


def test_start_with_resto(solved):
    rec = solved("start_with_resto")[1]
    assert rec["restoration_count"] >= 1 and rec["status"] == 0
    np.testing.assert_allclose(rec["obj"], modellib.HS071_F_STAR, rtol=1e-5)


def test_expect_infeasible_problem(solved):
    rec = solved("expect_infeasible")[1]
    assert rec["status"] == int(SolverReturn.LOCAL_INFEASIBILITY)
    assert rec["restoration_count"] >= 1


def test_recalc_y_changes_dual_path(solved):
    """The least-squares multipliers alter the dual trajectory
    (test_wired_options.py:93-111); mu per iteration as the reference's."""
    inf_du = {}
    for on in (False, True):
        rows = []
        res = ipopt_torch.solve(torch_cases.build("rosenbrock_eq", "port"), device="cpu",
                                print_level=0, tol=1e-8, recalc_y=on,
                                recalc_y_feas_tol=1e-1,
                                intermediate_callback=lambda **k: rows.append(k["inf_du"]))
        assert int(res.status) == 0
        inf_du[on] = rows
    m = min(map(len, inf_du.values()))
    assert not np.allclose(inf_du[False][:m], inf_du[True][:m])
    np.testing.assert_allclose(solved("recalc_y")[1]["mu"], RECORDED["recalc_y"]["mu"],
                               rtol=1e-7)


def _iter0_iterate(**kw):
    seen = []

    def cb(**k):
        if k["iter_count"] == 0:
            seen.append(k["curr_iterate"])
        return True

    res = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, tol=1e-8,
                            intermediate_callback=cb, callback_curr_iterate=True, **kw)
    return res, seen[0]


def test_least_square_init_and_curr_iterate():
    """least_square_init_primal moves the first x, least_square_init_duals
    the first duals, seen through callback_curr_iterate."""
    _, it0 = _iter0_iterate()
    _, it1 = _iter0_iterate(least_square_init_primal=True)
    _, it2 = _iter0_iterate(least_square_init_duals=True)
    assert set(it0) == {"x", "s", "y_c", "y_d", "z_L", "z_U"}
    assert not np.allclose(it0["x"], it1["x"])
    assert not (np.allclose(it0["z_L"], it2["z_L"]) and np.allclose(it0["y_c"], it2["y_c"]))
    assert np.all(it2["z_L"] >= ipopt_torch.Options().bound_mult_init_val - 1e-12)


def test_corrector_inert_in_monotone_mode():
    base = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, tol=1e-8)
    inert = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, tol=1e-8,
                              corrector_type="affine")
    assert int(inert.iter_count) == int(base.iter_count)
    assert torch.equal(inert.x, base.x)


def test_timing_statistics_prints(capsys):
    ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                      print_timing_statistics=True)
    out = capsys.readouterr().out
    assert "OverallAlgorithm" in out and "KKT factorizations" in out


def test_only_the_listed_options_are_refused():
    """_SUPPORTED lists no option since the sharded chained factorization
    (chain_shard=True) was ported: every value is accepted."""
    from ipopt_torch.algorithm.solver import _SUPPORTED
    assert _SUPPORTED == ()
    for kw in (dict(chain_shard=True), dict(mu_strategy="adaptive"),
               dict(mehrotra_algorithm=True),
               dict(corrector_type="primal-dual"), dict(warm_start_init_point=True),
               dict(replace_bounds=True), dict(dependency_detector="mumps"),
               dict(magic_steps=True), dict(soc_method=1), dict(recalc_y=True),
               dict(max_wall_time=10.0), dict(hessian_constant=True),
               dict(nlp_scaling_method="equilibration-based"),
               dict(hessian_approximation="limited-memory"),
               dict(hessian_approximation="limited-memory",
                    limited_memory_aug_solver="extended"),
               dict(linear_solver="multifrontal"), dict(linear_solver="minres"),
               dict(inexact_algorithm=True), dict(line_search_method="penalty"),
               dict(line_search_method="cg-penalty"),
               dict(line_search_method="none"),
               dict(linear_solver="dense-ldlt-blocked"), dict(linear_solver="custom"),
               dict(linear_solver="condensed-cholesky"),
               dict(derivative_test="first-order"),
               dict(gradient_approximation="finite-difference-values"),
               dict(jacobian_approximation="finite-difference-values"),
               dict(factorization_dtype="float32"), dict(refinement_precision="double")):
        check_supported(ipopt_torch.Options(**kw))
