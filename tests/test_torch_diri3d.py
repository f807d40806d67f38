"""MittelmannBndryCntrlDiri3D on the port's multifrontal path, on the CPU at
test size: the model library's builder (``modellib.mittelmann_bndry_control_3d``),
the benchmark's frozen copy (``portbench/problems/diri3d.py``) and its plain
reference (``portbench/reference/diri3d.py``) agree; solves reach status 0 and
the judge's readings; the analysis' own-size counters; the ``nd.eliminate``
span; the benchmark's readers of the two metrics of the multifrontal fronts."""
import ast
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ipopt_torch
from ipopt_torch import Options, modellib, profiling
from ipopt_torch.sparse import canonicalize_sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, judge, roofline            # noqa: E402
from portbench.problems import diri3d                     # noqa: E402
from portbench.reference import diri3d as ref_diri3d      # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(ROOT, "portbench", "configs", "diri3d-32.json")) as _fh:
    CFG = json.load(_fh)


def _cfg(N):
    return dict(CFG, N=N)


def _canonical(N, linear_solver="multifrontal"):
    return canonicalize_sparse(modellib.mittelmann_bndry_control_3d(N),
                               Options(linear_solver=linear_solver, print_level=0),
                               device="cpu")


@pytest.mark.parametrize("N", [4, 5])
def test_builders_and_reference_agree(N):
    """f, grad f, g, J v, J^T w and the Hessian of the Lagrangian at seeded
    points inside the bounds; the bounds, start and patterns."""
    cfg = _cfg(N)
    R = ref_diri3d.Problem(cfg)
    x0, x_L, x_U = diri3d.start(cfg)
    lib, frozen = modellib.mittelmann_bndry_control_3d(N), diri3d.build(cfg, x0)
    assert R.n == (N + 2) ** 3 and R.m == N ** 3
    for nlp in (lib, frozen):
        np.testing.assert_array_equal(nlp.x0, x0)
        np.testing.assert_array_equal(nlp.x_L, x_L)
        np.testing.assert_array_equal(nlp.x_U, x_U)
        np.testing.assert_array_equal(R.x_L, np.where(x_L > -1e19, x_L, -np.inf))
        np.testing.assert_array_equal(R.x_U, x_U)
        for a, b in zip(nlp.jac_g_sparsity, frozen.jac_g_sparsity):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(N)
    for _ in range(2):
        x = rng.uniform(np.maximum(x_L, -2.0), x_U)
        xt = torch.tensor(x)
        v, w = rng.standard_normal(R.n), rng.standard_normal(R.m)
        sf, lam = 0.37, rng.standard_normal(R.m)
        for nlp in (lib, frozen):
            assert R.f(x) == pytest.approx(float(nlp.f(xt)), rel=1e-13)
            np.testing.assert_allclose(R.c(x), nlp.g(xt).numpy() - nlp.g_L,
                                       rtol=1e-13, atol=1e-14)
            np.testing.assert_allclose(R.grad_f(x), torch.func.grad(nlp.f)(xt).numpy(),
                                       rtol=1e-13, atol=1e-16)
            J = torch.func.jacfwd(nlp.g)(xt).numpy()
            rows, cols = nlp.jac_g_sparsity
            declared = np.zeros_like(J, bool)
            declared[rows, cols] = True
            assert not (J != 0)[~declared].any() and declared.sum() == len(rows)
            np.testing.assert_allclose(R.jac_v(x, v), J @ v, rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(R.jac_t_v(x, w), J.T @ w, rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(R.jac_t_v_abs(x, np.abs(w)), np.abs(J).T @ np.abs(w),
                                       rtol=1e-13)
            np.testing.assert_array_equal(R.jac_abs_rowsum(x), np.abs(J).sum(1))
            np.testing.assert_array_equal(R.jac_row_absmax(x), np.abs(J).max(1))
            lamt = torch.tensor(lam)
            H = torch.func.hessian(
                lambda z: sf * nlp.f(z) + (lamt * nlp.g(z)).sum())(xt).numpy()
            np.testing.assert_allclose(R.hess_v(x, sf, lam, v), H @ v, rtol=1e-13, atol=1e-17)
            np.testing.assert_allclose(R.hess_diag(x, sf, lam), np.diag(H), rtol=1e-13)
            np.testing.assert_array_equal(R.hess_offdiag_abs_rowsum(x, sf, lam),
                                          np.abs(H - np.diag(np.diag(H))).sum(1))


@pytest.fixture(scope="module")
def solved():
    """The N = 6 problem solved on both flat backends, at the configuration's
    tol and at 1e-12."""
    out = {}
    for ls, tol in (("multifrontal", 1e-8), ("multifrontal", 1e-12), ("banded-bcr", 1e-12)):
        out[ls, tol] = ipopt_torch.solve(_canonical(6, ls), device="cpu", print_level=0,
                                         linear_solver=ls, tol=tol)
    return out


def _duality_gap(r, N=6):
    """sum z_L (x - x_L) + z_U (x_U - x) over the finite bounds: for this
    convex QP, with x feasible and the Lagrangian's gradient ~0, f(x) less
    the optimum lies in [0, this gap]."""
    nlp = modellib.mittelmann_bndry_control_3d(N)
    x, zl, zu = r.x.numpy(), r.z_L.numpy(), r.z_U.numpy()
    lo, hi = nlp.x_L > -1e19, nlp.x_U < 1e19
    return float((zl * (x - nlp.x_L))[lo].sum() + (zu * (nlp.x_U - x))[hi].sum())


def test_multifrontal_solve_meets_the_configs_limits(solved):
    r = solved["multifrontal", 1e-8]
    assert int(r.status) == 0
    sol = {k: getattr(r, k).numpy() for k in ("x", "y", "z_L", "z_U")}
    sol["obj"] = float(r.obj)
    readings = judge.solution_readings(ref_diri3d.Problem(_cfg(6)), sol)
    for name, limit in CFG["limits"].items():
        if name in readings:
            assert readings[name] <= limit, (name, readings[name], limit)
    assert readings["bound_viol"] == 0.0


def test_banded_solve_gives_the_same_objective(solved):
    """Both backends solve the same convex QP, so each objective lies within
    its own duality gap above the one optimum, and the two lie within the
    sum of their gaps of each other.  At tol 1e-12 the gaps are ~1e-10 (the
    objective ~0.1335): at the configuration's 1e-8 they are ~1e-6, and
    the two backends' paths (16 and 17 iterations from the published start)
    end 1.5e-7 apart, relative, within them."""
    mf, bcr = solved["multifrontal", 1e-12], solved["banded-bcr", 1e-12]
    assert int(mf.status) == 0 and int(bcr.status) == 0
    gap = _duality_gap(mf) + _duality_gap(bcr)
    assert 0.0 < gap < 1e-9
    assert abs(float(bcr.obj) - float(mf.obj)) <= gap


def test_front_counters_are_the_sums_over_the_fronts():
    """used_slots, dense_ops_used and dense_ops_padded at N = 4, worked out
    front by front from the index arrays (padding is the unknown N)."""
    info = _canonical(4).chain
    used = ops = padded = 0
    for lv, eg, bg in zip(info.levels, info.elim_gid, info.bd_gid):
        assert eg.shape == (lv.n_nodes, lv.p) and bg.shape == (lv.n_nodes, lv.u)
        for k in range(lv.n_nodes):
            p, u = int((eg[k] < info.N).sum()), int((bg[k] < info.N).sum())
            used += (p + u) ** 2
            for pp, uu, acc in ((p, u, "own"), (lv.p, lv.u, "pad")):
                k1 = sum(s * (s + 1) + s for s in range(pp))
                trsm = uu * pp * (pp - 1)
                schur = pp * uu + 2 * pp * uu * (uu + 1) // 2
                if acc == "own":
                    ops += k1 + trsm + schur
                else:
                    padded += k1 + trsm + schur
    assert info.used_slots == used < info.total_slots
    assert info.dense_ops_used == ops < info.dense_ops_padded == padded


def test_recorded_solve_opens_nd_eliminate_per_level_inside_factorize():
    cnlp = _canonical(4)
    levels = len(cnlp.chain.levels)
    with profile(activities=[ProfilerActivity.CPU]):
        r = ipopt_torch.solve(cnlp, device="cpu", print_level=0,
                              linear_solver="multifrontal")
    spans = profiling.last_spans()
    assert int(r.status) == 0
    elim = [s for s in spans if s.name == "nd.eliminate"]
    factor = [i for i, s in enumerate(spans) if s.name == "kkt.factorize"]
    assert len(factor) == int(r.counters.n_factorizations)
    assert len(elim) == levels * len(factor)
    for i in factor:
        assert sum(1 for s in elim if s.parent == i) == levels


def test_metric_readers_on_a_cpu_solve():
    """front_pad_share from the analysis; front_dense_roofline from the
    calls of ``eliminate_fronts`` timed at its call site, each given one
    second of device time here (the CPU has no device trace), so the share is
    the least time of the calls over their number; the least time counts
    the operations of ``NDInfo.dense_ops_used``."""
    cnlp = _canonical(4)
    info = cnlp.chain
    pad = harness.load_module(ROOT, "metrics", "front_pad_share")
    roof = harness.load_module(ROOT, "metrics", "front_dense_roofline")
    run = harness.Run(info=info)
    assert pad.read(run) == pytest.approx(100.0 * (1.0 - info.used_slots / info.total_slots))
    assert roof.CALL_SITES == ("ipopt_torch.linalg.nested_dissection.eliminate_fronts",)
    with harness.CallTimer({"front_dense_roofline": list(roof.CALL_SITES)}) as timer:
        r = ipopt_torch.solve(cnlp, device="cpu", print_level=0, linear_solver="multifrontal")
    calls = timer.calls["front_dense_roofline"]
    n_fac = int(r.counters.n_factorizations)
    assert len(calls) == n_fac * len(info.levels)
    assert [c[2][-3:] for c in calls[:len(info.levels)]] == [
        (lv.n_nodes, lv.p, lv.f) for lv in info.levels]
    run.trace = harness.Trace(busy_s=1.0, window_s=1.0, calls={
        "front_dense_roofline": [(shape, dtype, 1.0) for _, _, shape, dtype in calls]})
    ops = sum(int(roof.front_work(*own)[1].sum()) for own in info.front_sizes())
    assert ops == info.dense_ops_used
    least = sum(roofline._least_s(float(b.sum()), float(o.sum()), "torch.float64")
                for b, o in (roof.front_work(*own) for own in info.front_sizes()))
    assert roof.read(run) == pytest.approx(100.0 * n_fac * least / len(calls), rel=1e-12)


def test_dense_roofline_reads_k1_alone_in_a_program_without_eliminate_fronts(monkeypatch):
    """On a program that predates ``eliminate_fronts`` the reader times K1 at
    the level loop and counts K1's own work only, front by front as
    ``k1_roofline``'s count has it, so the parent commit's traced run of the
    cell still reads a value."""
    from ipopt_torch.linalg import nested_dissection
    info = _canonical(4).chain
    monkeypatch.delattr(nested_dissection, "eliminate_fronts")
    roof = harness.load_module(ROOT, "metrics", "front_dense_roofline")
    assert roof.CALL_SITES == ("ipopt_torch.linalg.nested_dissection.batched_block_ldlt",)
    calls = [((lv.n_nodes, lv.p, lv.p), "torch.float64", 1.0) for lv in info.levels] * 2
    run = harness.Run(info=info, trace=harness.Trace(busy_s=1.0, window_s=1.0,
                                                     calls={"front_dense_roofline": calls}))
    least = sum(roofline._least_s(*(float(v.sum()) for v in roofline.k1_work(1, p, "float64")),
                                  "float64") for p, _ in info.front_sizes())
    assert roof.read(run) == pytest.approx(100.0 * least / len(info.levels), rel=1e-12)


def test_new_benchmark_files_import_neither_jax_nor_the_jax_package():
    """The reference imports nothing of the program either; the harness's
    list of forbidden top-level modules names what may not be imported."""
    for rel in ("reference/diri3d.py", "problems/diri3d.py", "metrics/front_pad_share.py",
                "metrics/front_dense_roofline.py"):
        tree = ast.parse(open(os.path.join(ROOT, "portbench", rel)).read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or "")
        assert not harness.forbidden_modules(names), rel
        if rel.startswith("reference/"):
            assert {n.split(".")[0] for n in names} <= {"__future__", "numpy", "torch"}, names


def test_cell_runs_on_the_cpu_at_test_size(tmp_path):
    """The whole run of ``diri3d-32.mf`` at N = 6 on the CPU is correct, and
    the float32 control is not."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench" / "configs" / "diri3d-32.json").write_text(json.dumps(_cfg(6)))
    result, checks = harness.run_cell(str(tmp_path), "diri3d-32.mf", 2**31 + 7, 0.5, False,
                                      device="cpu")
    assert result["correct"] and result["failed"] == 0, checks
    control, checks = harness.run_cell(str(tmp_path), "diri3d-32.mf", 2**31 + 7, 0.5, False,
                                       device="cpu", option_overrides={"dtype": "float32"})
    assert not control["correct"], checks
