"""The judge at test size on the CPU: the whole of a run but the look for a
card and the trace, with the timed path sound, switched to the program's
lower precision (the control), or broken underneath."""
import numpy as np
import pytest
import torch

import ipopt_torch
from ipopt_torch.algorithm import solver as solver_mod
from portbench import harness

CELLS = ["neuma1-128.mf", "lv1-1m.banded"]


def run(root, cell, **kw):
    result, checks = harness.run_cell(root, cell, 2**31 + 5, 0.5, False, device="cpu", **kw)
    return result, {k: c["value"] > c["limit"] for k, c in checks.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(small_root, cell):
    result, over = run(small_root, cell)
    assert result["correct"] and not any(over.values()), over
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "solve_s"}   # no memory on the CPU
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float32_is_not_correct(small_root, cell):
    result, over = run(small_root, cell, option_overrides={"dtype": "float32"})
    assert not result["correct"]
    assert over["step_berr"] and over["dual_inf"], over


def _patch_solve(monkeypatch, change):
    inner = ipopt_torch.solve

    def solve(*args, **kwargs):
        return change(inner(*args, **kwargs), args[0])
    monkeypatch.setattr(ipopt_torch, "solve", solve)


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(small_root, cell, monkeypatch):
    _patch_solve(monkeypatch, lambda r, _: r._replace(x=r.x * (1 + 1e-6)))
    result, over = run(small_root, cell)
    assert not result["correct"] and any(over.values()), over


@pytest.mark.parametrize("cell", CELLS)
def test_solve_that_returns_its_start_is_not_correct(small_root, cell, monkeypatch):
    def unchanged(r, cnlp):
        x0 = cnlp.x0[0].to(r.x.dtype)
        return r._replace(x=x0, y=torch.zeros_like(r.y), z_L=torch.zeros_like(r.z_L),
                          z_U=torch.zeros_like(r.z_U))
    _patch_solve(monkeypatch, unchanged)
    result, over = run(small_root, cell)
    assert not result["correct"]
    assert over["primal_inf"], over


@pytest.mark.parametrize("cell", CELLS)
def test_step_altered_where_produced_is_not_correct(small_root, cell, monkeypatch):
    inner = solver_mod.compute_search_direction

    def off(*args, **kwargs):
        sr = inner(*args, **kwargs)
        return sr._replace(step=sr.step._replace(x=sr.step.x * (1 + 1e-3)))
    monkeypatch.setattr(solver_mod, "compute_search_direction", off)
    result, over = run(small_root, cell)
    assert not result["correct"]
    assert over["step_berr"], over


def test_solution_readings_of_an_exact_point_are_zero():
    from portbench import judge
    from portbench.reference import lv1
    R = lv1.Problem({"n": 5})
    x = np.ones(5)      # c(1, 1, 1) = 3 + 2 - 5 + 0 + 4 - 1 - 3 = 0, grad f = 0
    r = judge.solution_readings(R, {"x": x, "y": np.zeros(3), "z_L": np.zeros(5),
                                    "z_U": np.zeros(5), "obj": 0.0})
    assert r == {"primal_inf": 0.0, "dual_inf": 0.0, "compl": 0.0, "bound_viol": 0.0,
                 "obj_gap": 0.0}
