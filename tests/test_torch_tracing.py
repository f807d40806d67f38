"""The span recorder of ``ipopt_torch.profiling`` on the CPU: off unless
someone measures, one span per layer boundary of the solve path, spans
nested inside their parents, self times that add up to the solve, the same
results with recording on and off, the profiler's clock shared with the
spans', and the idle-time attribution of ``trace``."""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ipopt_torch
from ipopt_torch import modellib, profiling

torch.set_num_threads(1)

BACKENDS = {
    "dense": (modellib.hs071, {}),
    "banded": (lambda: modellib.luksan_vlcek1_flat(600), dict(linear_solver="banded-bcr")),
    "multifrontal": (lambda: modellib.mittelmann_dist_control(8),
                     dict(linear_solver="multifrontal")),
}


def _solve(name):
    build, kw = BACKENDS[name]
    return ipopt_torch.solve(build(), device="cpu", print_level=0, **kw)


def _counts(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_nothing_is_recorded_without_a_profiler_or_timing_option():
    profiling.solve_timed(modellib.hs071(), print_report=False, device="cpu")
    before = profiling.last_spans()
    assert before and before[0].name == "solve"
    _solve("dense")
    assert profiling.last_spans() == before
    assert profiling.span("eval") is profiling.span("kkt.factorize")
    assert profiling.host_bool(torch.tensor([False, True]).any()) is True


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_recorded_solve_has_a_span_at_every_layer(backend):
    off = _solve(backend)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _solve(backend)
    spans = profiling.last_spans()
    n = _counts(spans)
    # the same solve, recorded or not
    assert torch.equal(on.x, off.x) and int(on.iter_count) == int(off.iter_count)
    assert int(on.status) == 0
    assert spans[0].name == "solve" and spans[0].parent == -1 and n["solve"] == 1
    assert n["iteration"] == int(on.iter_count)
    assert [s.iteration for s in spans if s.name == "iteration"] == list(range(n["iteration"]))
    assert n["kkt.factorize"] == int(on.counters.n_factorizations)
    assert n["host_wait"] >= n["iteration"]
    assert {"eval", "eval.hessian", "eval.jac_t", "kkt.assemble", "kkt.backsolve",
            "line_search"} <= set(n)
    assert ("nd.extend_add" in n) == (backend == "multifrontal")
    assert ("eval.jacobian" in n) == (backend != "dense")
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    own = sum(t[2] for t in profiling.self_times(spans).values())
    whole = (spans[0].end_ns - spans[0].start_ns) / 1e9
    assert own == pytest.approx(whole, rel=1e-2)


def test_profiler_events_share_the_spans_clock():
    x = torch.ones(64, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.solve_span():
            with profiling.span("probe"):
                x.add_(1.0)
    probe = [s for s in profiling.last_spans() if s.name == "probe"]
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_"]
    assert len(probe) == 1 and len(adds) == 1
    assert probe[0].start_ns <= adds[0].start_ns() <= probe[0].end_ns


def test_idle_gaps_go_to_the_innermost_open_span():
    S = profiling.Span
    spans = [S("solve", 0, 100, -1, -1), S("iteration", 10, 90, 0, 0),
             S("kkt.factorize", 20, 40, 1, 0), S("host_wait", 50, 60, 1, 0)]
    busy = [(0, 5), (3, 8), (25, 30), (35, 52), (58, 70), (95, 99), (120, 130),
            (140, 150)]
    idle = profiling.idle_by_span(busy, spans)
    # a gap goes to the span open at its start: after the host wait closed,
    # its parent; after the solve closed, none
    assert idle == pytest.approx({"solve": 17e-9 + 21e-9, "iteration": 25e-9,
                                  "kkt.factorize": 5e-9, "host_wait": 6e-9,
                                  "(none)": 10e-9})


def test_timing_report_rows_are_self_times():
    S = profiling.Span
    ms = 1_000_000
    spans = [S("solve", 0, 100 * ms, -1, -1), S("iteration", 0, 90 * ms, 0, 0),
             S("eval", 1 * ms, 3 * ms, 1, 0), S("eval.hessian", 3 * ms, 7 * ms, 1, 0),
             S("kkt.factorize", 10 * ms, 30 * ms, 1, 0),
             S("kkt.assemble", 10 * ms, 12 * ms, 4, 0),
             S("nd.extend_add", 15 * ms, 16 * ms, 4, 0),
             S("kkt.backsolve", 30 * ms, 40 * ms, 1, 0),
             S("line_search", 40 * ms, 60 * ms, 1, 0),
             S("kkt.backsolve", 45 * ms, 50 * ms, 8, 0),
             S("host_wait", 55 * ms, 56 * ms, 8, 0),
             S("eval.jac_t", 56 * ms, 58 * ms, 8, 0)]
    rep = profiling.timing_report(spans)
    assert rep.overall == pytest.approx(0.1) and rep.iters == 1
    assert rep.lin_factorization == pytest.approx(0.020)
    assert rep.lin_backsolve == pytest.approx(0.015)
    assert rep.search_direction == pytest.approx(0.035)
    assert rep.function_evals == pytest.approx(0.004)
    assert rep.hessian == pytest.approx(0.004)
    assert rep.line_search == pytest.approx(0.012)
    assert rep.compile == 0.0


def test_trace_writes_the_spans_and_the_idle_time_by_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        res = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, max_iter=2)
    names = {s.name for s in profiling.last_spans()}
    assert int(res.iter_count) == 2 and {"solve", "iteration", "kkt.factorize"} <= names
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        traced = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert names <= traced
    with open(os.path.join(tmp_path, "idle_by_span.json")) as fh:
        idle = json.load(fh)
    assert idle["wall_s"] > 0 and idle["busy_s"] == idle["idle_s"] == 0  # no device here


def test_print_timing_statistics_prints_the_whole_table(capsys):
    ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                      print_timing_statistics=True)
    out = capsys.readouterr().out
    for row in ("OverallAlgorithm", "LinearSystemFactorization", "LinearSystemBackSolve",
                "Function Evaluations", "Hessian of Lagrangian function",
                "per IPM iteration", "KKT factorizations"):
        assert row in out, row


@pytest.mark.gpu
def test_k2_launches_fall_inside_their_factorization_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build, kw = BACKENDS["banded"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ipopt_torch.solve(build(), device="cuda", print_level=0, **kw)
        torch.cuda.synchronize()
    spans = [s for s in profiling.last_spans() if s.name == "kkt.factorize"]
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if str(e.device_type()).endswith("CPU")}
    k2 = [launch[e.correlation_id()] for e in events
          if not str(e.device_type()).endswith("CPU") and "gj_inv" in e.name()]
    assert spans and k2
    assert all(any(s.start_ns <= t <= s.end_ns for s in spans) for t in k2)
