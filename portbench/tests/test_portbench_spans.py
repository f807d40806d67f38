"""The per-layer metrics that read the program's spans (``spans.py``,
``metrics/{evals_ms,factor_ms,extend_add_ms,backsolve_ms,host_syncs_per_iter,
host_wait_ms}.py``), read from a ``harness.Run`` after a recorded solve on
the CPU."""
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans as pspans
from portbench.tests.conftest import ROOT

SPAN_METRICS = ("evals_ms", "factor_ms", "extend_add_ms", "backsolve_ms",
                "host_syncs_per_iter", "host_wait_ms")


def _read(run):
    return {m: harness.load_module(ROOT, "metrics", m).read(run) for m in SPAN_METRICS}


def _traced_run():
    return harness.Run(trace=harness.Trace(busy_s=1.0, window_s=2.0))


@pytest.mark.parametrize("backend", ["multifrontal", "banded-bcr"])
def test_span_metrics_read_a_recorded_solve(backend):
    import ipopt_torch
    from ipopt_torch import modellib, profiling
    nlp = (modellib.mittelmann_dist_control(6) if backend == "multifrontal"
           else modellib.luksan_vlcek1_flat(400))
    with profile(activities=[ProfilerActivity.CPU]):
        res = ipopt_torch.solve(nlp, device="cpu", print_level=0, linear_solver=backend)
    got = _read(_traced_run())
    spans = profiling.last_spans()
    iters = int(res.iter_count)
    assert sum(s.name == "iteration" for s in spans) == iters
    for name, value in got.items():
        if name == "extend_add_ms" and backend != "multifrontal":
            assert value is None
        else:
            assert value is not None and value > 0, name
    waits = [s for s in spans if s.name == "host_wait"]
    assert got["host_syncs_per_iter"] == pytest.approx(len(waits) / iters)
    assert got["host_wait_ms"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in waits) / 1e6 / iters)
    # the benchmark's own self times equal the program's
    own = profiling.self_times(spans)
    assert got["backsolve_ms"] == pytest.approx(own["kkt.backsolve"][2] * 1e3 / iters)
    # nothing to read outside a traced run
    assert all(v is None for v in _read(harness.Run()).values())


def test_self_time_leaves_out_the_children():
    class S:
        def __init__(self, name, a, b, parent):
            self.name, self.start_ns, self.end_ns, self.parent = name, a, b, parent
    spans = [S("solve", 0, 100, -1), S("kkt.factorize", 10, 50, 0),
             S("nd.extend_add", 20, 30, 1), S("host_wait", 40, 45, 1)]
    assert pspans.self_ns(spans, ("kkt.factorize",)) == 25
    assert pspans.self_ns(spans, ("solve", "kkt.factorize")) == 60 + 25


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from ipopt_torch import profiling
    monkeypatch.delattr(profiling, "last_spans")
    assert all(v is None for v in _read(_traced_run()).values())
