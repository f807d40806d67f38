"""Profiling and tracing: one span recorder for the solve path, the
TimingStatistics report built from it and the device-trace bridge (port of
``ipopt_tpu/profiling.py``; ``IpTimingStatistics.hpp:37-160``).

The solver opens a named span at each layer boundary of a solve:

=================  =====================================================
``solve``          the root (``solver.solve_canonical``)
``iteration``      one outer iteration (``run_ipm``), with its number
``eval``           f, grad f, c and d (``kkt.evaluate``)
``eval.jacobian``  the sparse Jacobian's values (``sparse.jacobian_values``)
``eval.hessian``   the Lagrangian's Hessian (``step.compute_hessian``)
``eval.jac_t``     the products J^T y (``kkt.jac_t``)
``kkt.assemble``   the KKT matrix assembled (dense, banded, fronts)
``kkt.factorize``  one trial of the inertia-correction retry
``nd.extend_add``  one extend-add of the multifrontal factorization
``kkt.backsolve``  a solve with the factorization (``step.solve_any``)
``line_search``    the line search of an iteration
``restoration``    the restoration phase
``host_wait``      the host blocked on a read of a device value
=================  =====================================================

Recording is decided once per solve, when ``solve`` opens: it is on while a
``torch.profiler`` session is active, with ``timing_statistics`` or
``print_timing_statistics``, and inside ``trace``.  Otherwise every span is
one flag read and a shared no-op context.  A recorded span keeps its name,
its start and end on ``time.time_ns()`` (the clock of the profiler's events,
so a device idle gap can be put down to the span open on the host), its
parent's index and the outer iteration's number.  Each recorded solve
replaces the spans of the one before: ``last_spans()``.

- ``trace(logdir)``: a ``torch.profiler`` trace of CPU and CUDA activity
  around a block of solver work, written as a Chrome trace
  (``<logdir>/trace.json``, for Perfetto or chrome://tracing) with the spans
  in it, and the device's idle time by span (``<logdir>/idle_by_span.json``).
- ``annotate(name)``: a span of the caller's own.
- ``solve_timed``: a solve with its ``TimingReport``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from typing import Dict, List, NamedTuple, Tuple

import torch


class Span(NamedTuple):
    name: str
    start_ns: int     # time.time_ns() at entry
    end_ns: int       # time.time_ns() at exit
    parent: int       # index of the enclosing span, -1 for the root
    iteration: int    # the outer iteration open at entry, -1 before the first


_on = False       # spans do something: inside a recorded solve or trace()
_record = False   # spans append to _spans: inside a recorded solve
_rf = False       # spans also enter record_function: inside trace()
_force = False    # trace() and solve_timed record every solve
_spans: list = []      # [name, start, end, parent, iteration] of the last recorded solve
_stack: list = []      # indices of the open spans
_iteration = -1
_collect = None        # trace(): the spans of every solve it recorded
_annotations: set = set()  # trace(): the names given to record_function


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "number", "index", "rf")

    def __init__(self, name, number):
        self.name, self.number = name, number
        self.index, self.rf = -1, None

    def __enter__(self):
        global _iteration
        if _rf:
            _annotations.add(self.name)
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if _record:
            if self.number is not None:
                _iteration = self.number
            self.index = len(_spans)
            _spans.append([self.name, time.time_ns(), 0,
                           _stack[-1] if _stack else -1, _iteration])
            _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            _spans[self.index][2] = time.time_ns()
            _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, iteration=None):
    """A named span of the solve path; ``iteration`` (an int) marks the
    outer iteration it opens.  Off, the shared no-op context."""
    return _Span(name, iteration) if _on else _NOOP


def annotate(name: str):
    """A span of the caller's own: it shows in ``trace``'s timeline and, in
    a recorded solve, among ``last_spans()``."""
    return span(name)


def host_bool(t) -> bool:
    """``bool(t)`` of a device value, a blocking read: a ``host_wait`` span
    while recording."""
    if not _record:
        return bool(t)
    with _Span("host_wait", None):
        return bool(t)


def _profiler_active() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


@contextlib.contextmanager
def solve_span(timing: bool = False):
    """The ``solve`` span, the root of a solve's spans.  It records when
    ``timing`` (the timing-statistics options) is set, a ``torch.profiler``
    session is active or the solve runs inside ``trace``; a solve inside a
    recorded solve is an ordinary span of it."""
    global _on, _record, _iteration
    if _record:
        with _Span("solve", None):
            yield
        return
    if not (timing or _force or _profiler_active()):
        yield
        return
    _spans.clear()
    _stack.clear()
    _iteration = -1
    _on = _record = True
    try:
        with _Span("solve", None):
            yield
    finally:
        _record = False
        _on = _rf
        if _collect is not None:
            base = len(_collect)
            _collect.extend(Span(n, a, b, p + base if p >= 0 else -1, k)
                            for n, a, b, p, k in _spans)


def last_spans() -> List[Span]:
    """The spans of the last recorded solve, in the order they opened."""
    return [Span(*s) for s in _spans]


def self_times(spans) -> Dict[str, Tuple[int, float, float]]:
    """For each span name: (count, total seconds, self seconds), self time
    being a span's duration less the part its child spans cover."""
    child = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, Tuple[int, float, float]] = {}
    for s, c in zip(spans, child):
        d = s.end_ns - s.start_ns
        n, tot, own = out.get(s.name, (0, 0.0, 0.0))
        out[s.name] = (n + 1, tot + d / 1e9, own + (d - c) / 1e9)
    return out


def idle_by_span(intervals, spans) -> Dict[str, float]:
    """Device idle seconds by span name: each gap between the union of the
    device's busy ``intervals`` (start ns, end ns) is put down to the
    innermost span open on the host at the gap's start (``(none)`` where
    none was).  ``spans`` as ``last_spans()`` gives them, in start order."""
    starts = [s.start_ns for s in spans]
    out: Dict[str, float] = {}
    end = None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            i = bisect.bisect_right(starts, end) - 1
            while i >= 0 and spans[i].end_ns < end:
                i = spans[i].parent
            name = spans[i].name if i >= 0 else "(none)"
            out[name] = out.get(name, 0.0) + (a - end) / 1e9
        end = b if end is None else max(end, b)
    return out


def _device_intervals(prof):
    """(start ns, end ns) of every kernel, copy and memset in a trace: its
    device events less the spans' own annotations of the device timeline."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if not str(e.device_type()).endswith("CPU") and e.name() not in _annotations]


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block's CPU and CUDA activity, the solve's spans included,
    into ``logdir/trace.json``, and write into ``logdir/idle_by_span.json``
    the block's wall (``wall_s``, to a synchronize), the device's busy time
    (``busy_s``, the union of its kernels, copies and memsets), the idle
    gaps between them (``idle_s``) and those gaps by span
    (``gaps_by_span_s``, ``idle_by_span``)::

        with ipopt_torch.profiling.trace("trace_dir"):
            res = ipopt_torch.solve(nlp)
    """
    global _on, _rf, _force, _collect
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    spans: List[Span] = []
    saved = (_on, _rf, _force, _collect)
    _annotations.clear()
    with torch.profiler.profile(activities=acts) as prof:
        _on = _rf = _force = True
        _collect = spans
        t0 = time.perf_counter()
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _on, _rf, _force, _collect = saved
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    busy = _device_intervals(prof)
    idle = idle_by_span(busy, spans)
    idle_s = sum(idle.values())
    extent = (max(b for _, b in busy) - min(a for a, _ in busy)) / 1e9 if busy else 0.0
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as fh:
        json.dump({"wall_s": wall, "busy_s": extent - idle_s, "idle_s": idle_s,
                   "gaps_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))},
                  fh, indent=1)


class TimingReport:
    """Per-phase wall times (TimingStatistics parity,
    IpTimingStatistics.hpp:37-160).  Times are seconds; ``iters`` is the
    number of outer IPM iterations measured."""

    def __init__(self):
        self.overall = 0.0
        self.search_direction = 0.0
        self.lin_factorization = 0.0
        self.lin_backsolve = 0.0
        self.function_evals = 0.0
        self.hessian = 0.0
        self.line_search = 0.0
        self.compile = 0.0      # kernel builds: no span, reads 0
        self.iters = 0
        self.counters = None

    def print(self, out=print):
        """The reference's format (print_timing_statistics,
        IpIpoptApplication.cpp:628-634)."""
        from .algorithm.solver import print_counters

        def row(label, t, depth=0):
            pad = " " * depth
            dots = "." * max(1, 36 - len(label) - depth)
            out(f"{pad}{label}{dots}: {t:10.3f} (wall)")

        out("")
        out("Timing Statistics:")
        out("")
        row("OverallAlgorithm", self.overall)
        row("ComputeSearchDirection", self.search_direction, 1)
        row("LinearSystemFactorization", self.lin_factorization, 2)
        row("LinearSystemBackSolve", self.lin_backsolve, 2)
        row("Function Evaluations", self.function_evals, 1)
        row("Hessian of Lagrangian function", self.hessian, 1)
        row("LineSearch/accept (residual)", self.line_search, 1)
        row("Compilation (one-time, excluded)", self.compile)
        if self.iters:
            row("per IPM iteration", self.overall / self.iters, 1)
        if self.counters is not None:
            print_counters(self.counters, out)


def timing_report(spans, counters=None) -> TimingReport:
    """The ``TimingReport`` of one solve's spans.  The rows are self times,
    so they do not overlap: a back-solve inside the line search counts as a
    back-solve, and a host wait in no row."""
    own = {name: t[2] for name, t in self_times(spans).items()}

    def rows(*names):
        return sum(own.get(n, 0.0) for n in names)

    rep = TimingReport()
    if spans:
        rep.overall = (spans[0].end_ns - spans[0].start_ns) / 1e9
    rep.lin_factorization = rows("kkt.assemble", "kkt.factorize", "nd.extend_add")
    rep.lin_backsolve = rows("kkt.backsolve")
    rep.search_direction = rep.lin_factorization + rep.lin_backsolve
    rep.function_evals = rows("eval", "eval.jacobian", "eval.jac_t")
    rep.hessian = rows("eval.hessian")
    rep.line_search = rows("line_search")
    rep.iters = sum(1 for s in spans if s.name == "iteration")
    rep.counters = counters
    return rep


def solve_timed(problem, options=None, print_report=True, device=None):
    """``solve`` with its spans recorded, and their ``TimingReport``.
    Runs on the card unless ``device="cpu"``.  Returns ``(SolveResult,
    TimingReport)``."""
    global _force
    from .algorithm.solver import solve
    saved, _force = _force, True
    try:
        res = solve(problem, options, device=device)
    finally:
        _force = saved
    rep = timing_report(last_spans(), res.counters)
    if print_report:
        rep.print()
    return res, rep
