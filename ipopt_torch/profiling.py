"""Profiling and tracing: the TimingStatistics and device-trace bridge (port
of ``ipopt_tpu/profiling.py``; ``IpTimingStatistics.hpp:37-160``).

- ``trace(logdir)``: a ``torch.profiler`` trace of CPU and CUDA activity
  around a block of solver work, written as a Chrome trace
  (``<logdir>/trace.json``, for Perfetto or chrome://tracing): K1's and
  K2's launches show by their kernel names.
- ``annotate(name)``: a named region in that trace.
- ``solve_timed``: a solve with per-phase wall times (``TimingReport``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block's CPU and CUDA activity into ``logdir/trace.json``::

        with ipopt_torch.profiling.trace("trace_dir"):
            res = ipopt_torch.solve(nlp)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region that shows in ``trace``'s timeline."""
    return torch.profiler.record_function(name)


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
        self.line_search = 0.0  # residual: step minus measured sub-phases
        self.compile = 0.0      # first calls: kernel builds (excluded)
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


def solve_timed(problem, options=None, print_report=True, device=None):
    """Solve with per-phase wall times, the TimingStatistics analog.

    Runs the solver's own outer step iteration by iteration and, at each
    iterate, times the phases separately (evaluation, Hessian,
    factorization, backsolve), each between two device synchronizations on
    the card: the phase rows re-run work the step also does, so
    ``overall`` (the sum of the real steps' times) is authoritative and the
    rows are per-phase costs, as the reference's timers are.  The first
    calls (kernel builds) are timed apart as ``compile``.  Runs on the card
    unless ``device="cpu"``.  Returns ``(SolveResult, TimingReport)``.
    """
    from .options import Options
    from .problem import NLP, canonicalize
    from .chained import ChainedNLP, canonicalize_chained
    from .parallel.scenario import ScenarioNLP, canonicalize_scenario
    from .kkt import evaluate, condensed_rhs_parts
    from .types import SolverReturn
    from .algorithm.solver import (initial_state, initial_check, guarded_step,
                                   finalize, _unbatch, resolve_device,
                                   check_supported, _matrix_free)
    from .algorithm.step import compute_hessian, factorize_any, solve_any

    opts = options if options is not None else Options()
    check_supported(opts)
    dev = resolve_device(device)
    if isinstance(problem, NLP):
        nlp = canonicalize(problem, opts, device=dev)
    elif isinstance(problem, ChainedNLP):
        nlp = canonicalize_chained(problem, opts, device=dev)
    elif isinstance(problem, ScenarioNLP):
        nlp = canonicalize_scenario(problem, opts, device=dev)
    else:
        nlp = problem.to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    exact_direct = (opts.hessian_approximation != "limited-memory"
                    and not _matrix_free(opts))

    def phases(st):
        """The phases at ``st``'s iterate; returns their times."""
        ev, t_ev = timed(evaluate, nlp, st.it.x)
        if not exact_direct:
            return t_ev, 0.0, 0.0, 0.0
        W, t_h = timed(compute_hessian, nlp, st.it)
        fr, t_f = timed(factorize_any, nlp, opts, st.it, ev, W, st.mu,
                        st.delta_w_last)
        parts = condensed_rhs_parts(nlp, st.it, ev, st.mu, opts.kappa_d)
        _, t_s = timed(solve_any, nlp, opts, fr.fac, fr.K, parts)
        return t_ev, t_h, t_f, t_s

    rep = TimingReport()
    st = initial_check(nlp, opts, initial_state(nlp, opts))
    # first calls of every phase and of the step (kernel builds), excluded
    t0 = time.perf_counter()
    phases(st)
    guarded_step(nlp, opts, st)
    sync()
    rep.compile = time.perf_counter() - t0

    running = int(SolverReturn.CONTINUE)
    while bool((st.status == running).any()):
        t_ev, t_h, t_f, t_s = phases(st)
        rep.function_evals += t_ev
        rep.hessian += t_h
        rep.lin_factorization += t_f
        rep.lin_backsolve += t_s
        rep.search_direction += t_f + t_s
        st, t_step = timed(guarded_step, nlp, opts, st)
        rep.overall += t_step
        rep.iters += 1
    rep.line_search = max(0.0, rep.overall - rep.search_direction
                          - rep.function_evals - rep.hessian)
    rep.counters = st.counters
    res = finalize(nlp, opts, st)
    if nlp.batch == 1:
        res = _unbatch(res)
    if print_report:
        rep.print()
    return res, rep
