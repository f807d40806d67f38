"""One run of one cell of the port's benchmark (``ipopt_torch`` on the card).

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the problem's sizes, its options, the perturbation of its start, the
correctness limits) and a traffic mix (``workloads/<traffic>.json``: the
loop, the solver options it adds).  The harness finds both by name, builds
the problem with the builder the configuration names (``problems/<problem>.py``)
from a start perturbed by the seed, and then:

1. set-up: loads the program's kernels, canonicalizes the problem
   (``canon_s``) and solves it once cold;
2. the window: warm ``ipopt_torch.solve`` calls on that canonical problem,
   back to back for ``--seconds`` (a solve that has started finishes and
   counts, none starts after the window), each ended by a synchronize; the
   step of one iteration drawn from the seed is captured in every solve;
3. with ``--trace 1``, one more solve under a CUDA-only ``torch.profiler``
   trace, with the call sites that per-layer metrics name timed by host
   intervals and their kernels attributed through the trace's launch
   records;
4. the per-layer or end-to-end metrics, each read by its own module
   (``metrics/<name>.py``);
5. once the program's state is freed, the judge (``judge.py``) with the
   configuration's plain reference (``reference/<problem>.py``) decides
   ``correct`` on a seeded sample of the window's solutions and on the
   captured step.

Everything a cell needs is a file found by name; adding a configuration, a
traffic mix or a metric adds files and entries of ``BENCHMARK.json`` only.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ipopt_tpu")
# solutions of the window judged by the reference, drawn from the seed
SAMPLED_SOLVES = 3
# torch's host threads while the window runs: one process with few threads
WINDOW_THREADS = 2


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level packages among module names, compared by the
    whole part before the first dot (``ipopt_torch`` is not ``ipopt_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return age if 0.0 <= age < 3600.0 else None


# --------------------------------------------------------------------------
# The benchmark's files, found by name
# --------------------------------------------------------------------------

def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(root: str, sub: str, name: str):
    """``portbench/<sub>/<name>.py`` under ``root``, loaded from its file."""
    path = os.path.join(root, "portbench", sub, name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no {sub} module {name!r} at {path}")
    key = f"portbench_{sub}_{name}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    """A metric applies to every cell unless it lists its ``workloads``."""
    return cell in metric.get("workloads", (cell,))


def find_cell(root: str, spec: dict, workload: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "workloads", w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def start_point(problem, config: dict, seed: int) -> np.ndarray:
    """The configuration's starting point, perturbed by the seed: each entry
    moves by a uniform draw in [-a, a], a = ``perturbation`` of the
    configuration, and stays inside its bounds."""
    x0, x_L, x_U = problem.start(config)
    rng = np.random.default_rng(seed % 2**64)
    x = x0 + float(config["perturbation"]) * rng.uniform(-1.0, 1.0, x0.shape)
    return np.clip(x, np.where(np.isfinite(x_L), x_L, -np.inf),
                   np.where(np.isfinite(x_U), x_U, np.inf))


# --------------------------------------------------------------------------
# What one run records for the metric readers
# --------------------------------------------------------------------------

@dataclass
class Trace:
    busy_s: float
    window_s: float
    # per metric that names call sites: [(shape, dtype, device seconds)] per call
    calls: Dict[str, list] = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""
    setup_s: float = 0.0
    canon_s: float = 0.0
    solve_walls: List[float] = field(default_factory=list)
    solves: List[dict] = field(default_factory=list)
    window_peak_bytes: int = 0
    info: Any = None            # the program's static analysis (NDInfo, BandedInfo)
    dtype_bytes: int = 8
    trace: Optional[Trace] = None


class GcClock:
    """Counts the garbage collector's runs and their seconds while open."""

    def __init__(self):
        self.count, self.seconds, self._t0 = 0, 0.0, None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)


# --------------------------------------------------------------------------
# Patches at the program's call sites
# --------------------------------------------------------------------------

def _resolve(site: str):
    mod_name, attr = site.rsplit(".", 1)
    return sys.modules.get(mod_name) or importlib.import_module(mod_name), attr


class CallTimer:
    """Wraps the functions named by ``module.attr`` call sites; every call
    records (host enter ns, host exit ns, shape and dtype of its first
    argument) on the epoch clock the profiler's events carry."""

    def __init__(self, sites_by_label: Dict[str, List[str]]):
        self.sites = sites_by_label
        self.calls: Dict[str, list] = {k: [] for k in sites_by_label}
        self._saved = []

    def __enter__(self):
        for label, sites in self.sites.items():
            for site in sites:
                mod, attr = _resolve(site)
                inner = getattr(mod, attr)
                setattr(mod, attr, self._wrap(inner, self.calls[label]))
                self._saved.append((mod, attr, inner))
        return self

    @staticmethod
    def _wrap(inner, out):
        def call(A, *args, **kwargs):
            t0 = time.time_ns()
            try:
                return inner(A, *args, **kwargs)
            finally:
                out.append((t0, time.time_ns(), tuple(A.shape), str(A.dtype)))
        return call

    def __exit__(self, *exc):
        for mod, attr, inner in reversed(self._saved):
            setattr(mod, attr, inner)
        self._saved.clear()


class StepCapture:
    """Keeps a copy of one step of every solve: the ``k``-th call of the
    solver's ``compute_search_direction`` on the problem of ``n`` variables
    (the restoration phase's larger problem is not counted); with k = -1 it
    only counts them."""

    SITE = "ipopt_torch.algorithm.solver.compute_search_direction"

    def __init__(self, n: int, k: int):
        self.n, self.k = n, k
        self.count = 0
        self.captured = None

    def __enter__(self):
        mod, attr = _resolve(self.SITE)
        inner = getattr(mod, attr)

        def call(nlp, opts, it, ev, W, mu, *args, **kwargs):
            sr = inner(nlp, opts, it, ev, W, mu, *args, **kwargs)
            if nlp.n == self.n:
                if self.count == self.k:
                    self.captured = {
                        "x": it.x[0].clone(), "y_c": it.y_c[0].clone(),
                        "z_L": it.z_L[0].clone(), "z_U": it.z_U[0].clone(),
                        "mu": mu[0].clone(), "delta_x": sr.delta_x[0].clone(),
                        "delta_c": sr.delta_c[0].clone(),
                        "dx": sr.step.x[0].clone(), "dy_c": sr.step.y_c[0].clone()}
                self.count += 1
            return sr

        self._saved = (mod, attr, inner)
        setattr(mod, attr, call)
        return self

    def __exit__(self, *exc):
        mod, attr, inner = self._saved
        setattr(mod, attr, inner)


# --------------------------------------------------------------------------
# The traced solve
# --------------------------------------------------------------------------

def _union_busy(intervals) -> tuple:
    """(busy ns, gaps [(gap ns, name of the next op)]) of device intervals."""
    busy, gaps = 0, []
    end = None
    for s, e, name in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, name))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def attribute(events, calls_by_label) -> Dict[str, list]:
    """Device seconds of each recorded call: every device event whose launch
    (the host-side runtime event of the same correlation id) lies inside a
    call's host interval counts for that call.  ``events`` are (is_device,
    correlation id, start ns, duration ns, name)."""
    launch = {c: s for dev, c, s, _, _ in events if not dev}
    out = {}
    for label, calls in calls_by_label.items():
        calls = sorted(calls)
        starts = [c[0] for c in calls]
        dev_ns = [0] * len(calls)
        for dev, corr, _, dur, _ in events:
            t = launch.get(corr) if dev else None
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= calls[i][1]:
                dev_ns[i] += dur
        out[label] = [(c[2], c[3], ns / 1e9) for c, ns in zip(calls, dev_ns)]
    return out


def traced_solve(run_once, sites_by_label) -> Trace:
    """One solve under a trace of CUDA activity only (no CPU operators, no
    Python profiler), with the named call sites timed by host intervals."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):     # CUPTI's start-up cost
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with CallTimer(sites_by_label) as timer:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_once()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    raw = prof.profiler.kineto_results.events()
    events = []
    for e in raw:
        dev = not str(e.device_type()).endswith("CPU")
        events.append((dev, e.correlation_id(), e.start_ns(), e.duration_ns(), e.name()))
    del raw, prof
    device = [(s, s + d, name) for dev, _, s, d, name in events if dev]
    busy_ns, gaps = _union_busy(device)
    by_name: Dict[str, int] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    calls = attribute(events, timer.calls)
    for label, rows in calls.items():
        silent = sum(1 for r in rows if r[2] <= 0.0)
        if silent:
            raise BenchError(f"{label}: {silent} of {len(rows)} calls show no device "
                             f"time in the trace: their kernels could not be attributed")
    return Trace(
        busy_s=busy_ns / 1e9, window_s=window_s, calls=calls,
        device_ops=[[n[:160], ns / 1e9] for n, ns in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[["before " + n[:150], ns / 1e9] for ns, n in
                   sorted(gaps, key=lambda g: -g[0])[:10]])


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------

def device_facts(chips: int) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": name, "count": chips, "power_limit": limit}


def _host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", option_overrides: Optional[dict] = None):
    """One run of ``workload``; returns (result dict, checks dict).  On the
    CPU (``device="cpu"``, for tests) there is no memory reading and no
    trace.  ``option_overrides`` switches on another path of the program
    (the control's lower precision); the benchmark's own runs pass none."""
    age = process_age_s()
    t_proc = time.perf_counter() - (age if age is not None else 0.0)
    import ipopt_torch
    from ipopt_torch import Options
    from ipopt_torch.sparse import canonicalize_sparse

    spec = load_spec(root)
    cell = find_cell(root, spec, workload)
    cfg, traffic = cell.config, cell.traffic
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise BenchError(f"traffic of {workload}: only a closed loop of one client is "
                         f"generated here, not {traffic.get('loop')!r} x {traffic.get('clients')!r}")
    on_card = device == "cuda"
    phases = {"to_run_cell": age if age is not None else 0.0}
    t0 = time.perf_counter()
    facts = (device_facts(cell.chips) if on_card else
             {"platform": "cpu", "kind": "cpu", "count": 1})
    dev = torch.device(device)
    if on_card:
        from ipopt_torch.linalg import cuda_lib
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        phases["device_init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cuda_lib.build()
        phases["kernels"] = time.perf_counter() - t0

    problem = load_module(root, "problems", cfg["problem"])
    x0 = start_point(problem, cfg, seed)
    opts = dict(cfg["options"], **traffic["options"], **(option_overrides or {}))
    run = Run(dtype_bytes=8 if opts.get("dtype", "float64") == "float64" else 4)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(problem.build(cfg, x0), Options(**opts), device=dev)
    sync()
    run.canon_s = phases["canon"] = time.perf_counter() - t0
    run.info = cnlp.chain

    def solve_once():
        return ipopt_torch.solve(cnlp, device=dev, **opts)

    # the cold solve counts the steps of the problem itself (a restoration
    # phase's steps are of a larger problem), one of which every window solve
    # captures
    t0 = time.perf_counter()
    steps = StepCapture(cnlp.n, -1)
    with steps:
        cold = solve_once()
    sync()
    phases["cold_solve"] = time.perf_counter() - t0
    rng = np.random.default_rng([seed % 2**64, 1])
    k_step = int(rng.integers(max(steps.count, 1)))
    del cold
    gc.collect()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the window: a seeded reservoir of SAMPLED_SOLVES solutions is kept on the host
    kept: Dict[int, dict] = {}
    capture = StepCapture(cnlp.n, k_step)
    # set-up's objects live through the window: the collector skips them
    # (it still collects what the window's solves allocate), and the time it
    # takes in the window is recorded; the host runs on WINDOW_THREADS threads
    gc.freeze()
    gc_clock = GcClock()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, WINDOW_THREADS))
    t_start = time.perf_counter()
    run.setup_s = t_start - t_proc
    t_end = t_start + seconds
    with capture, gc_clock:
        while time.perf_counter() < t_end:
            capture.count = 0
            t0 = time.perf_counter()
            r = solve_once()
            sync()
            run.solve_walls.append(time.perf_counter() - t0)
            i = len(run.solves)
            run.solves.append({"status": int(r.status), "iter_count": int(r.iter_count),
                               "n_factorizations": int(r.counters.n_factorizations)})
            slot = i if i < SAMPLED_SOLVES else int(rng.integers(i + 1))
            if slot < SAMPLED_SOLVES:
                sol = {k: _host(getattr(r, k)) for k in ("x", "y", "z_L", "z_U")}
                sol["obj"] = float(r.obj)
                kept[slot] = sol
            del r
    torch.set_num_threads(threads)
    gc.unfreeze()
    if on_card:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
    step = None if capture.captured is None else {
        k: _host(v) for k, v in capture.captured.items()}
    capture.captured = None

    if trace:
        if not on_card:
            raise BenchError("a traced run needs the card")
        sites = {}
        for m in cell.per_layer:
            mod = load_module(root, "metrics", m["name"])
            if getattr(mod, "CALL_SITES", None):
                sites[m["name"]] = list(mod.CALL_SITES)
        run.trace = traced_solve(solve_once, sites)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(root, "metrics", m["name"]).read(run)
        if value is None:
            if on_card:
                raise BenchError(f"metric {m['name']} found nothing to read in {workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # free the program's state before the reference runs
    info_n = cnlp.n
    del cnlp, solve_once
    run.info = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reference = load_module(root, "reference", cfg["problem"]).Problem(cfg)
    from portbench import judge
    if reference.n != info_n:
        raise BenchError(f"the reference has {reference.n} variables, the program {info_n}")
    readings = {"solves_not_optimal": float(sum(s["status"] != 0 for s in run.solves))}
    for sol in kept.values():
        for name, v in judge.solution_readings(reference, sol).items():
            readings[name] = max(readings.get(name, 0.0), v)
    if step is None:
        raise BenchError(f"no step was captured at iteration {k_step} of a window solve")
    readings["step_berr"] = judge.step_backward_error(reference, x0, step)
    limits = dict(cfg["limits"], solves_not_optimal=0.0)
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = bool(run.solves) and all(c["value"] <= c["limit"] for c in checks.values())

    device_out = dict(facts)
    if on_card:
        device_out["memory_peak_bytes"] = int(max(setup_peak, run.window_peak_bytes))
    else:
        device_out["memory_peak_bytes"] = 0
    if run.trace is not None:
        device_out["busy_s"] = run.trace.busy_s
        device_out["window_s"] = run.trace.window_s
    result = {"correct": correct, "attempted": len(run.solves),
              "failed": int(readings["solves_not_optimal"]), "metrics": metrics,
              "device": device_out}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["setup_phases_s"] = phases
    result["solve_walls_s"] = run.solve_walls
    result["window_gc"] = {"collections": gc_clock.count, "seconds": gc_clock.seconds}
    result["statuses"] = {str(k): sum(s["status"] == k for s in run.solves)
                          for k in sorted({s["status"] for s in run.solves})}
    result["checks"] = checks
    return result, checks


def main(argv, root: str) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        chips = find_cell(root, load_spec(root), args.workload).chips
    except (BenchError, OSError, KeyError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(root, args.workload, args.seed, args.seconds,
                                  bool(args.trace))
    except BenchError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the process holds forbidden modules: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases_s"].items()), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
