"""Where a path's time goes on the card.

    python3 -m ipopt_torch.profile_main            # HS071 family, dense (K1)
    python3 -m ipopt_torch.profile_main chained    # LuksanVlcek1 4096/32 (K2)
    python3 -m ipopt_torch.profile_main banded     # LuksanVlcek1 flat 1e5 (K2)
    python3 -m ipopt_torch.profile_main multifrontal  # 3-D control N = 24 (K1)
    python3 -m ipopt_torch.profile_main banded DIR    # keep the trace in DIR

The first stacks the 512-instance HS071 family on the card and solves it
with ``solve_batched``; the second solves ``luksan_vlcek1(4096, 32)`` (128
blocks of 156, block cyclic reduction) with ``solve``; the third solves
``luksan_vlcek1_flat(100_000)`` with ``linear_solver="banded-bcr"`` (12,500
blocks of 16 after RCM); the fourth solves ``mittelmann_dist_control_3d(24)``
with ``linear_solver="multifrontal"`` (15 tree levels).  All run in float64
with the options of
``bench.py:74-80``: once to warm up, once timed and once under
``profiling.trace`` (written to DIR, by default a temporary directory), and
print:
- the card (``nvidia-smi`` name and power limit), the warm wall time and
  ms per iteration;
- host time by span of the traced solve (count, total and self seconds,
  ``profiling.self_times``);
- device time: busy total, idle share of the traced wall, the idle time by
  the span open on the host (``idle_by_span.json``), the kernels with the
  most device time, and the path's kernel's device time per launch (K1
  ``block_ldlt`` or K2 ``block_ldlt_inv``);
- the path's kernel back to back (CUDA events) on every input the solve
  gave it, in the solve's order, beside its device time per launch inside
  the solve: for HS071, K1's time per wrapper call and its device time per
  launch (torch.profiler) on those inputs; for the chained path, K2 also on
  seeded (64, 156, 156) blocks and on the solve's own first-level blocks;
  for the banded path, K2 on the solve's own first-level blocks; with the
  SM clock and power draw that ``nvidia-smi`` sampled every 50 ms inside
  each window (about 2 s of calls back to back).
The banded path then solves ``luksan_vlcek1_flat(1_000_000)`` (125,000
blocks of 16) once cold and once warm, and prints its set-up time, warm
wall, ms per iteration and peak device memory (a measurement, not a gate).
The multifrontal path prints K1's share of the device time and the
triangular solves' launches (per back-solve span and per solve).
It needs a CUDA device.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import Options, canonicalize_chained, modellib, profiling, solve, solve_batched
from . import stack_problems
from .sparse import canonicalize_sparse
from .linalg import block_ldlt as bl
from .linalg import block_ldlt_inv as k2
from .linalg import block_tridiag
from .linalg import ldlt as ldlt_mod

BATCH = 512
OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)


def _device_us(e):
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


class _Clocks:
    """``nvidia-smi`` sampling the SM clock (MHz) and power draw (W) every
    50 ms; ``stop(t0, t1)`` ends it and summarizes the samples taken between
    the host times t0 and t1 (``time.time()``)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(1.0)  # let the first samples come before the window opens

    def stop(self, t0, t1) -> str:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                stamp, clk, pw = (v.strip() for v in line.split(",")[:3])
                t = datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                if t0 <= t <= t1:
                    rows.append((float(clk), float(pw)))
            except ValueError:
                continue
        if not rows:
            return "no nvidia-smi samples in the window"
        clk = sorted(r[0] for r in rows)
        pw = sorted(r[1] for r in rows)
        return (f"SM clock {clk[0]:.0f}/{clk[len(clk) // 2]:.0f}/{clk[-1]:.0f} MHz, "
                f"power {pw[0]:.1f}/{pw[len(pw) // 2]:.1f}/{pw[-1]:.1f} W "
                f"(min/median/max of {len(rows)} samples)")


def _back_to_back(kernel, inputs, seconds=2.0):
    """``kernel``'s ms per call over ``inputs``, called in order, round after
    round, back to back for about ``seconds`` (CUDA events; a call whose host
    cost exceeds its device time measures the host); the number of calls;
    and the clocks sampled meanwhile."""
    def one_round():
        for A in inputs:
            kernel(A)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    one_round()
    start.record()
    one_round()
    end.record()
    torch.cuda.synchronize()
    rounds = max(2, int(seconds / (start.elapsed_time(end) * 1e-3)))
    clocks = _Clocks()
    t0 = time.time()
    start.record()
    for _ in range(rounds):
        one_round()
    end.record()
    torch.cuda.synchronize()
    t1 = time.time()
    n = rounds * len(inputs)
    return start.elapsed_time(end) / n, n, clocks.stop(t0, t1)


def device_us_per_launch(fn, pattern, rounds=5):
    """Device time (us) per kernel launch whose name holds ``pattern``, from
    torch.profiler over ``rounds`` calls of ``fn``, and the launch count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in p.key_averages() if pattern in e.key and _device_us(e) > 0]
    n = sum(e.count for e in mine)
    return (sum(_device_us(e) for e in mine) / n if n else float("nan")), n


def _capture(module, name, run, into=None):
    """Every input ``module.name`` gets in one ``run()``, in call order
    (copies on the same device, appended to ``into`` if given).  The launches
    of this run count as usual."""
    seen = [] if into is None else into
    inner = getattr(module, name)

    def keep(A):
        seen.append(A.clone())
        return inner(A)

    setattr(module, name, keep)
    try:
        run()
    finally:
        setattr(module, name, inner)
    return seen


def capture_k1_inputs(run):
    """Every input K1 gets in one ``run()``, in call order: the dense LDL^T
    (dense KKT, Schur roots, condensed systems) and the independent blocks
    of ``batched_block_ldlt_inv`` (the arrow backend's scenario blocks)."""
    seen = []
    return _capture(ldlt_mod, "block_ldlt",
                    lambda: _capture(block_tridiag, "block_ldlt", run, into=seen),
                    into=seen)


def time_k1_calls(run):
    """K1's device time inside one ``run()``: a CUDA event recorded on the
    current stream just before and just after every call of K1's wrapper
    (the same two names ``capture_k1_inputs`` watches).  Recording adds no
    synchronisation; a pair brackets the wrapper's own host work too, which
    shows only where the stream ran dry.  Returns (run's result, [(shape,
    ms) per call])."""
    pairs = []

    def timed(inner):
        def call(A):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = inner(A)
            end.record()
            pairs.append((tuple(A.shape), start, end))
            return res
        return call

    inners = [(m, m.block_ldlt) for m in (ldlt_mod, block_tridiag)]
    for m, inner in inners:
        m.block_ldlt = timed(inner)
    try:
        res = run()
    finally:
        for m, inner in inners:
            m.block_ldlt = inner
    torch.cuda.synchronize()
    return res, [(shape, s.elapsed_time(e)) for shape, s, e in pairs]


def capture_k2_inputs(run):
    """Every input K2 gets from the block cyclic reduction in one ``run()``."""
    return _capture(block_tridiag, "block_ldlt_inv", run)


BANDED_N, BANDED_BIG_N = 100_000, 1_000_000
ND_N = 24
# K2 launches per factorization at BANDED_N: 14 BCR levels of 12,500 blocks and the root
BANDED_K2_PER_FACTORIZATION = 15


def _setup(mode, dev):
    """(run, kernel counter, kernel name pattern) of the path ``mode``."""
    t0 = time.perf_counter()
    if mode == "multifrontal":
        kw = dict(OPTS, linear_solver="multifrontal")
        nlp = canonicalize_sparse(modellib.mittelmann_dist_control_3d(ND_N), Options(**kw),
                                  device=dev)
        print(f"set-up (canonicalize_sparse) mittelmann_dist_control_3d({ND_N}): "
              f"{time.perf_counter() - t0:.3f} s, KKT {nlp.chain.N} in "
              f"{len(nlp.chain.levels)} levels")
        return (lambda: solve(nlp, device=dev, **kw)), bl.block_ldlt, "ldlt_"
    if mode == "banded":
        nlp = canonicalize_sparse(modellib.luksan_vlcek1_flat(BANDED_N),
                                  Options(linear_solver="banded-bcr", **OPTS), device=dev)
        print(f"set-up (canonicalize_sparse) n={BANDED_N}: "
              f"{time.perf_counter() - t0:.3f} s, {nlp.chain.nb} blocks of {nlp.chain.b}")
        return ((lambda: solve(nlp, device=dev, linear_solver="banded-bcr", **OPTS)),
                k2.block_ldlt_inv, "gj_")
    if mode == "chained":
        nlp = canonicalize_chained(modellib.luksan_vlcek1(4096, 32), Options(**OPTS),
                                   device=dev)
        print(f"set-up (canonicalize_chained) n=4096 v=32: "
              f"{time.perf_counter() - t0:.3f} s")
        return (lambda: solve(nlp, device=dev, **OPTS)), k2.block_ldlt_inv, "gj_inv"
    family = stack_problems([modellib.hs071_family(0.005 * i) for i in range(BATCH)],
                            Options(**OPTS), device=dev)
    print(f"set-up (canonicalize + stack) B={BATCH}: "
          f"{time.perf_counter() - t0:.3f} s")
    return (lambda: solve_batched(family, device=dev, **OPTS)), bl.block_ldlt, "ldlt_"


def main(mode="hs071", logdir=None):
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: no CUDA device")
    if mode not in ("hs071", "chained", "banded", "multifrontal"):
        raise SystemExit(f"profile_main: unknown path {mode!r} (hs071, chained, banded "
                         f"or multifrontal)")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    run, kernel, pattern = _setup(mode, dev)
    run()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(res.iter_count.max())
    print(f"warm {mode} solve: {wall:.3f} s, {int((res.status == 0).sum())}/"
          f"{res.status.numel()} status 0, max iterations {iters} "
          f"({wall / max(iters, 1) * 1e3:.1f} ms/iteration), "
          f"{res.batched_factorizations} batched factorizations")

    logdir = logdir or tempfile.mkdtemp(prefix="profile_main_")
    launches0 = kernel.launches
    clocks = _Clocks()
    w0 = time.time()
    with profiling.trace(logdir) as p:
        run()
    clocks_solve = clocks.stop(w0, time.time())
    launches = kernel.launches - launches0
    spans = profiling.last_spans()
    times = profiling.self_times(spans)
    with open(os.path.join(logdir, "idle_by_span.json")) as fh:
        idle = json.load(fh)
    print(f"host time by span of the traced solve (count, total s, self s; trace in "
          f"{logdir}):")
    for name, (n, tot, own) in sorted(times.items(), key=lambda kv: -kv[1][2]):
        print(f"  {name:16s} {n:7d} {tot:9.3f} {own:9.3f}")
    busy_us = idle["busy_s"] * 1e6
    events = [e for e in p.key_averages()
              if str(e.device_type).endswith("CUDA") and _device_us(e) > 0
              and e.key not in times]
    print(f"device busy {busy_us / 1e3:.3f} ms of {idle['wall_s'] * 1e3:.1f} ms wall "
          f"(idle share {1 - idle['busy_s'] / idle['wall_s']:.4f}); "
          f"{sum(e.count for e in events)} kernel launches")
    print("device idle gaps by the span open on the host (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in idle["gaps_by_span_s"].items()))
    for e in sorted(events, key=lambda e: -_device_us(e))[:12]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    print(f"during the profiled solve: {clocks_solve}")
    # the port's own kernels, in the sources' anonymous namespace (the blocked
    # K1 and the device-memory K2 launch several per wrapper call)
    mine = [e for e in events if f"::{pattern}" in e.key]
    if mine and launches:
        t = sum(_device_us(e) for e in mine)
        print(f"{'K2' if mode in ('chained', 'banded') else 'K1'} device time: "
              f"{t / launches:.2f} us per wrapper launch over {launches} launches "
              f"({sum(e.count for e in mine)} CUDA launches; {t / 1e3:.3f} ms in all, "
              f"{t / busy_us:.4f} of the device's busy time)")
    if mode == "chained":
        g = torch.Generator(device="cpu").manual_seed(0)
        A = torch.randn((64, 156, 156), generator=g, dtype=torch.float64)
        A = (A + A.transpose(1, 2) + 312.0 * torch.eye(156, dtype=torch.float64)).to(dev)
        inputs = capture_k2_inputs(run)
        first = [X for X in inputs if tuple(X.shape) == (64, 156, 156)]
        for name, blocks in (
                ("seeded diagonally dominant blocks, (64, 156, 156)", [A]),
                (f"the solve's own first-level blocks, {len(first)} x (64, 156, 156)", first),
                (f"all {len(inputs)} of the solve's inputs, in its order", inputs)):
            ms, n, clk = _back_to_back(k2.block_ldlt_inv, blocks)
            print(f"K2 back to back on {name}: {ms * 1e3:.2f} us per launch "
                  f"(CUDA events, {n} launches); {clk}")
    elif mode == "multifrontal":
        trsm = [e for e in events if "trsm" in e.key.lower()]
        n_solves = times.get("kkt.backsolve", (0,))[0]
        n_trsm = sum(e.count for e in trsm)
        print(f"triangular solves: {n_trsm} kernel launches with 'trsm' in their name, "
              f"{sum(_device_us(e) for e in trsm) / 1e3:.3f} ms device time, over "
              f"{n_solves} back-solves ({n_trsm / max(n_solves, 1):.1f} per back-solve; "
              f"the cuBLAS kernel names as the profiler gives them)")
    elif mode == "banded":
        inputs = capture_k2_inputs(run)
        first = inputs[0::BANDED_K2_PER_FACTORIZATION]
        for name, blocks in (
                (f"the solve's own first-level blocks, {len(first)} x "
                 f"{tuple(first[0].shape)}", first),
                (f"all {len(inputs)} of the solve's inputs, in its order", inputs)):
            ms, n, clk = _back_to_back(k2.block_ldlt_inv, blocks)
            print(f"K2 back to back on {name}: {ms * 1e3:.2f} us per launch "
                  f"(CUDA events, {n} launches); {clk}")
        del inputs, first
        _banded_big(dev)
    else:
        inputs = capture_k1_inputs(run)
        shapes = sorted({tuple(A.shape) for A in inputs})
        ms, n, clk = _back_to_back(bl.block_ldlt, inputs)
        us, n_dev = device_us_per_launch(
            lambda: [bl.block_ldlt(A) for A in inputs], pattern)
        print(f"K1 back to back on the solve's {len(inputs)} inputs {shapes}: "
              f"{ms * 1e3:.2f} us per wrapper call (CUDA events, {n} calls; the "
              f"host's cost per call included); {us:.2f} us device time per launch "
              f"(torch.profiler, {n_dev} launches); {clk}")


def _banded_big(dev):
    """luksan_vlcek1_flat(1e6) through the banded backend: set-up, a cold
    and a warm solve, the warm solve's peak device memory."""
    t0 = time.perf_counter()
    nlp = canonicalize_sparse(modellib.luksan_vlcek1_flat(BANDED_BIG_N),
                              Options(linear_solver="banded-bcr", **OPTS), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = nlp.chain
    t0 = time.perf_counter()
    solve(nlp, device=dev, linear_solver="banded-bcr", **OPTS)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve(nlp, device=dev, linear_solver="banded-bcr", **OPTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(res.iter_count)
    print(f"banded n={BANDED_BIG_N}: {info.nb} blocks of {info.b}; set-up "
          f"(canonicalize_sparse) {setup_s:.3f} s; cold solve {cold_s:.3f} s; warm solve "
          f"{wall:.3f} s, status {int(res.status)}, {iters} iterations "
          f"({wall / max(iters, 1) * 1e3:.1f} ms/iteration), "
          f"{res.batched_factorizations} factorizations, objective {float(res.obj)!r}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")


if __name__ == "__main__":
    main(*sys.argv[1:3])
