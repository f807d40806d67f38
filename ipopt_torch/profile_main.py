"""Where a path's time goes on the card.

    python3 -m ipopt_torch.profile_main            # HS071 family, dense (K1)
    python3 -m ipopt_torch.profile_main chained    # LuksanVlcek1 4096/32 (K2)

The first stacks the 512-instance HS071 family on the card and solves it
with ``solve_batched``; the second solves ``luksan_vlcek1(4096, 32)`` (128
blocks of 156, block cyclic reduction) with ``solve``.  Both run in float64
with the options of ``bench.py:74-80``: once to warm up, then once under
``cProfile`` and once under ``torch.profiler``, and print:
- the card (``nvidia-smi`` name and power limit), the warm wall time and,
  for the chained path, ms per iteration;
- host time by solver function (cumulative seconds, from cProfile);
- device time: busy total, idle share of the wall, the kernels with the most
  device time, and the path's kernel's device time per launch (K1
  ``block_ldlt`` or K2 ``block_ldlt_inv``).
It needs a CUDA device.
"""
from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import time

import torch

from . import Options, canonicalize_chained, modellib, solve, solve_batched, stack_problems
from .linalg import block_ldlt as bl
from .linalg import block_ldlt_inv as k2

BATCH = 512
OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)
# solver functions whose cumulative host time is reported
FUNCS = ("solve_canonical", "initial_state", "_ipm_step_impl", "compute_hessian",
         "evaluate", "monotone_mu_update_components", "factorize_kkt", "ldlt",
         "block_ldlt", "solve_with_refinement", "ldlt_solve", "line_search",
         "try_soc", "_eval_theta_phi", "perform_restoration", "finalize",
         "stage_hessians", "stage_jacobians", "chained_factorize_kkt",
         "assemble_btd", "bcr_factorize", "block_ldlt_inv", "chained_solve_refined",
         "bcr_solve", "eval_jac_t")


def _device_us(e):
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def _setup(mode, dev):
    """(run, kernel counter, kernel name pattern) of the path ``mode``."""
    t0 = time.perf_counter()
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


def main(mode="hs071"):
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: no CUDA device")
    if mode not in ("hs071", "chained"):
        raise SystemExit(f"profile_main: unknown path {mode!r} (hs071 or chained)")
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

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = {}
    for (path, _, name), (_, _, tt, ct, _) in stats.stats.items():
        if name in FUNCS and "ipopt_torch" in path:
            rows[name] = (rows.get(name, (0.0, 0.0))[0] + ct,
                          rows.get(name, (0.0, 0.0))[1] + tt)
    print("host time by function (cumulative s, under cProfile):")
    for name in FUNCS:
        if name in rows:
            print(f"  {name:32s} {rows[name][0]:8.3f}")

    from torch.profiler import ProfilerActivity, profile
    launches0 = kernel.launches
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    launches = kernel.launches - launches0
    events = [e for e in p.key_averages()
              if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_p * 1e3:.1f} ms wall "
          f"(idle share {1 - busy_us / 1e6 / wall_p:.4f}); "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -_device_us(e))[:12]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    mine = [e for e in events if pattern in e.key and "kernel" in e.key]
    if mine and launches:
        t = sum(_device_us(e) for e in mine)
        print(f"{'K2' if mode == 'chained' else 'K1'} device time: "
              f"{t / launches:.2f} us per launch over {launches} launches "
              f"({t / 1e3:.3f} ms in all)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
