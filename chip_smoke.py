"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure exits non-zero before the result line):
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from the sources in this checkout (one nvcc
   per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the shapes
   its paths give it: K1 at (512, 7, 7) and at b = 1 ... 1024 (``K1_WIDTHS``,
   ragged widths among them) in float32 and float64, each stack with a
   guarded block, a -tiny pivot, a NaN and an inf block, timed beside its
   bound: the warp and CTA variants, and the blocked one in float32, bit
   for bit (NaN in the same places), the blocked one in float64 by
   ``block_ldlt.k1_rule`` (the finite pattern, per-block inertia, a backward
   error within ``K1_BACKWARD_FACTOR`` times the plain version's own plus
   b u);
   K1's CTA and blocked variants side by side at ``K1_VARIANT_SHAPES``, the
   times its plan follows; K2 at every BCR level of the chained path,
   (64|32|...|1, 156, 156) float64, at b = 1, 8, 16, 24, 32 in both types
   (the warp variant, bit for bit with a NaN and an inf block), 33, 48, 280
   and 408, in float32, and above the cluster variant's widths (the
   device-memory variant) at b = 417, 496, 568, 1288 in float64 and 577,
   1288 in float32, on seeded quasi-definite blocks, timed beside the bound;
4. the HS071 path: ``solve_batched`` on the 512-instance HS071 family in
   float64, with every kernel's launch count set to 0 just before and read
   just after; then K1 on every input one more warm solve gives it, bit for
   bit against its plain version, and its device time per launch on those
   inputs (K1's ``ms`` below); then E1: the same family with
   ``mu_strategy="adaptive"`` and with ``mehrotra_algorithm`` (512/512 at
   status 0, lane 0 at f*, every lane's iterations equal to the CPU's
   batched solve, lanes 0, 255 and 511 equal to the reference's, K1
   launches equal to the batched factorizations and bit-equal to its plain
   version on each solve's inputs);
5. a single ``solve(hs071)`` on the card;
6. the dense path at a size above K1's old limit: ``solve`` of LuksanVlcek1
   as a plain NLP at n = 100 (KKT 198 wide) on the card, held against the
   reference's float64 values and the same solve on the CPU;
7. the chained path: ``solve(luksan_vlcek1(4096, 32))`` in float64 (128
   blocks of 156, block cyclic reduction), cold then warm, the launch counts
   set to 0 before the warm solve and read after it, held against the
   reference's float64 values; ``luksan_vlcek1(256, 32)`` on the card
   against the same solve on the CPU; K2 on every input one more warm solve
   gives it, against its plain version, timed per BCR level; and
   ``luksan_vlcek1(1000, 100)`` (496-wide blocks: K2's device-memory
   variant) against the reference's values; E2: ``luksan_vlcek1(4096, 32)``
   with ``mu_strategy="adaptive"`` (one factorization, three solves per
   iteration) against the reference's values, n = 256 card against CPU, K2
   on that solve's inputs against its plain version;
8. the chained restoration: ``hard_chain`` widened to 200 and 500 variables
   per group (restoration blocks 204 and 504 wide), with the launch counts
   set to 0 before and read after, against the same solve on the CPU; E3:
   the warm start of ``mittelmann_bndry_control(10, 3)`` from example 1's
   iterate beside both cold solves, card against CPU, K2 held on the warm
   solve's inputs;
9. this slice's main path, the banded backend: ``solve(luksan_vlcek1_flat(
   100_000), linear_solver="banded-bcr")`` (12,500 blocks of 16), cold then
   warm, counts from 0 before the warm solve, held against the reference's
   values (K2 launched 15 times per factorization, K1 never);
   ``luksan_vlcek1_flat(2000)`` on the card against the CPU; K2 on every
   input one more warm solve gives it, against its plain version, timed per
   level (level 1's time is K2's ``ms`` below); then
   Mittelmann's distributed control at N = 30 against the reference and at
   N = 100 (76 blocks of 408; restoration 41 blocks of 1,288): its first
   iterations against the reference's, K2 against its plain version on
   every input of the solve whose launches are counted (its wall less the
   checks' seconds is the solve's own), the same solve with the plain
   version in K2's place (replayed from CUDA graphs) to the same status and
   the same breakdown of its linear solves at iteration 4, and the residual
   ratio in the step of iteration 4 with and without
   ``linear_system_scaling="mc19"``; E4: LuksanVlcek 4 and 5 at
   n = 1e5 with ``mu_strategy="adaptive"`` on the banded backend (status 0,
   n = 2000 card against CPU, K2 on each solve's inputs against its plain
   version); and the banded restoration (an infeasible chain, card against
   CPU);
10. slice F, float64: F1 the scenario (block-arrow) backend at full width,
   ``stochastic_qp(8192, 30)`` (scenario blocks (8192, 32, 32): K1's warp
   variant, then the log-depth inverse and its Newton step), status 0, K1
   twice per factorization (the blocks and the Schur root), S = 256 card
   against CPU, K1 bit-equal to its plain version on every input of the
   solve and timed on the scenario blocks; F2 the same at
   ``stochastic_qp(1024, 126)`` (blocks of 128: K1's CTA variant, then the
   substitution); F3 the arrow restoration (inconsistent scenario
   equalities, S = 4 and 1024, card against CPU); F4
   ``hessian_approximation="limited-memory"`` on the dense (the HS071
   family), chained (``luksan_vlcek1(4096, 32)``), arrow (F1's problem) and
   banded (``luksan_vlcek1_flat(1e5)``) backends, each at status 0 with
   its launches counted, the smaller instances card against CPU;
11. slice G, float64: G1 the multifrontal backend at full width,
   ``mittelmann_dist_control_3d(24)`` (41,472 KKT unknowns in 15 tree
   levels), cold (capturing K1's inputs) then warm with the counts from 0:
   status 0, K1 once per level of every factorization, held to its plain
   version on every input (``k1_agrees``: the blocked levels by the rule)
   and timed per level beside its bound, the plain version and
   ``torch.linalg.ldl_factor_ex``; N = 16 against the
   reference's values, N = 10 card against CPU; G2 K1 on seeded stacks at
   N = 32's widest fronts; G3 the multifrontal restoration (card against
   CPU) and ``mittelmann_dist_control(30)`` on the multifrontal and banded
   backends, each against the reference's values; G4 hs071 under
   ``linear_solver="minres"``, ``inexact_algorithm``, ``cg-penalty`` and
   ``penalty`` (card against CPU and the reference), the 1-D control with
   the inexact algorithm, and cg-penalty on ``luksan_vlcek1(4096, 32)``
   against the reference, K2 within its rule on every input;
12. slice H: H1 ``factorization_dtype="float32"`` under a float64 iterate
   (tol 1e-7) on the four factored backends at full width: the HS071
   family (K1 in float32 at (512, 7, 7), lanes 0, 255, 511 = the
   reference), ``luksan_vlcek1(4096, 32)`` and ``luksan_vlcek1_flat(1e5)``
   with mc19 (K2 in float32 on every BCR level, within its rule on every
   input), ``mittelmann_dist_control_3d(24)`` (K1 in float32 on every
   level, peak memory), each at a small size card against CPU and the
   reference's recorded float32-factorization values, and each kernel's
   float32 time per level beside its float64 time; H2 a float32 iterate
   with ``refinement_precision="double"`` (the family and the chained
   path); H3 ``linear_solver="dense-ldlt-blocked"`` (K1 on (1, 128, 128)
   panels, KKT 198 = the reference, KKT 1998 beside ``dense-ldlt``); H4
   sensitivity (the parametric HS071 family in one K1 launch; the chained
   1-D boundary control with K2); H5 the custom KKT solver, finite
   differences, the derivative checker, ``profiling.solve_timed`` and
   ``profiling.trace`` (K1's kernel events counted);
13. slice I: I1 ``luksan_vlcek1(4096, 32)`` with ``chain_shard=True`` over
   8 shards on the card (lanes of one batched BCR): the reference's (0, 7,
   21) and the unsharded solve's status and iterations, objective to 1e-9,
   ms per iteration beside the unsharded solve, K2 launches per
   factorization (interiors and reduced system), every K2 input held by
   MittK2Check's rule (stacked by shape; a block whose input is not finite
   by the finite pattern alone, and counted), the blocks whose pivots miss
   the chained path's PATH_TOL_D listed beside the plain version's own
   spread (``i1_pivot_diagnosis``), K2 timed on the interior and reduced
   levels; I2 the HS071 family with four device groups
   (``solve_batched(devices=...)``) lane for lane equal to the one-device
   solve; I3 ``stochastic_qp(8192, 30)`` in four scenario groups
   (``canonicalize_scenario(devices=...)``): F1's status and iterations,
   objective to 1e-9, K1 bit-equal on every input; I4 the hs071 .nl fixture
   through the AMPL CLI with its .sol read back, and LuksanVlcek1 written
   as .nl at n = 1e5, transcoded to binary, read (seconds printed) and
   solved with banded-bcr at the Python-built model's values; I5 the C
   library built by ``ipopt_torch.native.build`` and the reference's
   ``hs071_c`` run against it on the card;
14. one JSON line ``{"kernels": [...]}`` with each kernel's launches, error,
   time, the plain version's and the library call's time and the least time
   the card could take, both kernels' launches per path, K2's numbers per
   path and its launch plans, K1's per multifrontal level, and the launches
   of each variant over the whole run;
15. the last line: ``{"ok": true, "device": {...}}``.

Each phase's start is printed with the seconds since the script started.
It needs a CUDA device and the ``ipopt_torch`` package next to it;
without either it fails.  It imports nothing of JAX.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the peak rate of each
# type (float64 on the tensor cores; float32 outside them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}
FAMILY_B = 512
F_STAR = 17.0140171451792
# The chained path: LuksanVlcek1 at the shape of bench.py:302-314.  Reference
# values: ipopt_tpu.solve(modellib.luksan_vlcek1(4096, 32)) in float64 on the
# CPU, at commit 8e1099f, with Options(tol=1e-8, acceptable_tol=1e-6,
# acceptable_iter=10) (bench.py:74-80): status 0, 7 iterations, 21
# factorizations (counters.n_factorizations), objective below.
LV1_N, LV1_V = 4096, 32
LV1_STATUS, LV1_ITERS, LV1_FACTORIZATIONS = 0, 7, 21
LV1_OBJ = 6.2324586324370905
# K2 launches per BCR factorization of 128 blocks: 7 levels and the root.
LV1_K2_PER_FACTORIZATION = 8
# K2 widths above the cluster variant's (416 in float64, 576 in float32):
# the device-memory variant; 1288 is Mittelmann N = 100's restoration.
GLOBAL_WIDTHS_F64 = (417, 496, 568, 1288)
GLOBAL_WIDTHS_F32 = (577, 1288)
# K2's first BCR level on the banded configurations (nb, b): LuksanVlcek1
# flat 1e5 and its restoration NLP, Mittelmann N = 100 and its restoration;
# on the chained mittelmann_bndry_control(100) (51 blocks of 604); and
# LuksanVlcek 4 and 5 flat 1e5 (E4).
BANDED_STACKS = ((6250, 16), (8333, 24), (38, 408), (20, 1288), (25, 604), (12500, 8))


def log(msg):
    print(msg, flush=True)


T0 = time.perf_counter()


def phase(name):
    """A phase's start, with the seconds since the script started."""
    log(f"[{time.perf_counter() - T0:.1f} s] phase: {name}")


# Wall seconds of the checks and timings added in PR-11's slice, by label
# (printed before the kernels line): what each costs of the time limit.
CHECK_SECONDS = {}


@contextlib.contextmanager
def timed(label):
    """Adds the wall seconds of the block to CHECK_SECONDS[label]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        CHECK_SECONDS[label] = CHECK_SECONDS.get(label, 0.0) + time.perf_counter() - t0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kkt_like_blocks(rng, nb, b, dtype, tiny_block=True):
    """Seeded symmetric indefinite blocks shaped like the augmented KKT of
    an NLP: an SPD-ish (x, x) block plus constraint rows with a negative
    regularization; block 0 optionally has an exactly zero pivot (the
    tiny-pivot guard)."""
    import torch
    n = max(1, (2 * b) // 3)
    m = b - n
    A = np.zeros((nb, b, b))
    W = rng.standard_normal((nb, n, n))
    A[:, :n, :n] = 0.5 * (W + W.transpose(0, 2, 1)) + 3.0 * np.eye(n)
    if m:
        J = rng.standard_normal((nb, m, n))
        A[:, n:, :n] = J
        A[:, :n, n:] = J.transpose(0, 2, 1)
        A[:, n:, n:] = -1e-3 * np.eye(m)
    if tiny_block and b > 1:
        k = b // 2
        A[0, k, :] = 0.0
        A[0, :, k] = 0.0
    return torch.as_tensor(A, dtype=dtype)


def time_cuda(fn, reps=200, warmup=10):
    """Milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_values(x, y):
    """torch.equal with NaN in the same places (and -0.0 equal to +0.0)."""
    import torch
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(torch.where(nx, 0.0, x),
                                                    torch.where(ny, 0.0, y)))


def k1_bound(nb, b, dtype):
    """(bound ms, bound_by, bytes, ops) of nb LDL^T factorizations of width b:
    the lower triangle of A read, L (b x b) and d written, against the least
    work of an unpivoted LDL^T: at each step with s rows below the pivot, s
    quotients for the column of L and one multiply-add (two operations) per
    entry of the trailing lower triangle, s (s + 1) / 2 of them."""
    import torch
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * nb * (b * (b + 1) // 2 + b * b + b)
    ops = nb * sum(s * (s + 1) + s for s in range(b))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)[6:]] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    return bound_ms, bound_by, nbytes, ops


# K1 is held to its plain version at these widths, in float32 and float64,
# each stack with a guarded block (an exactly zero pivot), from 3 blocks a
# block with a -tiny pivot, from 4 a block with a NaN entry, and a block with
# an inf entry; 241, 345 and 1000 are ragged (not a multiple of the blocked
# variant's panel of 32).
K1_WIDTHS = (1, 7, 8, 16, 32, 33, 64, 156, 170, 241, 345, 416, 1000, 1024)



def k1_blocks(rng, nb, b, dtype):
    """Seeded KKT-like blocks: block 0 with an exactly zero pivot (the whole
    block at b = 1), the last block with an inf entry below the diagonal
    (and its mirror); from nb = 3 block 1 with a -tiny pivot (a subnormal
    negative pivot and zeros beside it), from nb = 4 block nb - 2 with a NaN
    entry below the diagonal (and its mirror)."""
    import torch
    A = kkt_like_blocks(rng, nb, b, dtype)
    if b == 1:
        A[0] = 0.0
    if nb > 1:
        i, j = b - 1, b // 2
        A[-1, i, j] = A[-1, j, i] = float("inf")
    if nb > 2:
        k = b // 2
        A[1, k, :] = 0.0
        A[1, :, k] = 0.0
        A[1, k, k] = -1e-310 if dtype == torch.float64 else -1e-40
    if nb > 3 and b > 1:
        i, j = b - 1, b // 3
        A[-2, i, j] = A[-2, j, i] = float("nan")
    return A


def k1_agrees(A, L_k, d_k, L_p, d_p, pivot_tol=0.0):
    """K1 against its plain version on one input, by its variant: the warp
    and CTA variants, and the blocked one in float32, bit for bit (NaN in the
    same places); the blocked one in float64 by k1_rule.  Returns (ok, why,
    "bit-equal" or "rule", worst backward ratio or 0)."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    variant = bl.plan(A.shape[0], A.shape[-1], A.dtype).variant
    if variant != "blocked" or A.dtype == torch.float32:
        ok = same_values(L_k, L_p) and same_values(d_k, d_p)
        return ok, f"bit-equal {ok}", "bit-equal", 0.0
    ok, why, worst = bl.k1_rule(A, L_k, d_k, L_p, d_p, pivot_tol)
    return ok, why, "rule", worst


# K1's CTA and blocked variants timed on the same seeded float64 stacks
# (block_ldlt.plan follows these times where both run): small nb at large b,
# and the multifrontal levels and scenario blocks the CTA variant takes.
K1_VARIANT_SHAPES = ((1, 40), (1, 64), (1, 128), (1, 198), (1, 240), (30, 240),
                     (104, 161), (16, 156), (156, 82), (258, 56), (300, 64),
                     (400, 48), (362, 36), (1024, 128))


def check_k1(dev, card):
    """K1 against block_ldlt_plain on the card at every width of K1_WIDTHS in
    both types (the warp and CTA variants bit for bit, torch.equal with NaN
    in the same places; the blocked variant by k1_rule); its time at each
    float64 shape beside its bound; the CTA and blocked variants side by
    side at K1_VARIANT_SHAPES.  Returns the seeded (512, 7, 7) float64
    timings and the side-by-side times."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.profile_main import device_us_per_launch
    rng = np.random.default_rng(0)
    cases = [(FAMILY_B, 7)] + [(64 if b <= 64 else 16 if b <= 170 else 4, b)
                               for b in K1_WIDTHS]
    cases += [(1, 198), (1, 1024)]
    for dtype in (torch.float64, torch.float32):
        for nb, b in cases:
            A = k1_blocks(rng, nb, b, dtype).to(dev)
            before = bl.block_ldlt.launches
            L_k, d_k = bl.block_ldlt(A)
            torch.cuda.synchronize()
            launched = bl.block_ldlt.launches - before
            with timed(f"K1 plain version at b >= 1000, {str(dtype)[6:]}"
                       if b >= 1000 else "K1 plain version at b < 1000"):
                L_p, d_p = bl.block_ldlt_plain(A)
                torch.cuda.synchronize()
            agree, why, _, _ = k1_agrees(A, L_k, d_k, L_p, d_p)
            ok = launched == 1 and agree
            fin = torch.isfinite(L_p) & torch.isfinite(L_k)
            err = float(torch.where(fin, L_k - L_p, 0.0).abs().max())
            pl = bl.plan(nb, b, dtype)
            line = (f"K1 check nb={nb} b={b} {str(dtype)[6:]}: plan {pl.variant} "
                    f"rows={pl.rows} lanes={pl.lanes} grid={pl.grid} threads={pl.threads} "
                    f"shared={pl.smem} B, {pl.kernels} CUDA launches per call; {why} "
                    f"(max abs err on finite entries {err:.3e}; NaN entries "
                    f"{int(torch.isnan(L_p).sum())})")
            del L_k, d_k, L_p, d_p
            if dtype == torch.float64:
                # timed without the inf block, whose warp or CTA takes the
                # library division
                At = A[:-1] if nb > 1 else A
                bound_ms, bound_by, _, _ = k1_bound(At.shape[0], b, dtype)
                if pl.variant == "blocked":
                    us = time_cuda(lambda: bl.block_ldlt(At), reps=5, warmup=1) * 1e3
                    source = "CUDA events per call"
                else:
                    us, _ = device_us_per_launch(lambda: bl.block_ldlt(At), "ldlt_",
                                                 rounds=50 if b <= 64 else 10)
                    source = "device time per launch"
                line += (f"; {us:.2f} us ({source}) at ({At.shape[0]}, {b}, {b}), bound "
                         f"{bound_ms * 1e3:.4f} us ({bound_by}), "
                         f"{us / (bound_ms * 1e3):.1f}x")
            log(line + f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K1 differs from its plain version at nb={nb} "
                                 f"b={b} {dtype} (launches {launched}): {why}")
    variants = {}
    for dtype in (torch.float64, torch.float32):
        t_dtype = time.perf_counter()
        for nb, b in K1_VARIANT_SHAPES:
            A = kkt_like_blocks(rng, nb, b, dtype, tiny_block=False).to(dev)
            L_p, d_p = bl.block_ldlt_plain(A)
            row = {}
            for variant in ("cta", "blocked"):
                pl = bl.variant_plan(variant, nb, b, A.dtype)
                L_k, d_k = bl.launch(A, pl)
                agree, why, _ = (bl.k1_rule(A, L_k, d_k, L_p, d_p)
                                 if variant == "blocked" and dtype == torch.float64
                                 else (same_values(L_k, L_p) and same_values(d_k, d_p),
                                       "bit-equal", 0.0))
                if not agree:
                    raise SystemExit(f"K1 {variant} at ({nb}, {b}) {dtype} differs from "
                                     f"its plain version: {why}")
                row[variant] = time_cuda(lambda: bl.launch(A, pl), reps=10, warmup=2)
            del L_k, d_k, L_p, d_p
            bound_ms, bound_by, _, _ = k1_bound(nb, b, dtype)
            chosen = bl.plan(nb, b, dtype).variant
            variants[f"{nb}x{b}_{str(dtype)[6:]}"] = dict(row, plan=chosen, bound_ms=bound_ms)
            log(f"K1 variants ({nb}, {b}, {b}) {str(dtype)[6:]}, seeded: cta "
                f"{row['cta']:.4f} ms, blocked {row['blocked']:.4f} ms per call (CUDA "
                f"events), bound {bound_ms:.6f} ms ({bound_by}); the plan takes {chosen}; "
                f"card {card}")
        CHECK_SECONDS[f"K1 CTA against blocked, {str(dtype)[6:]}"] = (
            time.perf_counter() - t_dtype)
    A = kkt_like_blocks(rng, FAMILY_B, 7, torch.float64).to(dev)
    ms = time_cuda(lambda: bl.block_ldlt(A))
    us, n = device_us_per_launch(lambda: bl.block_ldlt(A), "ldlt_", rounds=50)
    plain_ms = time_cuda(lambda: bl.block_ldlt_plain(A), reps=50)
    ldl_ms = time_cuda(lambda: torch.linalg.ldl_factor_ex(A), reps=50)
    log(f"K1 timing (512, 7, 7) float64 on seeded blocks: {us:.2f} us device time per "
        f"launch (torch.profiler, {n} launches), {ms:.4f} ms per wrapper call, plain "
        f"{plain_ms:.4f} ms; torch.linalg.ldl_factor_ex (Bunch-Kaufman pivoting, "
        f"another function: a yardstick only) {ldl_ms:.4f} ms; card {card}")
    return dict(seeded_us=us, seeded_call_ms=ms, plain_ms=plain_ms, ldl_factor_ms=ldl_ms,
                variants=variants)


def check_k1_on_path(dev, inputs, card):
    """K1 on every input the warm HS071 solve gave it (captured from one more
    warm solve: the initial multipliers' (512, 2, 2) system, then the KKT
    factorizations, (512, 7, 7) or fewer lanes where some have converged),
    bit-equal to its plain version, and timed on them: device time per
    launch (torch.profiler) on the (512, 7, 7) inputs, which is the kernel's
    ms, and on all of them; wrapper time per call."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg.block_ldlt import _safe_pivot
    from ipopt_torch.profile_main import device_us_per_launch
    main = [A for A in inputs if tuple(A.shape) == (FAMILY_B, 7, 7)]
    if not main:
        raise SystemExit(f"K1 on the path: no (512, 7, 7) input among "
                         f"{[tuple(A.shape) for A in inputs]}")
    tiny = torch.finfo(torch.float64).tiny
    n_guarded = n_slow = 0
    max_abs_err = 0.0
    for A in inputs:
        L_k, d_k = bl.block_ldlt(A)
        L_p, d_p = bl.block_ldlt_plain(A)
        ok, why, _, _ = k1_agrees(A, L_k, d_k, L_p, d_p)
        if not ok:
            raise SystemExit(f"K1 on the path: an input of {tuple(A.shape)} where "
                             f"the kernel differs from its plain version: {why}")
        for x, y in ((L_k, L_p), (d_k, d_p)):
            fin = torch.isfinite(x) & torch.isfinite(y)
            max_abs_err = max(max_abs_err, float(torch.where(fin, x - y, 0.0).abs().max()))
        n_guarded += int((~(d_p.abs() > tiny)).sum())
        sp = _safe_pivot(d_p)
        pow2 = torch.frexp(sp)[0].abs() == 0.5
        n_slow += int((((sp.abs() < 2.0 ** -100) | (sp.abs() > 2.0 ** 100)) & ~pow2).sum())
    us, n = device_us_per_launch(lambda: [bl.block_ldlt(A) for A in main], "ldlt_",
                                 rounds=20)
    us_all, n_all = device_us_per_launch(lambda: [bl.block_ldlt(A) for A in inputs],
                                         "ldlt_", rounds=20)
    call_ms = time_cuda(lambda: [bl.block_ldlt(A) for A in main], reps=20) / len(main)
    bound_ms, bound_by, nbytes, ops = k1_bound(FAMILY_B, 7, torch.float64)
    log(f"K1 on the path: {len(inputs)} inputs from the warm HS071 solve "
        f"({[tuple(A.shape) for A in inputs]}), each bit-equal to the plain version; "
        f"{n_guarded} guarded pivots, {n_slow} other pivots outside the certificate's "
        f"range; {us:.2f} us device time per launch on the {len(main)} (512, 7, 7) "
        f"inputs (torch.profiler, {n} launches), {us_all:.2f} us on all {len(inputs)} "
        f"({n_all} launches); {call_ms:.4f} ms per wrapper call; bound {bound_ms:.6f} "
        f"ms ({bound_by}: {nbytes} B, {ops} ops); criterion <= 5 us per launch at "
        f"(512, 7, 7): {'met' if us <= 5.0 else 'not met'}; card {card}")
    return dict(max_abs_err=max_abs_err, ms=us * 1e-3, all_inputs_ms=us_all * 1e-3,
                call_ms=call_ms, bound_ms=bound_ms, bound_by=bound_by)


def gj_flops(nb, b):
    """Least floating-point work of nb block inverses with their pivots:
    b^3 multiply-adds (2 b^3 flops) per block."""
    return 2 * nb * b ** 3


def quasi_definite_blocks(rng, nb, b, dtype, tiny_block=True):
    """Seeded KKT-shaped quasi-definite blocks: a positive definite (x, x)
    block (random symmetric, shifted past the semicircle's edge sqrt(2n) by
    one), constraint rows and a -1e-3 regularization; block 0 optionally has
    an exactly zero pivot.  The class the reference tests its panel sweep on
    (tests/test_block_tridiag.py:153-160): on merely indefinite blocks the
    unpivoted panel sweep amplifies rounding, and two summation orders
    differ far above the tolerances below."""
    import torch
    n = max(1, (2 * b) // 3)
    m = b - n
    A = np.zeros((nb, b, b))
    W = rng.standard_normal((nb, n, n))
    A[:, :n, :n] = 0.5 * (W + W.transpose(0, 2, 1)) + (np.sqrt(2 * n) + 1) * np.eye(n)
    if m:
        J = rng.standard_normal((nb, m, n))
        A[:, n:, :n] = J
        A[:, :n, n:] = J.transpose(0, 2, 1)
        A[:, n:, n:] = -1e-3 * np.eye(m)
    if tiny_block and b > 1:
        A[0, b // 2, :] = 0.0
        A[0, :, b // 2] = 0.0
    return torch.as_tensor(A, dtype=dtype)


def k2_small_blocks(rng, nb, b, dtype):
    """Seeded KKT-like blocks for K2's warp variant (b <= 32): block 0 with
    an exactly zero pivot, the last block with an inf entry and, from
    nb = 3, the one before it with a NaN entry (each with its mirror)."""
    A = kkt_like_blocks(rng, nb, b, dtype)
    if b == 1:
        A[0] = 0.0
    if nb > 1:
        i, j = b - 1, b // 2
        A[-1, i, j] = A[-1, j, i] = float("inf")
    if nb > 2:
        i, j = b - 1, b // 3
        A[-2, i, j] = A[-2, j, i] = float("nan")
    return A


def k2_tolerance(b, dtype):
    """(tolerance on |dAinv| / max(1, max|Ainv|), tolerance on |dd| / |d|,
    reason) of K2 against its plain version on the card."""
    import torch
    from ipopt_torch.linalg.block_ldlt_inv import PANEL
    if b <= PANEL:
        return 0.0, 0.0, "tol 0: one scalar sweep, the same IEEE operations in order"
    reason = ("the panel products run as fused multiply-adds in another summation "
              "order than torch.matmul")
    if dtype == torch.float64:
        return 1e-11, 1e-10, f"tol 1e-11 on Ainv, 1e-10 on d: {reason} (FP64 tensor cores)"
    return 1e-4, 1e-4, f"tol 1e-4: {reason} (IEEE FFMA on the CUDA cores), in float32"


def check_k2(dev):
    """K2 against block_ldlt_inv_plain on the card, at every BCR level of the
    chained path and other widths; returns a dict of the error at the
    main-path shapes, the timings and level 1's plan."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.linalg.ldlt import _pivot_tols
    rng = np.random.default_rng(1)
    b_main = 156
    main = [(ne, b_main, torch.float64, quasi_definite_blocks)
            for ne in (64, 32, 16, 8, 4, 2, 1)]
    cases = [(16, b, dt, k2_small_blocks) for b in (1, 8, 16, 24, 32)
             for dt in (torch.float64, torch.float32)]
    cases += [(16, b, torch.float64, quasi_definite_blocks) for b in (33, 48)] + main
    cases += [(4, 280, torch.float64, quasi_definite_blocks),
              (2, 408, torch.float64, quasi_definite_blocks),
              (64, b_main, torch.float32, quasi_definite_blocks)]
    # above the cluster variant's widths: the device-memory variant
    cases += [(2, b, torch.float64, quasi_definite_blocks) for b in GLOBAL_WIDTHS_F64]
    cases += [(2, b, torch.float32, quasi_definite_blocks) for b in GLOBAL_WIDTHS_F32]
    main_err = 0.0
    global_ms = {}
    for nb, b, dtype, make in cases:
        t_case = time.perf_counter()
        A = make(rng, nb, b, dtype).to(dev)
        d_k, inv_k = k2.block_ldlt_inv(A)
        torch.cuda.synchronize()
        d_p, inv_p = k2.block_ldlt_inv_plain(A)
        torch.cuda.synchronize()
        tol_inv, tol_d, why = k2_tolerance(b, dtype)
        pl = k2.plan(nb, b, dtype)
        if b <= k2.PANEL:
            # the warp variant: bit for bit, NaN in the same places
            ok = same_values(inv_k, inv_p) and same_values(d_k, d_p)
            ms = time_cuda(lambda: k2.block_ldlt_inv(A), reps=20, warmup=2)
            log(f"K2 check nb={nb} b={b} {str(dtype)[6:]} ({make.__name__}): plan "
                f"{pl.variant} lanes={pl.lanes} grid={pl.grid} threads={pl.threads} "
                f"shared={pl.smem} B; bit-equal to the plain version (NaN entries "
                f"{int(torch.isnan(inv_p).sum())}) {ok}; {ms:.4f} ms per launch -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 differs from its plain version at nb={nb} b={b} "
                                 f"{dtype}")
            label = "K2 warp variant, seeded b <= 32"
            CHECK_SECONDS[label] = (CHECK_SECONDS.get(label, 0.0)
                                    + time.perf_counter() - t_case)
            continue
        err_inv = float((inv_k - inv_p).abs().max())
        err_d = float((d_k - d_p).abs().max())
        # block 0's guarded pivot puts 1/tiny into its inverse: scale by the rest
        scale = max(1.0, float(inv_p[1:].abs().max())) if nb > 1 else 1.0
        rel_inv = err_inv / scale
        rel_d = float(((d_k - d_p).abs() / d_p.abs()).nan_to_num(0.0, 0.0, 0.0).max())
        d_ok = bool(((d_k - d_p).abs() <= tol_d * d_p.abs()).all())
        live = d_p.abs() > _pivot_tols(d_p.abs().amax(-1), dtype, 0.0)[:, None]
        signs_ok = bool(((torch.sign(d_k) == torch.sign(d_p)) | ~live).all())
        nonsingular = live.all(-1)
        A64, inv64 = A[nonsingular].double(), inv_k[nonsingular].double()
        resid = float((A64 @ inv64 - torch.eye(b, dtype=torch.float64, device=dev))
                      .abs().max()) if bool(nonsingular.any()) else 0.0
        finite = bool(torch.isfinite(inv_k).all() and torch.isfinite(d_k).all())
        ok = rel_inv <= tol_inv and d_ok and signs_ok and finite
        ms = time_cuda(lambda: k2.block_ldlt_inv(A), reps=5 if b > 1000 else 20, warmup=2)
        bound_ms, bound_by, _, _ = k2_bound(nb, b, dtype)
        if pl.variant == "global":
            global_ms[f"{b}_{str(dtype)[6:]}"] = dict(ms=ms, bound_ms=bound_ms,
                                                     bound_by=bound_by, nb=nb)
        log(f"K2 check nb={nb} b={b} {str(dtype)[6:]} ({make.__name__}): plan {pl.variant} "
            f"cs={pl.cs} strip rows={list(pl.rows)} shared={pl.smem} B; max_abs_err "
            f"Ainv={err_inv:.3e} (rel {rel_inv:.3e}) d={err_d:.3e} (rel {rel_d:.3e}) "
            f"({why}) signs_equal={signs_ok} tiny_pivots={int((~live).sum())} "
            f"max|A Ainv - I| on {int(nonsingular.sum())} nonsingular blocks={resid:.3e}; "
            f"{ms:.4f} ms per launch, bound {bound_ms:.6f} ms ({bound_by}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version at "
                             f"nb={nb} b={b} {dtype} ({make.__name__})")
        if (nb, b, dtype, make) in main:
            main_err = max(main_err, err_inv, err_d)
    # the first BCR levels of the banded configurations, on seeded blocks:
    # LuksanVlcek1 flat 1e5 (6250 x 16) and its restoration NLP (8333 x 24),
    # Mittelmann N = 100 (38 x 408) and its restoration NLP (20 x 1288),
    # mittelmann_bndry_control(100) chained (25 x 604)
    banded_stacks = {}
    for nb, b in BANDED_STACKS:
        A = quasi_definite_blocks(rng, nb, b, torch.float64, tiny_block=False).to(dev)
        d_k, inv_k = k2.block_ldlt_inv(A)
        d_p, inv_p = k2.block_ldlt_inv_plain(A)
        tol_inv, tol_d, _ = k2_tolerance(b, torch.float64)
        rel_inv = float((inv_k - inv_p).abs().max()) / max(1.0, float(inv_p.abs().max()))
        rel_d = float(((d_k - d_p).abs() / d_p.abs()).max())
        pl = k2.plan(nb, b, torch.float64)
        ms = time_cuda(lambda: k2.block_ldlt_inv(A), reps=5 if b > 1000 else 20, warmup=2)
        plain_ms = time_cuda(lambda: k2.block_ldlt_inv_plain(A), reps=2, warmup=1)
        inv_ms = time_cuda(lambda: torch.linalg.inv_ex(A), reps=5, warmup=1)
        bound_ms, bound_by, nbytes, ops = k2_bound(nb, b)
        ok = (same_values(inv_k, inv_p) and same_values(d_k, d_p) if b <= k2.PANEL
              else rel_inv <= tol_inv and rel_d <= tol_d)
        log(f"K2 banded stack ({nb}, {b}, {b}) float64, seeded: plan {pl.variant} "
            f"cs={pl.cs} lanes={pl.lanes} grid={pl.grid} shared={pl.smem} B; rel err "
            f"Ainv {rel_inv:.3e}, d {rel_d:.3e} ({'bit-equal' if b <= k2.PANEL else 'tol'}); "
            f"{ms:.4f} ms per launch, plain {plain_ms:.4f} ms, torch.linalg.inv_ex "
            f"{inv_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} "
            f"flops), {ms / bound_ms:.1f}x -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version at ({nb}, {b}, {b})")
        banded_stacks[f"{nb}x{b}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=inv_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          plan=pl.variant, cs=pl.cs)
        del A, d_k, inv_k, d_p, inv_p
    # level 1's shape on seeded blocks without a guarded pivot, for comparison
    # with the solve's own blocks (check_k2_on_path)
    A = quasi_definite_blocks(rng, 64, b_main, torch.float64, tiny_block=False).to(dev)
    seeded_ms = time_cuda(lambda: k2.block_ldlt_inv(A), reps=100)
    log(f"K2 timing (64, 156, 156) float64 on seeded quasi-definite blocks: "
        f"{seeded_ms:.4f} ms per launch")
    return dict(seeded_max_abs_err=main_err, seeded_ms=seeded_ms,
                device_memory_variant=global_ms, banded_stacks=banded_stacks)


def k2_bound(nb, b, dtype=None):
    """(bound ms, bound_by, bytes, flops) of nb block inverses of width b
    (float64 unless ``dtype`` says otherwise): A read, Ainv and d written,
    against 2 b^3 flops per block."""
    name = "float64" if dtype is None else str(dtype)[6:]
    nbytes = (8 if name == "float64" else 4) * (2 * nb * b * b + nb * b)
    ops = gj_flops(nb, b)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[name] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    return bound_ms, bound_by, nbytes, ops


# Limits of K2 against its plain version on the solve's own blocks without a
# guarded pivot: d to PATH_TOL_D relative; Ainv to the larger of PATH_TOL_INV
# max(1, max|Ainv|) (the seeded checks' limit) and b eps g max|Ainv|^2, the
# first-order change of the inverse under a backward error of b ulps of g,
# the largest entry the unpivoted sweep meets (at least max|A| and max|d|).
# The BCR's upper levels and roots are far worse conditioned than seeded
# blocks, and their sweeps grow: pivots reach 1e6 on entries of 1e2.  The
# limits are float64's; float32 blocks take the same number of ulps of
# float32 (the limits times eps(float32) / eps(float64)).
PATH_TOL_INV, PATH_TOL_D = 1e-11, 1e-10


def _ulps(dtype):
    """The path limits' scale for ``dtype`` against float64."""
    import torch
    return torch.finfo(dtype).eps / torch.finfo(torch.float64).eps


def _k2_compare(A, d_k, inv_k, d_p, inv_p):
    """The rule ``check_k2_on_path`` holds K2 (d_k, inv_k) to beside its
    plain version (d_p, inv_p) on the blocks A (nb, b, b): equal inertia
    counts and live pivot signs and the same finite pattern on every block;
    Ainv and d within the limits above on the blocks without a guarded
    pivot.  Returns the verdict, the reason and the worst errors."""
    import torch
    from ipopt_torch.linalg.block_tridiag import _block_inertia_counts
    from ipopt_torch.linalg.ldlt import _pivot_tols
    tiny = torch.finfo(A.dtype).tiny
    eps = torch.finfo(A.dtype).eps
    tol_inv, tol_d = PATH_TOL_INV * _ulps(A.dtype), PATH_TOL_D * _ulps(A.dtype)
    guard = ~(d_p.abs() > tiny)        # zero or NaN pivots: the guard fired
    guarded = guard.any(-1)
    counts_k = torch.stack(_block_inertia_counts(d_k[:, None], 0.0))
    counts_p = torch.stack(_block_inertia_counts(d_p[:, None], 0.0))
    live = d_p.abs() > _pivot_tols(d_p.abs().amax(-1), A.dtype, 0.0)[:, None]
    signs_ok = bool(((torch.sign(d_k) == torch.sign(d_p)) | ~live).all())
    pattern_ok = (torch.equal(torch.isfinite(inv_k), torch.isfinite(inv_p))
                  and torch.equal(torch.isfinite(d_k), torch.isfinite(d_p)))
    fin = torch.isfinite(inv_p) & torch.isfinite(inv_k)
    diff = torch.where(fin, inv_k - inv_p, 0.0).abs().amax((1, 2))
    scale = torch.where(fin, inv_p, 0.0).abs().amax((1, 2)).clamp(min=1.0)
    rel_inv = diff / scale
    b = A.shape[-1]
    growth = torch.maximum(A.abs().amax((1, 2)),
                           d_p.abs().nan_to_num(0.0, 0.0, 0.0).amax(-1))
    limit = torch.maximum(tol_inv * scale, b * eps * growth * scale ** 2)
    ratio = diff / limit
    rel_d = ((d_k - d_p).abs() / d_p.abs()).nan_to_num(0.0, 0.0, 0.0).amax(-1)
    worst = {"regular": [0.0, 0.0], "guarded": [0.0, 0.0]}
    for key, mask in (("regular", ~guarded), ("guarded", guarded)):
        if bool(mask.any()):
            worst[key] = [float(rel_inv[mask].max()), float(rel_d[mask].max())]
    reg = ~guarded
    max_abs_err = worst_ratio = worst_resid = 0.0
    if bool(reg.any()):
        max_abs_err = max(float(diff[reg].max()), float((d_k - d_p)[reg].abs().max()))
        worst_ratio = float(ratio[reg].max())
        eye = torch.eye(b, dtype=A.dtype, device=A.device)
        res_k = (A[reg] @ inv_k[reg] - eye).abs().amax((1, 2))
        res_p = (A[reg] @ inv_p[reg] - eye).abs().amax((1, 2))
        worst_resid = float((res_k / res_p.clamp(min=eps)).max())
    close = bool((ratio[reg] <= 1.0).all() and (rel_d[reg] <= tol_d).all())
    # up to b = 32 the warp variant runs the plain version's sweep: bit for bit
    if b <= 32:
        close = close and same_values(inv_k, inv_p) and same_values(d_k, d_p)
    inertia_ok = torch.equal(counts_k, counts_p)
    why = (f"disagrees with its plain version (inertia equal {inertia_ok}, signs "
           f"{signs_ok}, finite pattern {pattern_ok}, regular blocks within limits "
           f"{close}: |dAinv| / limit {worst_ratio:.3e}, rel d "
           f"{float(rel_d[reg].max()) if bool(reg.any()) else 0.0:.3e})")
    return dict(ok=inertia_ok and signs_ok and pattern_ok and close, why=why,
                guard=guard, guarded=guarded, worst=worst, max_abs_err=max_abs_err,
                worst_ratio=worst_ratio, worst_resid=worst_resid)


def check_k2_stacked(inputs, path, card):
    """K2 on every input a solve gave it, as launched, against its plain
    version run once on all the inputs of each shape stacked (the plain
    version treats each block on its own), by ``_k2_compare``'s rule.  For
    solves with thousands of inputs, where one plain call per input would
    take minutes."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    by_shape = {}
    for A in inputs:
        by_shape.setdefault(tuple(A.shape), []).append(A)
    worst_ratio = max_abs_err = 0.0
    for shape, group in sorted(by_shape.items()):
        outs = [k2.block_ldlt_inv(A) for A in group]
        A_all = torch.cat(group)
        d_k = torch.cat([o[0] for o in outs])
        inv_k = torch.cat([o[1] for o in outs])
        del outs
        d_p, inv_p = k2.block_ldlt_inv_plain(A_all)
        c = _k2_compare(A_all, d_k, inv_k, d_p, inv_p)
        n_guarded = int(c["guarded"].sum())
        log(f"K2 on the {path} path, {len(group)} inputs of {shape}: {n_guarded} of "
            f"{A_all.shape[0]} blocks with a guarded pivot; |dAinv| / limit "
            f"{c['worst_ratio']:.3e}, max rel err Ainv {c['worst']['regular'][0]:.3e}, d "
            f"{c['worst']['regular'][1]:.3e} on the others -> "
            f"{'ok' if c['ok'] else 'FAIL'}")
        if not c["ok"]:
            raise SystemExit(f"K2 on the {path} path: inputs of {shape} {c['why']}")
        worst_ratio = max(worst_ratio, c["worst_ratio"])
        max_abs_err = max(max_abs_err, c["max_abs_err"])
        del A_all, d_k, inv_k, d_p, inv_p
    log(f"K2 on the {path} path: all {len(inputs)} inputs within the rule; card {card}")
    return dict(inputs=len(inputs), shapes=[list(k) for k in sorted(by_shape)],
                worst_ratio=worst_ratio, max_abs_err=max_abs_err)


def check_k2_on_path(dev, inputs, per, path, card):
    """K2 on every input a warm solve of ``path`` gave it (captured from one
    more warm solve; ``per`` launches per factorization, one per BCR level
    and the root), against its plain version, and timed per BCR level on
    those inputs.  Held on every block: the inertia counts the retry loop
    reads from its pivots, the signs of live pivots, and where Ainv and d
    are finite.  Held on blocks without a guarded pivot: Ainv and d to the
    limits stated above PATH_TOL_INV (up to b = 32 the kernel runs the plain
    version's scalar sweep and equals it bit for bit).  A block with a
    guarded (zero or NaN) pivot comes from a retry trial, which the retry
    loop rejects on its inertia alone; its errors are printed."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.linalg.block_ldlt import _safe_pivot
    if not inputs or len(inputs) % per:
        raise SystemExit(f"K2 on the {path} path: {len(inputs)} inputs, not a multiple "
                         f"of {per}")
    names = [f"ne={A.shape[0]}" for A in inputs[:per - 1]] + ["root"]
    b_path = inputs[0].shape[-1]
    level_ms, worst = [], {"regular": [0.0, 0.0], "guarded": [0.0, 0.0]}
    worst_ratio = worst_resid = 0.0
    max_abs_err, first_guarded = 0.0, []
    for lev, name in enumerate(names):
        group = inputs[lev::per]
        n_blocks = n_guarded_blocks = n_guarded = n_pow2 = n_slow = 0
        for A in group:
            d_k, inv_k = k2.block_ldlt_inv(A)
            d_p, inv_p = k2.block_ldlt_inv_plain(A)
            c = _k2_compare(A, d_k, inv_k, d_p, inv_p)
            guard, guarded = c["guard"], c["guarded"]
            for key in ("regular", "guarded"):
                worst[key][0] = max(worst[key][0], c["worst"][key][0])
                worst[key][1] = max(worst[key][1], c["worst"][key][1])
            max_abs_err = max(max_abs_err, c["max_abs_err"])
            worst_ratio = max(worst_ratio, c["worst_ratio"])
            worst_resid = max(worst_resid, c["worst_resid"])
            if lev == 0:
                first_guarded.append(bool(guarded.any()))
            if not c["ok"]:
                raise SystemExit(f"K2 on the {path} path: level {name} {c['why']}")
            # pivots outside the fast quotients' range: powers of two take the
            # exact reciprocal's branch, the others the library division
            sp = _safe_pivot(d_k)
            pow2 = torch.frexp(sp)[0].abs() == 0.5
            out = (sp.abs() < 2.0 ** -100) | (sp.abs() > 2.0 ** 100)
            n_pow2 += int((out & pow2).sum())
            n_slow += int((out & ~pow2).sum())
            n_blocks += A.shape[0]
            n_guarded_blocks += int(guarded.sum())
            n_guarded += int(guard.sum())
        ms = time_cuda(lambda g=group: [k2.block_ldlt_inv(A) for A in g],
                       reps=10, warmup=1) / len(group)
        level_ms.append(ms)
        pl = k2.plan(group[0].shape[0], b_path, group[0].dtype)
        log(f"K2 on the {path} path, level {name}: {len(group)} inputs of {tuple(group[0].shape)}, "
            f"plan cs={pl.cs} strip rows={list(pl.rows)} shared={pl.smem} B; "
            f"{n_guarded_blocks}/{n_blocks} blocks with a guarded pivot, {n_guarded} "
            f"guarded pivots; pivots outside the fast quotients' range: {n_pow2} powers "
            f"of two, {n_slow} others; "
            f"inertia and live pivot signs equal -> ok; {ms:.4f} ms per launch")
    for key, (r_inv, r_d) in worst.items():
        held = (f"held: max |dAinv| / limit {worst_ratio:.3e}, d to "
                f"{PATH_TOL_D * _ulps(inputs[0].dtype):g}; "
                f"max|A Ainv - I| of the kernel at most {worst_resid:.3f}x the plain "
                f"version's" if key == "regular"
                else "not held: the retry loop reads only their inertia")
        log(f"K2 on the {path} path, blocks {'without' if key == 'regular' else 'with'} a "
            f"guarded pivot: max rel err Ainv {r_inv:.3e}, d {r_d:.3e} ({held})")
    first = inputs[0::per]
    trial = [A for A, g in zip(first, first_guarded) if g]
    clean = [A for A, g in zip(first, first_guarded) if not g]
    split = ", ".join(
        f"{len(g)} inputs {what}: "
        + (f"{time_cuda(lambda g=g: [k2.block_ldlt_inv(A) for A in g], reps=10, warmup=1) / len(g):.4f} ms"
           if g else "none")
        for g, what in ((trial, "with guarded pivots"), (clean, "without")))
    A1 = first[-1]
    plain_ms = time_cuda(lambda: k2.block_ldlt_inv_plain(A1), reps=3, warmup=1)
    inv_ms = time_cuda(lambda: torch.linalg.inv_ex(A1), reps=20, warmup=2)
    nb1 = A1.shape[0]
    bound_ms, bound_by, nbytes, ops = k2_bound(nb1, b_path, A1.dtype)
    ms = level_ms[0]
    log(f"K2 per launch on the {path} path's own blocks ({', '.join(names)}): "
        + ", ".join(f"{t:.4f}" for t in level_ms) + f" ms; level 1 split: {split}; card {card}")
    log(f"K2 timing ({nb1}, {b_path}, {b_path}) {str(A1.dtype)[6:]} on the {path} path's own "
        f"first-level blocks: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} B, {ops} flops), torch.linalg.inv_ex (inverse only, pivoted) "
        f"{inv_ms:.4f} ms")
    pl = k2.plan(nb1, b_path, A1.dtype)
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=inv_ms,
                level_ms=level_ms, launches_per_factorization=per,
                first_level=[nb1, b_path, b_path],
                plan={"variant": pl.variant, "cs": pl.cs, "rows": list(pl.rows),
                      "smem": pl.smem})


def chained_path(dev, opts, card):
    """The chained path at full width on the card, held against the
    reference; returns the K2 launches of the warm solve and every input K2
    gets in one more warm solve."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    t0 = time.perf_counter()
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**opts), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ch = cnlp.chain
    t0 = time.perf_counter()
    cold = ipopt_torch.solve(cnlp, device=dev, **opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_launches, k1_launches = k2.block_ldlt_inv.launches, bl.block_ldlt.launches
    status, iters, obj = int(res.status), int(res.iter_count), float(res.obj)
    n_fact = int(res.counters.n_factorizations)
    bcr = res.batched_factorizations
    rel = abs(obj - LV1_OBJ) / abs(LV1_OBJ)
    log(f"chained path: solve(luksan_vlcek1({LV1_N}, {LV1_V})) float64, "
        f"{ch.K + 1} blocks of {ch.bs}: status {status}, {iters} iterations, "
        f"objective {obj!r} (reference {LV1_OBJ!r}, rel diff {rel:.2e}); warm "
        f"solve {wall:.3f} s ({wall / max(iters, 1) * 1e3:.1f} ms/iteration), cold "
        f"solve {cold_s:.3f} s, set-up (canonicalize_chained) {setup_s:.3f} s; "
        f"K2 launches {k2_launches}, K1 launches {k1_launches}, BCR "
        f"factorizations {bcr} (counters.n_factorizations {n_fact}); card {card}")
    checks = [
        (status == LV1_STATUS, f"status {status} != {LV1_STATUS}"),
        (iters == LV1_ITERS, f"{iters} iterations != {LV1_ITERS}"),
        (bcr == n_fact == LV1_FACTORIZATIONS,
         f"factorizations {bcr}/{n_fact} != {LV1_FACTORIZATIONS}"),
        (rel <= 1e-9, f"objective {obj!r} off the reference by {rel:.2e}"),
        (k2_launches == LV1_K2_PER_FACTORIZATION * bcr,
         f"K2 launches {k2_launches} != {LV1_K2_PER_FACTORIZATION} x {bcr}"),
        (int(cold.iter_count) == iters, "cold and warm solves differ"),
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit(f"chained path: {msg}")
    small = modellib.luksan_vlcek1(256, LV1_V)
    r_card = ipopt_torch.solve(small, device=dev, **opts)
    r_cpu = ipopt_torch.solve(small, device="cpu", **opts)
    rel = abs(float(r_card.obj) - float(r_cpu.obj)) / abs(float(r_cpu.obj))
    log(f"chained path, luksan_vlcek1(256, {LV1_V}) (8 blocks of 156): card status "
        f"{int(r_card.status)}, {int(r_card.iter_count)} iterations, objective "
        f"{float(r_card.obj)!r}; CPU status {int(r_cpu.status)}, "
        f"{int(r_cpu.iter_count)} iterations, objective {float(r_cpu.obj)!r} "
        f"(rel diff {rel:.2e})")
    if (int(r_card.status) != 0 or int(r_card.iter_count) != int(r_cpu.iter_count)
            or rel > 1e-10):
        raise SystemExit("chained path: the card and the CPU disagree at n=256")
    from ipopt_torch.profile_main import capture_k2_inputs
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **opts))
    shapes = [tuple(A.shape) for A in inputs[:LV1_K2_PER_FACTORIZATION]]
    if len(inputs) != LV1_K2_PER_FACTORIZATION * LV1_FACTORIZATIONS or shapes != [
            (ne, 156, 156) for ne in (64, 32, 16, 8, 4, 2, 1, 1)]:
        raise SystemExit(f"chained path: captured {len(inputs)} K2 inputs of shapes "
                         f"{shapes}...")
    return k2_launches, inputs, wall / max(iters, 1) * 1e3


# LuksanVlcek1 chained with 100 variables per group: KKT blocks v + 2 mk =
# 496 wide, above the cluster variant's 416, so every BCR level runs K2's
# device-memory variant.  Reference values: ipopt_tpu.solve(
# modellib.luksan_vlcek1(1000, 100)) in float64 on the CPU, at commit
# bb9bf3b, with the options of bench.py:74-80: status 0, 7 iterations, 21
# factorizations, objective below.
LV1W_N, LV1W_V = 1000, 100
LV1W_STATUS, LV1W_ITERS, LV1W_FACTORIZATIONS = 0, 7, 21
LV1W_OBJ = 6.2324586324370905


def wide_chained_path(dev, opts, card):
    """solve(luksan_vlcek1(1000, 100)) on the card, its K2 launches counted
    from 0, against the reference's values; returns the launches."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt_inv as k2
    prob = modellib.luksan_vlcek1(LV1W_N, LV1W_V)
    ch = ipopt_torch.canonicalize_chained(prob).chain
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    res = ipopt_torch.solve(prob, device=dev, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k2.block_ldlt_inv.launches
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    rel = abs(float(res.obj) - LV1W_OBJ) / abs(LV1W_OBJ)
    pl = k2.plan(ch.K // 2 + 1, ch.bs, torch.float64)
    log(f"wide chained path: solve(luksan_vlcek1({LV1W_N}, {LV1W_V})) float64, "
        f"{ch.K + 1} blocks of {ch.bs} (K2 plan {pl.variant}): (status, iterations, "
        f"factorizations) {got}, objective {float(res.obj)!r} (reference "
        f"({LV1W_STATUS}, {LV1W_ITERS}, {LV1W_FACTORIZATIONS}), {LV1W_OBJ!r}, rel diff "
        f"{rel:.2e}, tol 1e-9) in {wall:.3f} s; K2 launches {launches}; card {card}")
    if got != (LV1W_STATUS, LV1W_ITERS, LV1W_FACTORIZATIONS) or rel > 1e-9:
        raise SystemExit("wide chained path: the card differs from the reference")
    if launches == 0 or pl.variant != "global":
        raise SystemExit("wide chained path: K2's device-memory variant was not launched")
    return launches


# A dense NLP whose augmented KKT is 198 wide, above the 169 at which a whole
# b x b float64 block stops fitting one CTA's shared memory: LuksanVlcek1 as a plain NLP
# (tests/problems.py:146) at n = 100.  Reference values:
# ipopt_tpu.solve(problems.luksan_vlcek1(100)) in float64 on the CPU, with the
# options of bench.py:74-80, at commit 3aa5258: status 0, 6 iterations,
# objective below.
LV1D_N, LV1D_STATUS, LV1D_ITERS = 100, 0, 6
LV1D_OBJ = 6.2324586324464475


def dense_path(dev, opts, card):
    """solve(luksan_vlcek1_dense(100)) on the card, with K1's launch count set
    to 0 before and read after, against the reference's values and the same
    solve on the CPU."""
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    import torch
    prob = modellib.luksan_vlcek1_dense(LV1D_N)
    bl.block_ldlt.launches = 0
    t0 = time.perf_counter()
    r_card = ipopt_torch.solve(prob, device=dev, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bl.block_ldlt.launches
    r_cpu = ipopt_torch.solve(prob, device="cpu", **opts)
    got = [(int(r.status), int(r.iter_count), float(r.obj)) for r in (r_card, r_cpu)]
    rel = [abs(o - LV1D_OBJ) / abs(LV1D_OBJ) for _, _, o in got]
    pl = bl.plan(1, 2 * LV1D_N - 2, torch.float64)
    log(f"dense path: solve(luksan_vlcek1_dense({LV1D_N})) float64, KKT "
        f"{2 * LV1D_N - 2} wide (K1 plan {pl.variant}, {pl.smem} B shared): card "
        f"(status, iterations, objective) {got[0]} in {wall:.3f} s, CPU {got[1]}, "
        f"reference ({LV1D_STATUS}, {LV1D_ITERS}, {LV1D_OBJ!r}); rel diff card "
        f"{rel[0]:.2e}, CPU {rel[1]:.2e} (tol 1e-9); K1 launches {launches}; card {card}")
    for (status, iters, _), r in zip(got, rel):
        if status != LV1D_STATUS or iters != LV1D_ITERS or r > 1e-9:
            raise SystemExit("dense path: the card or the CPU differs from the reference")
    if launches == 0:
        raise SystemExit("dense path: K1 was not launched")


# The chained restoration on the card: "hard_chain" of
# tests/test_torch_chained.py (x_{k+1}[0] = x_k[0]^2 from x0 = -3), widened
# to v = 200 variables per group, so its KKT blocks are 202 wide and its
# restoration's 204 (v + 4 mk), above the 169 of the one-CTA kernel that
# came before the cluster design; and to v = 500 (KKT blocks 502,
# restoration 504), above the cluster variant's 416: K2's device-memory
# variant.
HARD_CHAIN_VS = (200, 500)


def hard_chain(v):
    import torch
    import ipopt_torch
    return ipopt_torch.ChainedNLP(
        f_stage=lambda xk, xk1, th: ((xk - 2.0) ** 2).sum(),
        g_stage=lambda xk, xk1, th: torch.stack([xk1[0] - xk[0] ** 2]),
        x0=np.full((4, v), -3.0), g_L=np.zeros(1), g_U=np.zeros(1))


def restoration_path(dev, card, v):
    """hard_chain at v variables per group solved on the card, with the
    launch counts set to 0 before and read after, against the same solve on
    the CPU; returns the K2 launches."""
    import ipopt_torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    prob = hard_chain(v)
    ch = ipopt_torch.canonicalize_chained(prob).chain
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    r_card = ipopt_torch.solve(prob, device=dev, print_level=0)
    wall = time.perf_counter() - t0
    k2_launches, k1_launches = k2.block_ldlt_inv.launches, bl.block_ldlt.launches
    r_cpu = ipopt_torch.solve(prob, device="cpu", print_level=0)
    x_card, x_cpu = r_card.x.cpu().numpy(), r_cpu.x.numpy()
    rel = float(np.abs(x_card - x_cpu).max() / np.abs(x_cpu).max())
    got = [(int(r.status), int(r.iter_count), int(r.restoration_count))
           for r in (r_card, r_cpu)]
    log(f"restoration path: hard_chain v={v}, {ch.K + 1} groups, KKT blocks "
        f"{ch.bs} wide, restoration blocks {ch.v + 4 * ch.mk}: card (status, iterations, "
        f"restorations) {got[0]} in {wall:.3f} s, CPU {got[1]}; max|x_card - x_cpu| / "
        f"max|x_cpu| = {rel:.2e} (tol 1e-8); K2 launches {k2_launches}, K1 launches "
        f"{k1_launches}; card {card}")
    if got[0] != got[1] or got[0][2] == 0 or rel > 1e-8:
        raise SystemExit("restoration path: the card and the CPU disagree, or no "
                         "restoration was entered")
    if k2_launches == 0:
        raise SystemExit("restoration path: K2 was not launched")
    return k2_launches


# The banded path: LuksanVlcek1 as one flat NLP with its declared sparsity
# (bench.py:247-263) at n = 1e5, through the general-sparsity backend
# (declared pattern -> RCM -> BCR): 12,500 blocks of 16.  Reference values:
# ipopt_tpu.solve(modellib.luksan_vlcek1_flat(100_000),
# linear_solver="banded-bcr") in float64 on the CPU, at commit bb9bf3b, with
# the options of bench.py:74-80: status 0, 6 iterations, 12 factorizations
# (counters.n_factorizations), no restoration, objective below.  A
# factorization of 12,500 blocks is 14 BCR levels (odd chains padded) and
# the root: 15 K2 launches.
LVF_N = 100_000
LVF_STATUS, LVF_ITERS, LVF_FACTORIZATIONS = 0, 6, 12
LVF_OBJ = 6.232458632392283
LVF_K2_PER_FACTORIZATION = 15
BANDED = dict(linear_solver="banded-bcr")


def banded_path(dev, opts, card):
    """solve(luksan_vlcek1_flat(1e5), linear_solver="banded-bcr") on the
    card, cold then warm with the launch counts set to 0 before the warm
    solve and read after it, against the reference's values;
    luksan_vlcek1_flat(2000) on the card against the CPU; returns the warm
    solve's K2 launches, every K2 input of one more warm solve and the
    path's numbers."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.sparse import canonicalize_sparse
    bopts = dict(opts, **BANDED)
    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(modellib.luksan_vlcek1_flat(LVF_N),
                               ipopt_torch.Options(**bopts), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = cnlp.chain
    t0 = time.perf_counter()
    cold = ipopt_torch.solve(cnlp, device=dev, **bopts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **bopts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    k2_launches, k1_launches = k2.block_ldlt_inv.launches, bl.block_ldlt.launches
    status, iters, obj = int(res.status), int(res.iter_count), float(res.obj)
    n_fact, n_resto = int(res.counters.n_factorizations), int(res.restoration_count)
    bcr = res.batched_factorizations
    rel = abs(obj - LVF_OBJ) / abs(LVF_OBJ)
    log(f"banded path: solve(luksan_vlcek1_flat({LVF_N}), banded-bcr) float64, N = "
        f"{info.N} unknowns in {info.nb} blocks of {info.b} (restoration NLP: "
        f"{info.resto.nb} blocks of {info.resto.b}): status {status}, {iters} "
        f"iterations, objective {obj!r} (reference {LVF_OBJ!r}, rel diff {rel:.2e}); "
        f"warm solve {wall:.3f} s ({wall / max(iters, 1) * 1e3:.1f} ms/iteration), cold "
        f"solve {cold_s:.3f} s, set-up (canonicalize_sparse) {setup_s:.3f} s, warm "
        f"solve's peak device memory {peak_gib:.3f} GiB; K2 "
        f"launches {k2_launches}, K1 launches {k1_launches}, BCR factorizations {bcr} "
        f"(counters.n_factorizations {n_fact}), restorations {n_resto}; card {card}")
    checks = [
        (status == LVF_STATUS, f"status {status} != {LVF_STATUS}"),
        (iters == LVF_ITERS, f"{iters} iterations != {LVF_ITERS}"),
        (bcr == n_fact == LVF_FACTORIZATIONS,
         f"factorizations {bcr}/{n_fact} != {LVF_FACTORIZATIONS}"),
        (rel <= 1e-9, f"objective {obj!r} off the reference by {rel:.2e}"),
        (k2_launches == LVF_K2_PER_FACTORIZATION * bcr,
         f"K2 launches {k2_launches} != {LVF_K2_PER_FACTORIZATION} x {bcr}"),
        (k1_launches == 0, f"K1 launched {k1_launches} times"),
        (n_resto == 0, f"{n_resto} restorations"),
        (int(cold.iter_count) == iters, "cold and warm solves differ"),
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit(f"banded path: {msg}")
    small = modellib.luksan_vlcek1_flat(2000)
    r_card = ipopt_torch.solve(small, device=dev, **bopts)
    r_cpu = ipopt_torch.solve(small, device="cpu", **bopts)
    got = [(int(r.status), int(r.iter_count), int(r.counters.n_factorizations))
           for r in (r_card, r_cpu)]
    rel = abs(float(r_card.obj) - float(r_cpu.obj)) / abs(float(r_cpu.obj))
    log(f"banded path, luksan_vlcek1_flat(2000): card (status, iterations, "
        f"factorizations) {got[0]}, objective {float(r_card.obj)!r}; CPU {got[1]}, "
        f"objective {float(r_cpu.obj)!r} (rel diff {rel:.2e}, tol 1e-10)")
    if got[0] != got[1] or got[0][0] != 0 or rel > 1e-10:
        raise SystemExit("banded path: the card and the CPU disagree at n=2000")
    from ipopt_torch.profile_main import capture_k2_inputs
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **bopts))
    if len(inputs) != LVF_K2_PER_FACTORIZATION * LVF_FACTORIZATIONS:
        raise SystemExit(f"banded path: captured {len(inputs)} K2 inputs")
    return k2_launches, inputs, dict(wall_s=wall, cold_s=cold_s, setup_s=setup_s,
                                     peak_gib=peak_gib, status=status, obj=obj,
                                     iterations=iters, factorizations=bcr)


# Mittelmann's 2-D distributed control (MittelmannDistCntrlNeumA1,
# bench.py:266-299) at N = 100: 20,404 variables, 10,400 equalities, 76
# blocks of 408 after RCM; its restoration NLP analyzes to 41 blocks of
# 1,288.  Held at the options above (float64, tol 1e-8: the card has native
# float64, so the bench's float32 workaround does not apply).  Reference
# values, ipopt_tpu.solve on the CPU in float64 at commit bb9bf3b with these
# options and linear_solver="banded-bcr":
# - N = 30: status 0, 20 iterations, 60 factorizations, objective below;
# - N = 100, resto_phase=False: the per-iteration (iteration, objective,
#   inf_pr, inf_du, mu, alpha_pr, alpha_du) of iterations 0-3 below; the
#   solve itself stops in status 10 after 21 iterations (68
#   factorizations): its line search fails at iteration 20 and restoration
#   is off.  The comparison stops at iteration 3 because the step of
#   iteration 4 comes from a linear solve whose residual ratio stays near 1
#   after refinement (the unpivoted sweep that every BCR level runs is not
#   backward stable on these blocks), so from there each implementation's
#   rounding picks its own trajectory.
# The reference's solve of N = 100 with restoration was not obtained: on
# the CPU it ran out of 62 GiB of host memory; on the H100 (JAX 0.9.0 for
# CUDA, ``python3 tests/test_torch_sparse.py 100``) its compilation did not
# end within 25 minutes, while the same script at N = 30 gave the values
# below on the card.
MITT_N = 100
MITT30_REF = (0, 20, 60, 0.07666745375507729)
MITT100_NR_TRACE = np.array([
    (0, 0.12512253700617587, 0.00014704440741103816, 1.0000980058956128, 0.1, 1.0, 0.9898215676033262),
    (1, 0.12876760936446482, 0.00016783874905019802, 0.010177442575106298, 0.020000000000000004, 1.0, 0.8671056400282245),
    (2, 0.15000300921423584, 3.860180160467352e-05, 0.011012192988037, 0.002828427124746191, 1.0, 0.997150717583102),
    (3, 0.1658535926002046, 1.8977936570374763e-05, 0.0008420731700932927, 0.00015042412372345582, 1.0, 0.9994493431106592)])


# K2 on Mittelmann N = 100's own blocks: the forward rule of
# check_k2_on_path, or per block a normwise backward error within this factor
# of the larger of b eps and the plain version's on A and on A^T.
MITT_BACKWARD_FACTOR = 10.0


def backward_error(A, X):
    """Normwise backward error of an inverse per block,
    ||A X - I|| / (||A|| ||X||) in the infinity norm (non-finite entries as 0)."""
    import torch
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    X = torch.nan_to_num(X, 0.0, 0.0, 0.0)

    def ninf(M):
        return torch.linalg.matrix_norm(M, ord=float("inf"))
    return ninf(A @ X - eye) / (ninf(A) * ninf(X)).clamp(min=1e-300)


class MittK2Check:
    """K2 against its plain version on the inputs of a solve whose blocks
    the unpivoted sweep cannot invert accurately (Mittelmann N = 100): every
    input, timed in ``seconds`` so that a solve that runs the checks can
    report its own wall without them (``flush`` before the wall ends).

    Per block: the finite pattern of Ainv and d equal to the plain
    version's, and either the forward rule of ``check_k2_on_path`` (|dAinv|
    within the growth-scaled limit) or, for a block outside it, a normwise
    backward error of the kernel's inverse at most MITT_BACKWARD_FACTOR
    times the larger of b eps and the plain version's on A and on A^T
    transposed back (two equally valid orders of the same sweep).  The
    second rule is what "as right as the plain version" can mean where the
    sweep is not backward stable: there a sweep's rounding sets the
    backward error, and the forward differences of any two orders are that
    rounding amplified by the block's condition.  Counted and printed per
    stack: blocks under each rule, blocks outside the forward rule where the
    plain version's own two orders are outside it too, the worst backward
    errors, and blocks whose inertia differs from the plain version's
    (printed, not held: where the pivots are this inaccurate, their signs
    are not determined either)."""

    # inputs of one shape are held (copied) until STACK_BYTES of them are
    # waiting, then checked together: the plain version treats every block
    # on its own, and one call on the stack costs about one call's latency
    STACK_BYTES = 2 * 2**30

    def __init__(self):
        self.rows = {}
        self.seconds = 0.0
        self.checked = 0
        self.pending = {}

    def __call__(self, A, d_k, inv_k):
        import torch
        from ipopt_torch.linalg import block_ldlt_inv as k2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.checked += 1
        if A.shape[-1] > k2.PANEL:
            buf = self.pending.setdefault(tuple(A.shape), [])
            buf.append((A.clone(), d_k.clone(), inv_k.clone()))
            if len(buf) * 2 * A.numel() * A.element_size() >= self.STACK_BYTES:
                self._flush(tuple(A.shape))
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def flush(self):
        """Check every input still waiting."""
        import torch
        t0 = time.perf_counter()
        for shape in list(self.pending):
            self._flush(shape)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def _flush(self, shape):
        import torch
        buf = self.pending.pop(shape)
        self._check(*(torch.cat(x) for x in zip(*buf)), nb=shape[0], inputs=len(buf))

    def _check(self, A, d_k, inv_k, nb, inputs):
        import torch
        from ipopt_torch.linalg import block_ldlt_inv as k2
        from ipopt_torch.linalg.block_tridiag import _block_inertia_counts
        b = A.shape[-1]
        eps = torch.finfo(A.dtype).eps
        d_p, inv_p = k2.block_ldlt_inv_plain(A)
        pattern_ok = (torch.equal(torch.isfinite(inv_k), torch.isfinite(inv_p))
                      and torch.equal(torch.isfinite(d_k), torch.isfinite(d_p)))
        # a block whose input is not finite (what a rejected inertia trial
        # leaves to the next BCR level) has no inverse to compare: it is held
        # by the finite pattern above alone
        fin_in = torch.isfinite(A).all(-1).all(-1)
        n_nonfinite = int((~fin_in).sum())
        if n_nonfinite:
            A, d_k, inv_k, d_p, inv_p = (v[fin_in] for v in (A, d_k, inv_k, d_p, inv_p))
        fin = torch.isfinite(inv_p)
        scale = torch.where(fin, inv_p, 0.0).abs().amax((1, 2)).clamp(min=1.0)
        growth = torch.maximum(A.abs().amax((1, 2)),
                               d_p.abs().nan_to_num(0.0, 0.0, 0.0).amax(-1))
        limit = torch.maximum(PATH_TOL_INV * scale, b * eps * growth * scale ** 2)

        def within(X, ref, fin_ref, lim):
            both = fin_ref & torch.isfinite(X)
            return torch.where(both, X - ref, 0.0).abs().amax((1, 2)) <= lim

        fwd_ok = within(inv_k, inv_p, fin, limit)
        out = ~fwd_ok
        r = self.rows.setdefault((b, nb), dict(
            inputs=0, blocks=0, forward=0, backward_only=0, failed=0,
            plain_orders_apart=0, inertia_differs=0, worst_backward_ratio=0.0,
            worst_backward_error=0.0, plain_worst_backward_error=0.0, pattern_ok=True,
            nonfinite_input=0))
        r["inputs"] += inputs
        r["blocks"] += A.shape[0] + n_nonfinite
        r["nonfinite_input"] += n_nonfinite
        r["forward"] += int(fwd_ok.sum())
        if bool(out.any()):
            As = A[out]
            _, inv_t = k2.block_ldlt_inv_plain(As.transpose(1, 2).contiguous())
            inv_t = inv_t.transpose(1, 2)
            be_k, be_p, be_t = (backward_error(As, X) for X in (inv_k[out], inv_p[out], inv_t))
            ref = torch.maximum(torch.maximum(be_p, be_t), torch.full_like(be_p, b * eps))
            bwd_ok = be_k <= MITT_BACKWARD_FACTOR * ref
            r["backward_only"] += int(bwd_ok.sum())
            r["failed"] += int((~bwd_ok).sum())
            r["plain_orders_apart"] += int((~within(inv_t, inv_p[out], fin[out],
                                                    limit[out])).sum())
            r["worst_backward_ratio"] = max(r["worst_backward_ratio"],
                                            float((be_k / ref).max()))
            r["worst_backward_error"] = max(r["worst_backward_error"], float(be_k.max()))
            r["plain_worst_backward_error"] = max(r["plain_worst_backward_error"],
                                                  float(be_p.max()))

        def counts(d):
            return torch.stack(_block_inertia_counts(d[:, None], 0.0))
        r["inertia_differs"] += int((counts(d_k) != counts(d_p)).any(0).sum())
        r["pattern_ok"] = r["pattern_ok"] and pattern_ok

    def report(self, path):
        self.flush()
        bad = []
        for (b, nb), r in sorted(self.rows.items(), key=lambda kv: (-kv[0][0], -kv[0][1])):
            log(f"K2 on the {path} path, ({nb}, {b}, {b}): {r['inputs']} inputs, "
                f"{r['blocks']} blocks ({r['nonfinite_input']} with a non-finite input, "
                f"held by the finite pattern): {r['forward']} within the forward rule; "
                f"{r['backward_only']} outside it but within the backward rule (in "
                f"{r['plain_orders_apart']} of these the plain version's two orders are "
                f"outside the forward rule too; worst backward error "
                f"{r['worst_backward_error']:.3e}, plain {r['plain_worst_backward_error']:.3e}, "
                f"worst ratio {r['worst_backward_ratio']:.3f} of {MITT_BACKWARD_FACTOR:g}); "
                f"{r['failed']} outside both; inertia differs from the plain version's in "
                f"{r['inertia_differs']} blocks; finite pattern equal {r['pattern_ok']}")
            if r["failed"] or not r["pattern_ok"]:
                bad.append((nb, b))
        if bad:
            raise SystemExit(f"K2 on the {path} path disagrees with its plain version "
                             f"at {bad}")
        return {f"{nb}x{b}": {k: v for k, v in r.items() if k != "pattern_ok"}
                for (b, nb), r in self.rows.items()}


def _mitt_trace():
    rows = []

    def cb(iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr, alpha_du, **_):
        rows.append((iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr, alpha_du))
        return True

    return rows, cb


class GraphedPlain:
    """A plain PyTorch version (A -> tuple of tensors) replayed from one CUDA
    graph per input shape: the same kernels in the same order, without the
    Python launch cost of each.  The first input of each shape also runs
    through the plain version's own launches, and ``equal`` records whether
    the replay gave the same values (NaN in the same places)."""

    def __init__(self, fn):
        self.fn, self.graphs, self.equal = fn, {}, True

    @property
    def shapes(self):
        return len(self.graphs)

    def __call__(self, A):
        import torch
        key = (tuple(A.shape), A.dtype, A.device)
        if key not in self.graphs:
            static = A.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                eager = self.fn(static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn(static)
            self.graphs[key] = (graph, static, out)
            graph.replay()
            self.equal &= all(same_values(x, y) for x, y in zip(out, eager))
        graph, static, out = self.graphs[key]
        static.copy_(A)
        graph.replay()
        return tuple(x.clone() for x in out)

    def release(self):
        import torch
        self.graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def mittelmann_path(dev, opts, card):
    """Mittelmann's distributed control on the card through the banded
    backend: N = 30 against the reference's values; N = 100 without
    restoration against the reference's values and per-iteration trace;
    N = 100 at the default options (restoration on: K2's device-memory
    variant at b = 1288), launch counts from 0, K2 on the inputs of that
    solve against its plain version (``MittK2Check``), its outcome logged and
    held: it entered restoration, and with K2's plain version in the
    kernel's place the same solve ends in the same status and its linear
    solves break down in the same step (iteration 4).  Status 0 at N = 100
    is printed as met or
    not; it is not met (status 10: the linear solves lose their accuracy
    from iteration 4, ROADMAP Queue 3).  Returns its numbers."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.sparse import canonicalize_sparse
    bopts = dict(opts, **BANDED)
    r30 = ipopt_torch.solve(modellib.mittelmann_dist_control(30), device=dev, **bopts)
    got30 = (int(r30.status), int(r30.iter_count), int(r30.counters.n_factorizations))
    rel30 = abs(float(r30.obj) - MITT30_REF[3]) / abs(MITT30_REF[3])
    log(f"Mittelmann path, N = 30: card (status, iterations, factorizations) {got30}, "
        f"objective {float(r30.obj)!r}; reference {MITT30_REF}, rel diff {rel30:.2e} "
        f"(tol 1e-9)")
    if got30 != MITT30_REF[:3] or rel30 > 1e-9:
        raise SystemExit("Mittelmann path: N = 30 differs from the reference")

    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(modellib.mittelmann_dist_control(MITT_N),
                               ipopt_torch.Options(**bopts), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = cnlp.chain
    rows, cb = _mitt_trace()
    # iterations 0-3 are compared and iteration 4 printed: the solve stops
    # there (max_iter=5) instead of running on to its status 10
    rnr = ipopt_torch.solve(cnlp, device=dev, resto_phase=False, intermediate_callback=cb,
                            **dict(bopts, max_iter=5))
    k = len(MITT100_NR_TRACE)
    t_p = np.array(rows[:k])
    trace_ok = (t_p.shape == MITT100_NR_TRACE.shape
                and np.allclose(t_p, MITT100_NR_TRACE, rtol=1e-7, atol=1e-10))
    worst = (float(np.max(np.abs(t_p - MITT100_NR_TRACE)
                          / np.maximum(np.abs(MITT100_NR_TRACE), 1e-10)))
             if t_p.shape == MITT100_NR_TRACE.shape else float("nan"))
    log(f"Mittelmann path, N = {MITT_N}, resto_phase=False: iterations 0-{k - 1} equal "
        f"to the reference's to rtol 1e-7: {trace_ok} (max rel diff {worst:.2e}); then "
        f"(status, iterations, factorizations) ({int(rnr.status)}, {int(rnr.iter_count)}, "
        f"{int(rnr.counters.n_factorizations)}); iteration 4 on the card: "
        f"{rows[4] if len(rows) > 4 else None}")
    if not trace_ok:
        raise SystemExit("Mittelmann path: N = 100 differs from the reference's trace")

    # one solve at the default options (restoration on), the launch counts
    # from 0 around it, K2 held against its plain version on every input
    # (its restorations' 1288-wide blocks included) and the residual ratio
    # of each linear solve logged; its wall includes those checks, so the
    # solve's own wall is that wall less the checks' seconds
    from ipopt_torch.algorithm import step as step_mod
    from ipopt_torch.linalg import block_tridiag
    check, events = MittK2Check(), []
    kernel, solve_any = block_tridiag.block_ldlt_inv, step_mod.solve_any

    def k2_checked(A):
        d, inv = kernel(A)
        check(A, d, inv)
        return d, inv

    def solve_logged(nlp, o, fac, K, parts):
        xs, rr = solve_any(nlp, o, fac, K, parts)
        events.append(("rr", nlp.chain.b, float(rr.max())))
        return xs, rr

    def count_iterations(iter_count, **_):
        events.append(("it", iter_count))
        return True

    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    block_tridiag.block_ldlt_inv, step_mod.solve_any = k2_checked, solve_logged
    t0 = time.perf_counter()
    try:
        res = ipopt_torch.solve(cnlp, device=dev, intermediate_callback=count_iterations,
                                **bopts)
        check.flush()
        torch.cuda.synchronize()
    finally:
        block_tridiag.block_ldlt_inv, step_mod.solve_any = kernel, solve_any
    wall = time.perf_counter() - t0
    solve_s = wall - check.seconds
    k2_launches, k1_launches = k2.block_ldlt_inv.launches, bl.block_ldlt.launches
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    obj = float(res.obj)
    log(f"Mittelmann path: solve(mittelmann_dist_control({MITT_N}), banded-bcr) float64, "
        f"n = {info.n}, N = {info.N} in {info.nb} blocks of {info.b} (restoration NLP: "
        f"{info.resto.nb} blocks of {info.resto.b}): (status, iterations, "
        f"factorizations, restorations) {got}, objective {obj!r}; solve with K2 "
        f"checked on every one of its {check.checked} inputs {wall:.3f} s, of it the "
        f"checks {check.seconds:.3f} s and the solve {solve_s:.3f} s, "
        f"set-up {setup_s:.3f} s; K2 launches "
        f"{k2_launches}, K1 launches {k1_launches}; card {card}")
    if k2_launches == 0 or k1_launches != 0 or got[3] == 0:
        raise SystemExit(f"Mittelmann path: K2 launches {k2_launches}, K1 {k1_launches}, "
                         f"restorations {got[3]}")
    k2_rows = check.report("Mittelmann")
    if not any(b == info.resto.b for b, _ in check.rows):
        raise SystemExit("Mittelmann path: K2 was not checked on the restoration's blocks")
    # the step of outer iteration k is solved between the callbacks of k - 1
    # and k (the restoration's own iterations call back too: only the main
    # problem's solves are read here)
    singular = ipopt_torch.Options().residual_ratio_singular

    def ratios(events):
        """The largest residual ratio of the main problem's solves in the
        step of each outer iteration."""
        it, by_it = 0, {}
        for e in events:
            if e[0] == "it":
                it = e[1] + 1
            elif e[1] == info.b:
                by_it[it] = max(by_it.get(it, 0.0), e[2])
        return by_it

    by_it = ratios(events)
    worst = max(by_it.values(), default=0.0)
    first_bad = next(((k, v) for k, v in sorted(by_it.items()) if v > singular), None)
    log(f"Mittelmann path: residual ratio of the linear solves after refinement: largest "
        f"{worst:.3e}; the first above residual_ratio_singular ({singular:g}) in the step "
        f"of outer iteration {first_bad[0] if first_bad else None} "
        f"({first_bad[1] if first_bad else 0.0:.3e})")

    # ROADMAP Queue 3, step 3: the same solve's first iterations with the
    # symmetric equilibration of every BCR level (linear_system_scaling="mc19")
    events = []
    step_mod.solve_any = solve_logged
    try:
        res_mc = ipopt_torch.solve(cnlp, device=dev, resto_phase=False, max_iter=6,
                                   linear_system_scaling="mc19",
                                   intermediate_callback=count_iterations, **bopts)
    finally:
        step_mod.solve_any = solve_any
    by_it_mc = ratios(events)
    log(f"Mittelmann path: residual ratio after refinement in the step of iteration 4: "
        f"{by_it.get(4, float('nan')):.3e} without mc19, {by_it_mc.get(4, float('nan')):.3e} "
        f"with linear_system_scaling=mc19 (iterations 0-5 with mc19: "
        + ", ".join(f"{k}: {v:.3e}" for k, v in sorted(by_it_mc.items()))
        + f"; status {int(res_mc.status)} after {int(res_mc.iter_count)} iterations, "
        f"resto_phase=False, max_iter=6)")

    # the same solve with K2's plain version in the kernel's place, replayed
    # from a CUDA graph per input shape (its ~8,000 small launches per call
    # cost ~150 ms from Python, ~270 s over the solve): the same status, and
    # its linear solves break down in the same step (iteration 4), so the
    # breakdown is the unpivoted sweep's, not the kernel's
    events = []
    plain = GraphedPlain(k2.block_ldlt_inv_plain)
    block_tridiag.block_ldlt_inv = plain
    step_mod.solve_any = solve_logged
    t0 = time.perf_counter()
    try:
        res_p = ipopt_torch.solve(cnlp, device=dev, intermediate_callback=count_iterations,
                                  **bopts)
        torch.cuda.synchronize()
    finally:
        block_tridiag.block_ldlt_inv = kernel
        step_mod.solve_any = solve_any
        n_graphs = plain.shapes
        plain.release()
    plain_s = time.perf_counter() - t0
    got_p = (int(res_p.status), int(res_p.iter_count), int(res_p.restoration_count))
    by_it_p = ratios(events)
    log(f"Mittelmann path: the same solve with K2's plain version on the card "
        f"(replayed from {n_graphs} CUDA graphs, one per input shape, each equal "
        f"to the plain version's own launches on its first input: {plain.equal}): "
        f"(status, iterations, restorations) {got_p}, objective {float(res_p.obj)!r}; "
        f"residual ratio after refinement by iteration "
        + ", ".join(f"{k}: {v:.3e}" for k, v in sorted(by_it_p.items()) if k <= 6)
        + f" (with K2: {by_it.get(4, float('nan')):.3e} at iteration 4); {plain_s:.1f} s")
    if not plain.equal:
        raise SystemExit("Mittelmann path: a CUDA graph of K2's plain version differs "
                         "from its own launches")
    if got_p[0] != got[0]:
        raise SystemExit(f"Mittelmann path: status {got[0]} with K2, {got_p[0]} with "
                         f"its plain version")
    if not (by_it.get(4, 0.0) > singular and by_it_p.get(4, 0.0) > singular):
        raise SystemExit("Mittelmann path: the plain version's solves do not break down "
                         "in the step of iteration 4 as the kernel's do")
    log(f"Mittelmann path: status 0 at N = {MITT_N} (the issue's gate): "
        f"{'met' if got[0] == 0 else 'NOT met'}")
    return dict(checked_wall_s=wall, checks_s=check.seconds, solve_s=solve_s,
                plain_version_s=plain_s, k2_inputs_checked=check.checked,
                setup_s=setup_s, status=got[0], iterations=got[1],
                factorizations=got[2], restorations=got[3], k2_launches=k2_launches,
                objective=obj, plain_version=dict(zip(("status", "iterations",
                                                       "restorations"), got_p)),
                worst_residual_ratio=worst,
                first_singular_step=first_bad[0] if first_bad else None,
                residual_ratio_iteration_4=by_it.get(4),
                residual_ratio_iteration_4_mc19=by_it_mc.get(4),
                k2_check=k2_rows)


def infeasible_banded(n=12):
    """tests/test_sparse_backend.py:146-163 in torch: a consistent chain
    plus the rows x0 = 1 and x0 = -1, so the problem is locally infeasible."""
    import torch
    import ipopt_torch

    def g(x):
        chain = x[:-2] + x[1:-1] - 2.0 * x[2:]
        return torch.cat([chain, torch.stack([x[0] - 1.0, x[0] + 1.0])])
    return ipopt_torch.NLP(f=lambda x: ((x - 0.5) ** 2).sum(), g=g, g_L=np.zeros(n),
                           g_U=np.zeros(n), x0=np.full(n, 0.5), x_L=-3.0, x_U=3.0)


def banded_restoration_path(dev, card):
    """The banded restoration on the card against the CPU: the same status
    (LOCAL_INFEASIBILITY), iteration and restoration counts."""
    import ipopt_torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    kw = dict(print_level=0, tol=1e-8, **BANDED)
    k2.block_ldlt_inv.launches = 0
    r_card = ipopt_torch.solve(infeasible_banded(), device=dev, **kw)
    launches = k2.block_ldlt_inv.launches
    r_cpu = ipopt_torch.solve(infeasible_banded(), device="cpu", **kw)
    got = [(int(r.status), int(r.iter_count), int(r.restoration_count))
           for r in (r_card, r_cpu)]
    log(f"banded restoration path: infeasible chain (n = 12): card (status, "
        f"iterations, restorations) {got[0]}, CPU {got[1]}; K2 launches {launches}")
    local_infeasibility = int(ipopt_torch.SolverReturn.LOCAL_INFEASIBILITY)
    if got[0] != got[1] or got[0][0] != local_infeasibility or got[0][2] == 0:
        raise SystemExit("banded restoration path: the card and the CPU disagree")
    if launches == 0:
        raise SystemExit("banded restoration path: K2 was not launched")


# ---------------------------------------------------------------------------
# Slice E: the adaptive barrier strategy, Mehrotra's mode and warm starts on
# the three backends.  All phases run in float64 at the options of
# bench.py:74-80.
# ---------------------------------------------------------------------------

# E1 reference values: python3 tools/torch_reference_values.py
# fam0_adaptive fam255_adaptive fam511_adaptive fam0_mehrotra fam255_mehrotra
# fam511_mehrotra (ipopt_tpu.solve of hs071 with 40 + 0.005 i, float64, CPU;
# tests/torch_reference_values.json): lane -> (status, iterations, objective).
FAMILY_REF = {
    "adaptive": {0: (0, 8, 17.014017140224112), 255: (0, 8, 16.816305126821423),
                 511: (0, 10, 16.632774526481086)},
    "mehrotra": {0: (0, 8, 17.014017140224112), 255: (0, 8, 16.816305126821423),
                 511: (0, 10, 16.632774526481086)},
}
MODES = {"adaptive": dict(mu_strategy="adaptive"),
         "mehrotra": dict(mehrotra_algorithm=True)}


def adaptive_family_path(dev, opts, card, nlp_b, family, mode):
    """Phase E1: the 512-instance HS071 family with the adaptive strategy
    (mode "adaptive": the quality-function oracle, obj-constr-filter) or
    Mehrotra's mode, cold then warm with the launch counts from 0 before the
    warm solve; 512/512 at status 0, lane 0 at f*, every lane's iterations
    equal to the CPU's batched solve, lanes 0, 255, 511 equal to the
    reference; K1 launches equal the batched factorizations and K1 is
    bit-equal to its plain version on this solve's inputs."""
    import torch
    import ipopt_torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2mod
    from ipopt_torch.linalg import ldlt as ldlt_mod
    from ipopt_torch.profile_main import capture_k1_inputs
    kw = dict(opts, **MODES[mode])
    t0 = time.perf_counter()
    cold = ipopt_torch.solve_batched(nlp_b, device=dev, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2mod.block_ldlt_inv.launches = 0
    calls0 = ldlt_mod.ldlt.calls
    t0 = time.perf_counter()
    res = ipopt_torch.solve_batched(nlp_b, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bl.block_ldlt.launches
    status = res.status.cpu().numpy()
    iters = res.iter_count.cpu().numpy()
    n_ok = int((status == 0).sum())
    obj = res.obj.cpu().numpy()
    outer = int(iters.max())
    log(f"E1 {mode}: solve_batched B={FAMILY_B} float64: {n_ok}/{FAMILY_B} status 0, "
        f"iterations median {statistics.median(iters.tolist())} max {outer}, warm solve "
        f"{wall:.3f} s ({wall / outer * 1e3:.1f} ms per outer iteration), cold "
        f"{cold_s:.3f} s, obj[0] {float(obj[0])!r}; K1 launches {launches}, batched "
        f"factorizations {res.batched_factorizations} (ldlt calls "
        f"{ldlt_mod.ldlt.calls - calls0}), K2 launches {k2mod.block_ldlt_inv.launches}; "
        f"card {card}")
    if n_ok != FAMILY_B:
        raise SystemExit(f"E1 {mode}: only {n_ok}/{FAMILY_B} converged")
    if abs(float(obj[0]) - F_STAR) > 1e-7:
        raise SystemExit(f"E1 {mode}: obj[0] {float(obj[0])} != {F_STAR}")
    if not (launches > 0 and launches == res.batched_factorizations):
        raise SystemExit(f"E1 {mode}: K1 launches {launches} != batched factorizations "
                         f"{res.batched_factorizations}")
    if k2mod.block_ldlt_inv.launches:
        raise SystemExit(f"E1 {mode}: the dense path launched K2")
    if not bool((cold.iter_count == res.iter_count).all()):
        raise SystemExit(f"E1 {mode}: cold and warm solves differ")
    t0 = time.perf_counter()
    cpu = ipopt_torch.solve_batched(family, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    same = cpu.iter_count.numpy() == iters
    log(f"E1 {mode}: per-lane iterations equal to the CPU's batched solve in "
        f"{int(same.sum())}/{FAMILY_B} lanes ({cpu_s:.1f} s on the CPU)")
    if not same.all():
        raise SystemExit(f"E1 {mode}: lanes {np.nonzero(~same)[0][:10].tolist()} differ "
                         f"from the CPU")
    for lane, want in FAMILY_REF[mode].items():
        got = (int(status[lane]), int(iters[lane]))
        rel = abs(float(obj[lane]) - want[2]) / abs(want[2])
        log(f"E1 {mode}: lane {lane} (status, iterations) {got}, objective "
            f"{float(obj[lane])!r}; reference {want}, rel diff {rel:.2e} (tol 1e-9)")
        if got != want[:2] or rel > 1e-9:
            raise SystemExit(f"E1 {mode}: lane {lane} differs from the reference")
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve_batched(nlp_b, device=dev, **kw))
    k1 = check_k1_on_path(dev, inputs, card)
    return dict(wall_s=wall, cold_s=cold_s, ms_per_iteration=wall / outer * 1e3,
                max_iterations=outer, k1_launches=launches,
                batched_factorizations=res.batched_factorizations,
                k1_ms=k1["ms"], k1_max_abs_err=k1["max_abs_err"])


def _k2_per_factorization(launches, bcr, path):
    if bcr == 0 or launches % bcr:
        raise SystemExit(f"{path}: K2 launches {launches} are not a multiple of the "
                         f"{bcr} BCR factorizations")
    return launches // bcr


# E2 reference values: python3 tools/torch_reference_values.py
# lv1_4096_adaptive (ipopt_tpu.solve(luksan_vlcek1(4096, 32)) with
# mu_strategy="adaptive", float64, CPU): status, iterations,
# factorizations, objective.
LV1A_REF = (0, 7, 21, 6.2324586324370905)


def chained_adaptive_path(dev, opts, card):
    """Phase E2: luksan_vlcek1(4096, 32) with the adaptive strategy on the
    chained backend (one factorization, three solves per iteration), cold
    then warm with counts from 0, against the reference; n = 256 card
    against the CPU; K2 on every input of one more warm solve against its
    plain version (check_k2_on_path).  Returns (launches, K2 stats, numbers)."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.profile_main import capture_k2_inputs
    kw = dict(opts, mu_strategy="adaptive")
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**kw), device=dev)
    t0 = time.perf_counter()
    cold = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k2.block_ldlt_inv.launches
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    bcr = res.batched_factorizations
    rel = abs(float(res.obj) - LV1A_REF[3]) / abs(LV1A_REF[3])
    log(f"E2 chained adaptive: solve(luksan_vlcek1({LV1_N}, {LV1_V}), mu_strategy="
        f"adaptive) float64: (status, iterations, factorizations) {got}, objective "
        f"{float(res.obj)!r}; reference {LV1A_REF}, rel diff {rel:.2e} (tol 1e-9); warm "
        f"solve {wall:.3f} s ({wall / max(got[1], 1) * 1e3:.1f} ms/iteration), cold "
        f"{cold_s:.3f} s; K2 launches {launches}, K1 launches {bl.block_ldlt.launches}, "
        f"BCR factorizations {bcr}, KKT solves {int(res.counters.n_kkt_solves)}; "
        f"card {card}")
    if got != tuple(LV1A_REF[:3]) or rel > 1e-9:
        raise SystemExit("E2: the card differs from the reference")
    if not (bcr == got[2] and launches == LV1_K2_PER_FACTORIZATION * bcr):
        raise SystemExit(f"E2: K2 launches {launches} != {LV1_K2_PER_FACTORIZATION} x {bcr}")
    if int(cold.iter_count) != got[1]:
        raise SystemExit("E2: cold and warm solves differ")
    small = modellib.luksan_vlcek1(256, LV1_V)
    r_card = ipopt_torch.solve(small, device=dev, **kw)
    r_cpu = ipopt_torch.solve(small, device="cpu", **kw)
    pair = [(int(r.status), int(r.iter_count), int(r.counters.n_factorizations))
            for r in (r_card, r_cpu)]
    rel = abs(float(r_card.obj) - float(r_cpu.obj)) / abs(float(r_cpu.obj))
    log(f"E2, luksan_vlcek1(256, {LV1_V}) adaptive: card {pair[0]}, objective "
        f"{float(r_card.obj)!r}; CPU {pair[1]}, objective {float(r_cpu.obj)!r} (rel "
        f"diff {rel:.2e}, tol 1e-9)")
    if pair[0] != pair[1] or pair[0][0] != 0 or rel > 1e-9:
        raise SystemExit("E2: the card and the CPU disagree at n=256")
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **kw))
    stats = check_k2_on_path(dev, inputs, LV1_K2_PER_FACTORIZATION, "E2 chained adaptive",
                             card)
    return launches, stats, dict(wall_s=wall, cold_s=cold_s, iterations=got[1],
                                 factorizations=bcr,
                                 ms_per_iteration=wall / max(got[1], 1) * 1e3)


# E3 runs MittelmannBndryCntrlDiri at N = 10 (v = 24, blocks of 64): at
# N = 20 the chained solves of examples 1 and 3 end in status 10 in the
# reference as in the port (the unpivoted sweep of the BCR levels; the
# dense backend solves them), and at N = 100 they did on an H100 (ROADMAP
# Queue 3).  K2's time at N = 100's first-level shape,
# (25, 604, 604), is in check_k2's seeded stacks.  The trajectories are
# chaotic (a change of 1e-15 in x0 changes the iteration count,
# tests/test_torch_suites.py), so the card and the CPU are held to status
# and objective; the warm and the cold objectives of example 3 are held to
# 1e-6 (the reference's own differ by 2.8e-7: tol bounds the scaled KKT
# error, not the objective).
MITTB_N = 10


def warm_start_path(dev, opts, card):
    """Phase E3: mittelmann_bndry_control(10, example=1) cold on the card,
    example 3 warm-started from its iterate (warm_start_init_point,
    mu_init=1e-6, bound_mult_init_val=1e-3), and example 3 cold: all three at
    status 0, the warm objective equal to the cold one to 1e-6; the same
    three on the CPU, each with the card's status and objective (1e-6); K2
    on every input of the warm solve against its plain version
    (MittK2Check's rule, inertia equal).  Returns (launches, K2 stats,
    numbers)."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.profile_main import capture_k2_inputs
    warm = dict(opts, warm_start_init_point=True, mu_init=1e-6, bound_mult_init_val=1e-3)

    def three(device):
        c1 = ipopt_torch.solve(modellib.mittelmann_bndry_control(MITTB_N, 1),
                               device=device, **opts)
        w3 = ipopt_torch.solve(modellib.mittelmann_bndry_control(MITTB_N, 3),
                               device=device, it0=c1.iterate, **warm)
        c3 = ipopt_torch.solve(modellib.mittelmann_bndry_control(MITTB_N, 3),
                               device=device, **opts)
        return c1, w3, c3

    ch = ipopt_torch.canonicalize_chained(modellib.mittelmann_bndry_control(MITTB_N, 1)
                                          ).chain
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    card_ = three(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k2.block_ldlt_inv.launches
    cpu = three("cpu")
    names = ("cold ex1", "warm ex3", "cold ex3")
    rows = {}
    for name, a, b in zip(names, card_, cpu):
        pa, pb = ((int(r.status), int(r.iter_count), int(r.counters.n_factorizations))
                  for r in (a, b))
        rel = abs(float(a.obj) - float(b.obj)) / abs(float(b.obj))
        rows[name] = dict(card=pa, cpu=pb, objective=float(a.obj), rel_diff_cpu=rel)
        log(f"E3 warm start, mittelmann_bndry_control({MITTB_N}) chained ({ch.K + 1} "
            f"blocks of {ch.bs}, v = {ch.v}), {name}: card (status, iterations, "
            f"factorizations) {pa}, objective {float(a.obj)!r}; CPU {pb}, objective "
            f"{float(b.obj)!r} (rel diff {rel:.2e}, tol 1e-6)")
        if pa[0] != 0 or pb[0] != 0 or rel > 1e-6:
            raise SystemExit(f"E3: {name} failed or the card and the CPU disagree")
    rel = abs(rows["warm ex3"]["objective"] - rows["cold ex3"]["objective"]) / abs(
        rows["cold ex3"]["objective"])
    log(f"E3: warm start {rows['warm ex3']['card'][1]} iterations against "
        f"{rows['cold ex3']['card'][1]} cold; warm against cold objective rel diff "
        f"{rel:.2e} (tol 1e-6); the three card solves {wall:.3f} s; K2 launches "
        f"{launches}; card {card}")
    if rel > 1e-6:
        raise SystemExit("E3: the warm and the cold objectives differ")
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(
        modellib.mittelmann_bndry_control(MITTB_N, 3), device=dev, it0=card_[0].iterate,
        **warm))
    per = _k2_per_factorization(len(inputs), int(card_[1].counters.n_factorizations),
                                "E3")
    # These blocks carry pivots that are tiny beside the block's entries (the
    # family whose sweeps fail from N = 20), so a pivot's relative difference
    # is rounding amplified by the cancellation: K2 is held by MittK2Check's
    # rule (forward, or a backward error as small as the plain version's),
    # with the inertia equal to the plain version's
    check = MittK2Check()
    for A in inputs:
        check(A, *k2.block_ldlt_inv(A))
    rows_k2 = check.report("E3 warm start")
    if any(r["inertia_differs"] for r in check.rows.values()):
        raise SystemExit("E3: K2's inertia differs from its plain version's")
    first = inputs[0::per]
    A1 = first[-1]
    nb1, b1 = A1.shape[0], A1.shape[-1]
    ms = time_cuda(lambda: [k2.block_ldlt_inv(A) for A in first], reps=10,
                   warmup=1) / len(first)
    plain_ms = time_cuda(lambda: k2.block_ldlt_inv_plain(A1), reps=3, warmup=1)
    inv_ms = time_cuda(lambda: torch.linalg.inv_ex(A1), reps=20, warmup=2)
    bound_ms, bound_by, nbytes, ops = k2_bound(nb1, b1)
    log(f"K2 timing ({nb1}, {b1}, {b1}) float64 on the E3 warm solve's own first-level "
        f"blocks: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} B, {ops} flops), torch.linalg.inv_ex {inv_ms:.4f} ms; "
        f"card {card}")
    stats = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=inv_ms, first_level=[nb1, b1, b1], check=rows_k2)
    return launches, stats, dict(wall_s=wall, block=ch.bs, rows=rows,
                                 warm_cold_rel_diff=rel)


BANDED_E4 = (("luksan_vlcek4", 100_000), ("luksan_vlcek5", 100_000))


def banded_adaptive_path(dev, opts, card, name, n):
    """Phase E4: ``name``(n) in E form on the banded backend with the
    adaptive strategy: set-up, cold, warm with counts from 0 (status 0); at
    n = 2000 the card equal to the CPU; K2 on every input of one more warm
    solve against its plain version.  Returns (launches, K2 stats,
    numbers)."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.profile_main import capture_k2_inputs
    from ipopt_torch.sparse import canonicalize_sparse
    kw = dict(opts, mu_strategy="adaptive", **BANDED)
    build = getattr(modellib, name)
    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(build(n), ipopt_torch.Options(**kw), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = cnlp.chain
    t0 = time.perf_counter()
    cold = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k2.block_ldlt_inv.launches
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    log(f"E4 banded adaptive: solve({name}({n}), banded-bcr, adaptive) float64, N = "
        f"{info.N} unknowns in {info.nb} blocks of {info.b}: (status, iterations, "
        f"factorizations, restorations) {got}, objective {float(res.obj)!r}; set-up "
        f"{setup_s:.3f} s, warm solve {wall:.3f} s ({wall / max(got[1], 1) * 1e3:.1f} "
        f"ms/iteration), cold {cold_s:.3f} s; K2 launches {launches}, K1 launches "
        f"{bl.block_ldlt.launches}; card {card}")
    if got[0] != 0 or int(cold.iter_count) != got[1]:
        raise SystemExit(f"E4 {name}: status {got[0]}, or cold and warm differ")
    if launches == 0 or bl.block_ldlt.launches:
        raise SystemExit(f"E4 {name}: K2 launches {launches}, K1 {bl.block_ldlt.launches}")
    small = build(2000)
    pair = [ipopt_torch.solve(small, device=d, **kw) for d in (dev, "cpu")]
    rows = [(int(r.status), int(r.iter_count), int(r.counters.n_factorizations))
            for r in pair]
    rel = abs(float(pair[0].obj) - float(pair[1].obj)) / max(abs(float(pair[1].obj)),
                                                             1e-300)
    log(f"E4, {name}(2000): card {rows[0]}, objective {float(pair[0].obj)!r}; CPU "
        f"{rows[1]}, objective {float(pair[1].obj)!r} (rel diff {rel:.2e}, tol 1e-9)")
    if rows[0] != rows[1] or rows[0][0] != 0 or rel > 1e-9:
        raise SystemExit(f"E4 {name}: the card and the CPU disagree at n = 2000")
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **kw))
    per = _k2_per_factorization(len(inputs), got[2], f"E4 {name}")
    stats = check_k2_on_path(dev, inputs, per, f"E4 {name}", card)
    return launches, stats, dict(setup_s=setup_s, wall_s=wall, cold_s=cold_s,
                                 iterations=got[1], factorizations=got[2],
                                 blocks=[info.nb, info.b])


# ---------------------------------------------------------------------------
# Slice F: the scenario (block-arrow) backend, and limited-memory Hessians on
# every backend.  All phases in float64.
# ---------------------------------------------------------------------------
# F1/F2: the two-stage stochastic QP of tests/test_scenario.py:11
# (modellib.stochastic_qp) at S scenarios of ns variables, seed 0: scenario
# blocks ns + 2 wide.  F1: S = 8192, ns = 30, blocks (8192, 32, 32) (K1's
# warp variant, then the log-depth inverse and its Newton step), 245,762
# variables.  F2: S = 1024, ns = 126, blocks (1024, 128, 128) (K1's CTA
# variant, then the substitution).  The card is held against the CPU at
# S = SQP_CPU_S: the Schur reduction sums over S on the card in another
# order than on the CPU, so the full size is held to status 0.
SQP_F1, SQP_F2 = (8192, 30), (1024, 126)
SQP_CPU_S = 256
# F4: the reference's values of hs071 with hessian_approximation=
# "limited-memory", max_iter=300 (tests/torch_cases.py "hs071_lbfgs",
# tools/torch_reference_values.py): status, iterations, objective.
LBFGS = dict(hessian_approximation="limited-memory", max_iter=300)
HS071_LBFGS_REF = (0, 10, 17.01401714521598)
LBFGS_STRUCT = dict(LBFGS, tol=1e-6)      # tests/test_structured_combos.py:31-61
LVF_LBFGS_SMALL = 2000
# F4 dense: the lanes of the L-BFGS family that a relative 3e-15 in the SMW
# matrix moves by one iteration on the CPU (tests/test_torch_lbfgs.py::
# test_family_lanes_are_rounding_sensitive), allowed one iteration apart
# from the CPU's solve; and the reference's (status, iterations, objective)
# on them (tests/torch_cases.py "hs071_fam<lane>_lbfgs").
FAMILY_LBFGS_SENSITIVE = {286: (0, 11, 16.79332419911344),
                          287: (0, 11, 16.79258648783774),
                          294: (0, 11, 16.787428780887613)}


def scen_infeasible(S, ns=3):
    """tests/test_arrow_resto.py:34-48 in torch: per scenario the rows
    xs[0] = 1 and xs[0] = -1, so the problem is locally infeasible."""
    from ipopt_torch import ScenarioNLP
    import torch
    return ScenarioNLP(
        f_scen=lambda x0, xs, th: 0.5 * torch.sum(xs ** 2),
        g_scen=lambda x0, xs, th: torch.stack([xs[0] - 1.0, xs[0] + 1.0]),
        x0_init=np.zeros(1), xs_init=np.zeros((S, ns)),
        g_L=np.zeros((S, 2)), g_U=np.zeros((S, 2)))


def _card_vs_cpu(path, build, dev, kw, rtol=1e-9, status=0, ref=None):
    """Solve ``build()`` on the card and on the CPU; held: equal (status,
    iterations, factorizations, restorations), the card's status equal to
    ``status``, and the objectives to ``rtol`` (not held where ``rtol`` is
    None: the objective of a locally infeasible end means nothing); with
    ``ref``, the reference's (status, iterations, objective), the card's
    too (objective to 1e-9).  Returns the card's (status, iterations,
    factorizations, restorations)."""
    import ipopt_torch
    rs = [ipopt_torch.solve(build(), device=d, **kw) for d in (dev, "cpu")]
    rows = [(int(r.status), int(r.iter_count), int(r.counters.n_factorizations),
             int(r.restoration_count)) for r in rs]
    rel = abs(float(rs[0].obj) - float(rs[1].obj)) / max(abs(float(rs[1].obj)), 1e-300)
    log(f"{path}: card (status, iterations, factorizations, restorations) {rows[0]}, "
        f"objective {float(rs[0].obj)!r}; CPU {rows[1]}, objective "
        f"{float(rs[1].obj)!r} (rel diff {rel:.2e}, "
        + (f"held to {rtol:g})" if rtol is not None else "not held)"))
    if rows[0] != rows[1] or rows[0][0] != status or (rtol is not None and rel > rtol):
        raise SystemExit(f"{path}: the card and the CPU disagree")
    if ref is not None:
        rel_ref = abs(float(rs[0].obj) - ref[2]) / abs(ref[2])
        log(f"{path}: reference {ref}, rel diff {rel_ref:.2e} (tol 1e-9)")
        if rows[0][:2] != tuple(ref[:2]) or rel_ref > 1e-9:
            raise SystemExit(f"{path}: the card differs from the reference")
    return rows[0]


def check_k1_inputs(dev, inputs, shape, path, card, pivot_tol=0.0):
    """K1 on every input a solve gave it (captured by ``capture_k1_inputs``:
    on the arrow path the scenario blocks and the Schur roots), held to its
    plain version by ``k1_agrees`` (bit for bit but for the blocked
    variant's inputs); timed on the inputs of ``shape``: device time per
    launch (torch.profiler; CUDA events per call for the blocked variant),
    the plain version's and torch.linalg.ldl_factor_ex's (Bunch-Kaufman,
    another function: a yardstick) time per call, and the bound."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.profile_main import device_us_per_launch
    blocks = [A for A in inputs if tuple(A.shape) == shape]
    if not blocks:
        raise SystemExit(f"K1 on the {path} path: no {shape} input among "
                         f"{sorted({tuple(A.shape) for A in inputs})}")
    max_abs_err = worst = 0.0
    held = set()
    for A in inputs:
        L_k, d_k = bl.block_ldlt(A)
        L_p, d_p = bl.block_ldlt_plain(A)
        ok, why, how, ratio = k1_agrees(A, L_k, d_k, L_p, d_p, pivot_tol)
        if not ok:
            raise SystemExit(f"K1 on the {path} path: an input of {tuple(A.shape)} where "
                             f"the kernel differs from its plain version: {why}")
        held.add("bit-equal" if how == "bit-equal" else "the blocked variant's rule")
        worst = max(worst, ratio)
        for x, y in ((L_k, L_p), (d_k, d_p)):
            fin = torch.isfinite(x) & torch.isfinite(y)
            max_abs_err = max(max_abs_err, float(torch.where(fin, x - y, 0.0).abs().max()))
        del L_k, d_k, L_p, d_p
    pl = bl.plan(shape[0], shape[1], blocks[0].dtype)
    # the profiler divides by CUDA launches: the blocked variant makes several
    us, n = ((float("nan"), 0) if pl.kernels > 1 else
             device_us_per_launch(lambda: [bl.block_ldlt(A) for A in blocks], "ldlt_",
                                  rounds=3))
    A0 = blocks[0]
    call_ms = time_cuda(lambda: bl.block_ldlt(A0), reps=20, warmup=2)
    # the profiler's device time per launch where it traced the kernel, else
    # CUDA events around back-to-back wrapper calls (one launch each)
    source = "torch.profiler" if n else "CUDA events"
    ms = us * 1e-3 if n else call_ms
    # one call where b is wide: the plain loop's b steps are launch-bound
    wide = shape[-1] > 1000
    plain_ms = time_cuda(lambda: bl.block_ldlt_plain(A0), reps=1 if wide else 5,
                         warmup=0 if wide else 1)
    # seconds per call at these shapes: one timed call (its handles exist
    # since check_k1)
    ldl_ms = time_cuda(lambda: torch.linalg.ldl_factor_ex(A0), reps=1, warmup=0)
    bound_ms, bound_by, nbytes, ops = k1_bound(shape[0], shape[1], A0.dtype)
    log(f"K1 on the {path} path: {len(inputs)} inputs ({len(blocks)} of {shape}), "
        f"each held to the plain version ({', '.join(sorted(held))}; worst backward "
        f"error / limit {worst:.3e}); plan {pl.variant}, {pl.kernels} CUDA launches "
        f"per call; "
        + (f"{us:.2f} us device time per launch on the {shape} inputs (torch.profiler, "
           f"{n} launches), " if n else "")
        + f"{call_ms:.4f} ms per wrapper call (CUDA events); K1's ms "
        f"{ms:.4f} ({source}); plain version {plain_ms:.4f} ms; "
        f"torch.linalg.ldl_factor_ex {ldl_ms:.4f} ms; bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} B, {ops} ops), {ms / bound_ms:.1f}x; card {card}")
    return dict(shape=list(shape), inputs=len(inputs), variant=pl.variant,
                cuda_launches_per_call=pl.kernels, ms=ms, ms_source=source,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=ldl_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs_err,
                worst_backward_ratio=worst)


def _timed_solves(build_or_nlp, dev, kw):
    """Cold solve, then the warm solve with every kernel count set to 0
    just before and read just after.  Returns (warm result, wall, cold wall,
    K1 launches, K2 launches, the warm solve's peak device memory in GiB
    (torch.cuda.max_memory_allocated))."""
    import torch
    import ipopt_torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    solve = (ipopt_torch.solve_batched if isinstance(build_or_nlp, list)
             or getattr(build_or_nlp, "batch", 1) > 1 else ipopt_torch.solve)
    t0 = time.perf_counter()
    cold = solve(build_or_nlp, device=dev, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve(build_or_nlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not bool((cold.iter_count == res.iter_count).all()):
        raise SystemExit("the cold and the warm solves differ")
    return (res, wall, cold_s, bl.block_ldlt.launches, k2.block_ldlt_inv.launches,
            peak_gib)


def arrow_path(dev, opts, card, S, ns, tag):
    """F1/F2: ``stochastic_qp(S, ns)`` on the arrow backend: set-up, cold,
    warm with the counts from 0 (status 0, K1 twice per factorization: the
    scenario blocks and the Schur root, K2 never); the card against the CPU
    at S = SQP_CPU_S; K1 on every input of one more warm solve, bit-equal to
    its plain version, timed on the scenario blocks."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.profile_main import capture_k1_inputs
    t0 = time.perf_counter()
    cnlp = ipopt_torch.canonicalize_scenario(modellib.stochastic_qp(S, ns),
                                             ipopt_torch.Options(**opts), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ar = cnlp.chain
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, opts)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    log(f"{tag} arrow: solve(stochastic_qp({S}, {ns})) float64, n = {cnlp.n}, "
        f"{ar.S} scenario blocks of {ar.bs}: (status, iterations, factorizations, "
        f"restorations) {got}, objective {float(res.obj)!r}; set-up {setup_s:.3f} s, "
        f"warm solve {wall:.3f} s ({wall / max(got[1], 1) * 1e3:.1f} ms/iteration), "
        f"cold {cold_s:.3f} s, peak device memory {peak:.3f} GiB; K1 launches {k1_n} "
        f"({k1_n / max(got[2], 1):g} per "
        f"factorization), K2 launches {k2_n}; card {card}")
    if got[0] != 0 or k2_n or k1_n != 2 * got[2]:
        raise SystemExit(f"{tag}: status {got[0]}, K1 launches {k1_n} (want 2 x "
                         f"{got[2]}), K2 launches {k2_n}")
    _card_vs_cpu(f"{tag}, stochastic_qp({SQP_CPU_S}, {ns})",
                 lambda: modellib.stochastic_qp(SQP_CPU_S, ns), dev, opts)
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **opts))
    n_blocks = sum(tuple(A.shape) == (S, ar.bs, ar.bs) for A in inputs)
    if n_blocks != got[2]:
        raise SystemExit(f"{tag}: {n_blocks} scenario-block inputs for {got[2]} "
                         f"factorizations")
    k1 = check_k1_inputs(dev, inputs, (S, ar.bs, ar.bs), f"{tag} arrow", card)
    del inputs
    return dict(S=S, ns=ns, block=ar.bs, n=cnlp.n, status=got[0], iterations=got[1],
                factorizations=got[2], obj=float(res.obj), setup_s=setup_s,
                wall_s=wall, cold_s=cold_s,
                peak_gib=peak,
                ms_per_iteration=wall / max(got[1], 1) * 1e3, k1_launches=k1_n, k1=k1)


def arrow_restoration_path(dev, card):
    """F3: the inconsistent scenario equalities (tests/test_arrow_resto.py:
    34-48) at their size (S = 4) and at S = 1024: the card with the CPU's
    status and restoration count (local infeasibility after one
    restoration); the counts from 0 around the S = 1024 card solve."""
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    kw = dict(tol=1e-8, print_level=0)
    out = {}
    for S in (4, 1024):
        bl.block_ldlt.launches = 0
        k2.block_ldlt_inv.launches = 0
        got = _card_vs_cpu(f"F3 arrow restoration, S = {S}", lambda: scen_infeasible(S),
                           dev, kw, rtol=None, status=6)
        # the CPU solve launches nothing: these are the card solve's
        out[S] = dict(status=got[0], iterations=got[1], restorations=got[3],
                      k1_launches=bl.block_ldlt.launches)
        if got[3] == 0 or k2.block_ldlt_inv.launches or out[S]["k1_launches"] == 0:
            raise SystemExit(f"F3: restorations {got[3]}, K1 {out[S]['k1_launches']}, "
                             f"K2 {k2.block_ldlt_inv.launches}")
    log(f"F3 arrow restoration: {out}; card {card}")
    return out


def _lbfgs_vs_reference(path, res, name):
    """F4's full-size L-BFGS solve against the reference's on the CPU
    (tests/torch_cases.py ``name``, tools/torch_reference_values.py): both
    end near objective 0, another local solution than the exact Hessian's
    6.23.  Held: the status, and the objective to 1e-12 absolute; the
    iterations are printed beside the reference's."""
    st, it, obj = _recorded(name)
    log(f"{path}: (status, iterations, objective) ({int(res.status)}, "
        f"{int(res.iter_count)}, {float(res.obj)!r}); the reference's ({st}, {it}, "
        f"{obj!r})")
    if int(res.status) != st or abs(float(res.obj) - obj) > 1e-12:
        raise SystemExit(f"{path}: differs from the reference's {name}")


def lbfgs_paths(dev, card, nlp_b, family, exact_ms):
    """F4: hessian_approximation="limited-memory" on every backend, each
    cold then warm with the counts from 0 around the warm solve, status 0:
    chained (luksan_vlcek1(4096, 32), against the reference's recorded
    solve; n = 256 card = CPU), arrow (F1's problem; S = 256 card = CPU),
    banded (luksan_vlcek1_flat, n = 2000 card = CPU, n = 1e5 timed and
    against the reference's recorded solve) and dense (the HS071 family, B = 512: every lane
    at the CPU's iterations, except that a lane of FAMILY_LBFGS_SENSITIVE
    may end one apart with the CPU's objective to 1e-9; those lanes within
    one iteration of the reference's and lane 0 equal to it).  ``exact_ms``
    holds the exact-Hessian ms per iteration of the same backends and the
    exact banded solve's peak device memory, printed beside."""
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.sparse import canonicalize_sparse
    out = {}
    kw = dict(LBFGS_STRUCT, print_level=0)
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**kw), device=dev)
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, kw)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    bcr = res.batched_factorizations
    log(f"F4 L-BFGS chained: luksan_vlcek1({LV1_N}, {LV1_V}) tol 1e-6: (status, "
        f"iterations, factorizations) {got}, objective {float(res.obj)!r}; warm "
        f"{wall:.3f} s ({wall / max(got[1], 1) * 1e3:.1f} ms/iteration; exact "
        f"{exact_ms['chained']:.1f}), cold {cold_s:.3f} s, peak device memory "
        f"{peak:.3f} GiB; K2 launches {k2_n} ({bcr} BCR "
        f"factorizations), K1 launches {k1_n}; card {card}")
    if got[0] != 0 or k2_n != LV1_K2_PER_FACTORIZATION * bcr or k1_n:
        raise SystemExit(f"F4 chained: status {got[0]}, K2 {k2_n} for {bcr}, K1 {k1_n}")
    _lbfgs_vs_reference("F4 L-BFGS chained", res, "lv1_4096_lbfgs")
    _card_vs_cpu(f"F4 L-BFGS chained, luksan_vlcek1(256, {LV1_V})",
                 lambda: modellib.luksan_vlcek1(256, LV1_V), dev, kw)
    out["chained_lv1_4096_32"] = dict(status=got[0], iterations=got[1], factorizations=got[2],
                                      wall_s=wall, cold_s=cold_s, k2_launches=k2_n,
                                      k1_launches=k1_n, peak_gib=peak,
                                      ms_per_iteration=wall / max(got[1], 1) * 1e3)

    S, ns = SQP_F1
    cnlp = ipopt_torch.canonicalize_scenario(modellib.stochastic_qp(S, ns),
                                             ipopt_torch.Options(**kw), device=dev)
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, kw)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    log(f"F4 L-BFGS arrow: stochastic_qp({S}, {ns}) tol 1e-6: (status, iterations, "
        f"factorizations) {got}, objective {float(res.obj)!r}; warm {wall:.3f} s "
        f"({wall / max(got[1], 1) * 1e3:.1f} ms/iteration; exact {exact_ms['arrow']:.1f}), "
        f"cold {cold_s:.3f} s, peak device memory {peak:.3f} GiB; K1 launches {k1_n}, "
        f"K2 launches {k2_n}; card {card}")
    if got[0] != 0 or k1_n != 2 * got[2] or k2_n:
        raise SystemExit(f"F4 arrow: status {got[0]}, K1 {k1_n} for {got[2]}, K2 {k2_n}")
    _card_vs_cpu(f"F4 L-BFGS arrow, stochastic_qp({SQP_CPU_S}, {ns})",
                 lambda: modellib.stochastic_qp(SQP_CPU_S, ns), dev, kw)
    out["arrow_sqp_8192_30"] = dict(status=got[0], iterations=got[1], factorizations=got[2],
                                    wall_s=wall, cold_s=cold_s, k1_launches=k1_n,
                                    peak_gib=peak,
                                    ms_per_iteration=wall / max(got[1], 1) * 1e3)

    kw = dict(LBFGS_STRUCT, print_level=0, **BANDED)
    _card_vs_cpu(f"F4 L-BFGS banded, luksan_vlcek1_flat({LVF_LBFGS_SMALL})",
                 lambda: modellib.luksan_vlcek1_flat(LVF_LBFGS_SMALL), dev, kw)
    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(modellib.luksan_vlcek1_flat(LVF_N),
                               ipopt_torch.Options(**kw), device=dev)
    setup_s = time.perf_counter() - t0
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, kw)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    bcr = res.batched_factorizations
    log(f"F4 L-BFGS banded: luksan_vlcek1_flat({LVF_N}) tol 1e-6, max_iter "
        f"{LBFGS['max_iter']}: (status, iterations, factorizations) {got}, objective "
        f"{float(res.obj)!r}; set-up {setup_s:.3f} s, warm {wall:.3f} s "
        f"({wall / max(got[1], 1) * 1e3:.1f} ms/iteration; exact {exact_ms['banded']:.1f}), "
        f"cold {cold_s:.3f} s, peak device memory {peak:.3f} GiB (exact Hessian "
        f"{exact_ms['banded_peak_gib']:.3f}); K2 launches {k2_n} ({bcr} BCR factorizations), K1 "
        f"launches {k1_n}; card {card}")
    if got[0] != 0 or k2_n != LVF_K2_PER_FACTORIZATION * bcr or k1_n:
        raise SystemExit(f"F4 banded: status {got[0]}, K2 {k2_n} for {bcr}, K1 {k1_n}")
    _lbfgs_vs_reference("F4 L-BFGS banded", res, "lv1flat_1e5_lbfgs_banded")
    out["banded_lv1_flat_1e5"] = dict(status=got[0], iterations=got[1], factorizations=got[2],
                                      setup_s=setup_s, wall_s=wall, cold_s=cold_s,
                                      peak_gib=peak,
                                      k2_launches=k2_n,
                                      ms_per_iteration=wall / max(got[1], 1) * 1e3)
    kw = dict(LBFGS, print_level=0)
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(nlp_b, dev, kw)
    iters = res.iter_count.cpu().numpy()
    status = res.status.cpu().numpy()
    n_ok = int((status == 0).sum())
    outer = int(iters.max())
    cpu = ipopt_torch.solve_batched(family, device="cpu", **kw)
    differ = np.nonzero(cpu.iter_count.numpy() != iters)[0]
    same = FAMILY_B - len(differ)
    for lane in differ[:10].tolist():
        log(f"F4 L-BFGS dense, lane {lane}: card (status, iterations, objective) "
            f"({int(status[lane])}, {int(iters[lane])}, {float(res.obj[lane])!r}), CPU "
            f"({int(cpu.status[lane])}, {int(cpu.iter_count[lane])}, "
            f"{float(cpu.obj[lane])!r})")
    lane0 = (int(status[0]), int(iters[0]), float(res.obj[0]))
    rel0 = abs(lane0[2] - HS071_LBFGS_REF[2]) / HS071_LBFGS_REF[2]
    from ipopt_torch.profile_main import capture_k1_inputs
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve_batched(nlp_b, device=dev, **kw))
    m = nlp_b.me + nlp_b.mi
    k1 = check_k1_inputs(dev, inputs, (FAMILY_B, m, m), "F4 L-BFGS dense", card)
    out["dense_hs071_512"] = dict(ok=n_ok, wall_s=wall, cold_s=cold_s, peak_gib=peak,
                                  ms_per_iteration=wall / outer * 1e3, max_iterations=outer,
                                  k1_launches=k1_n, k2_launches=k2_n,
                                  batched_factorizations=res.batched_factorizations,
                                  lanes_apart=differ.tolist(), k1=k1)
    log(f"F4 L-BFGS dense: solve_batched B={FAMILY_B}: {n_ok}/{FAMILY_B} status 0, "
        f"iterations median {statistics.median(iters.tolist())} max {outer}, warm "
        f"{wall:.3f} s ({wall / outer * 1e3:.1f} ms per outer iteration; exact "
        f"{exact_ms['dense']:.1f}), cold {cold_s:.3f} s; K1 launches {k1_n} (batched "
        f"factorizations {res.batched_factorizations}), K2 {k2_n}; lanes with the CPU's "
        f"iterations {same}/{FAMILY_B}; lane 0 {lane0}, reference {HS071_LBFGS_REF} "
        f"(rel diff {rel0:.2e}); card {card}")
    # a lane whose iterations differ from the CPU's: one of the lanes shown
    # to move with a few ulps, by one iteration, with the CPU's objective to
    # 1e-9; those lanes within one iteration of the reference's
    obj_cpu = cpu.obj.numpy()
    apart_ok = all(k in FAMILY_LBFGS_SENSITIVE
                   and abs(int(iters[k]) - int(cpu.iter_count[k])) == 1
                   and abs(float(res.obj[k]) - obj_cpu[k]) <= 1e-9 * abs(obj_cpu[k])
                   for k in differ.tolist())
    ref_ok = all(int(status[k]) == st and abs(int(iters[k]) - it) <= 1
                 and abs(float(res.obj[k]) - obj) <= 1e-9 * abs(obj)
                 for k, (st, it, obj) in FAMILY_LBFGS_SENSITIVE.items())
    rel_all = float(np.max(np.abs(res.obj.cpu().numpy() - obj_cpu) / np.abs(obj_cpu)))
    log(f"F4 L-BFGS dense: every lane's objective against the CPU's: max rel diff "
        f"{rel_all:.2e}; lanes apart {differ.tolist()} (allowed: "
        f"{sorted(FAMILY_LBFGS_SENSITIVE)}, one iteration each, objective to 1e-9: "
        f"{apart_ok}); lanes {sorted(FAMILY_LBFGS_SENSITIVE)} on the card "
        + ", ".join(f"({int(status[k])}, {int(iters[k])}, {float(res.obj[k])!r})"
                    for k in sorted(FAMILY_LBFGS_SENSITIVE))
        + f", the reference's {[FAMILY_LBFGS_SENSITIVE[k] for k in sorted(FAMILY_LBFGS_SENSITIVE)]}"
        f" (within one iteration, objective to 1e-9: {ref_ok})")
    if (n_ok != FAMILY_B or not apart_ok or not ref_ok
            or lane0[:2] != HS071_LBFGS_REF[:2] or rel0 > 1e-9
            or k1_n != res.batched_factorizations or k2_n):
        raise SystemExit("F4 dense: the L-BFGS family solve failed its checks")

    return out


def slice_f_phases(dev, opts, card, nlp_b, family, exact_ms):
    """F1-F4; returns their numbers for the kernels line."""
    phase("F1 arrow, stochastic_qp(8192, 30)")
    f1 = arrow_path(dev, opts, card, *SQP_F1, "F1")
    exact_ms["arrow"] = f1["ms_per_iteration"]
    phase("F2 arrow, stochastic_qp(1024, 126)")
    f2 = arrow_path(dev, opts, card, *SQP_F2, "F2")
    phase("F3 arrow restoration")
    f3 = arrow_restoration_path(dev, card)
    phase("F4 L-BFGS on every backend")
    f4 = lbfgs_paths(dev, card, nlp_b, family, exact_ms)
    return dict(f1=f1, f2=f2, f3=f3, f4=f4)


# ---------------------------------------------------------------------------
# Slice G: the nested-dissection multifrontal backend (K1 on every level's
# fronts), then the matrix-free, inexact and penalty step paths
# ---------------------------------------------------------------------------

MF = dict(linear_solver="multifrontal")
# G1: the 3-D distributed control (modellib.mittelmann_dist_control_3d) at
# N = 24: 27,648 variables, 13,824 equalities, 41,472 KKT unknowns in 15
# tree levels.  N = 16 is held against the reference's values
# (tests/torch_cases.py "nd3d_16", tools/torch_reference_values.py: the
# reference on the CPU at the options of bench.py:74-80): status,
# iterations, factorizations, objective; N = 10 card against CPU.
ND_N, ND_REF_N, ND_CPU_N = 24, 16, 10
ND16_REF = (0, 12, 24, 0.9916830657442102)
# G2: K1 at the widest fronts of N = 32 (the top three levels' (n_d, p))
ND32_STACKS = ((1, 3070), (2, 1417), (4, 1132))
# G3: the 2-D control at N = 30 on the multifrontal backend (tests/
# torch_cases.py "nd_mitt30"): it ends at another point than the banded
# backend's (MITT30_REF), 5.0e-7 apart in the objective, in the reference too
MITT30_ND_REF = (0, 25, 73, 0.07666695142007919)
# G4: the reference's (status, iterations, objective) of hs071 under each
# step path (tests/torch_cases.py, tools/torch_reference_values.py), and
# (status, iterations, factorizations, restorations, objective) of
# cg-penalty on luksan_vlcek1(4096, 32) ("lv1_4096_cgpen")
G4_HS071 = {"minres": (dict(linear_solver="minres", tol=1e-7),
                       (0, 9, 17.014017158377293)),
            "inexact": (dict(inexact_algorithm=True, max_iter=300),
                        (0, 8, 17.014017145179032)),
            "cg-penalty": (dict(line_search_method="cg-penalty", max_iter=300),
                           (0, 8, 17.014017145179167)),
            "penalty": (dict(line_search_method="penalty", max_iter=300),
                        (0, 7, 17.014017145176478))}
LV1_CGPEN_REF = (0, 35, 572, 14, 6.23245863243962)


def _torch_cases():
    """tests/torch_cases.py of this checkout (problem builders; it imports
    neither package at its top)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_cases
    return torch_cases


def blocked_breakdown(A, rounds=2):
    """Device ms per call of K1's blocked variant on A, by kernel (init,
    panel, update), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.profile_main import _device_us
    import torch
    bl.block_ldlt(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            bl.block_ldlt(A)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("init", "panel", "update"):
            if f"ldlt_blocked_{name}" in e.key:
                out[name] = out.get(name, 0.0) + _device_us(e) / rounds * 1e-3
    return out


def check_k1_levels(dev, inputs, levels, path, card, pivot_tol=0.0):
    """K1 on every input of a multifrontal solve (the eliminated blocks of
    each level of each factorization), held to its plain version by
    ``k1_agrees`` at the solve's ``pivot_tol`` (bit for bit on the warp and
    CTA levels, by k1_rule on the blocked ones); then per level, on the
    first factorization's inputs: K1's time per call (CUDA events), the
    plain version's, torch.linalg.ldl_factor_ex's (Bunch-Kaufman: another
    function, a yardstick) and the bound."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    max_abs_err = worst = 0.0
    n_blocked = 0
    for A in inputs:
        L_k, d_k = bl.block_ldlt(A)
        L_p, d_p = bl.block_ldlt_plain(A)
        ok, why, how, ratio = k1_agrees(A, L_k, d_k, L_p, d_p, pivot_tol)
        if not ok:
            raise SystemExit(f"K1 on the {path} path: an input of {tuple(A.shape)} "
                             f"where the kernel differs from its plain version: {why}")
        n_blocked += how == "rule"
        worst = max(worst, ratio)
        for x, y in ((L_k, L_p), (d_k, d_p)):
            fin = torch.isfinite(x) & torch.isfinite(y)
            max_abs_err = max(max_abs_err, float(torch.where(fin, x - y, 0.0).abs().max()))
        del L_k, d_k, L_p, d_p
    rows = []
    for A in inputs[:levels]:
        nb, b = A.shape[0], A.shape[-1]
        big = b > 512
        ms = time_cuda(lambda: bl.block_ldlt(A), reps=2 if big else 10, warmup=1)
        plain_ms = time_cuda(lambda: bl.block_ldlt_plain(A), reps=1, warmup=1)
        ldl_ms = time_cuda(lambda: torch.linalg.ldl_factor_ex(A), reps=1, warmup=1)
        bound_ms, bound_by, _, _ = k1_bound(nb, b, A.dtype)
        pl = bl.plan(nb, b, A.dtype)
        row = dict(shape=[nb, b, b], variant=pl.variant, cuda_launches=pl.kernels,
                   ms=ms, plain_ms=plain_ms, library_ms=ldl_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        split = ""
        if pl.variant == "blocked":
            # the blocked variant's device time per call by kernel
            with timed("G1 blocked variant's device time by kernel"):
                row["device_ms_by_kernel"] = blocked_breakdown(A)
            split = "; device ms per call by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["device_ms_by_kernel"].items())
        rows.append(row)
        log(f"K1 on the {path} path, level ({nb}, {b}, {b}) plan {pl.variant} "
            f"({pl.kernels} CUDA launches per call): {ms:.4f} ms per call (CUDA "
            f"events), bound {bound_ms:.6f} ms ({bound_by}), {ms / bound_ms:.1f}x; plain "
            f"{plain_ms:.4f} ms; torch.linalg.ldl_factor_ex {ldl_ms:.4f} ms{split}")
    per_fac = sum(r["ms"] for r in rows)
    log(f"K1 on the {path} path: {len(inputs)} inputs held to the plain version "
        f"({len(inputs) - n_blocked} bit-equal, {n_blocked} float64 blocked by its rule, worst "
        f"backward error / limit {worst:.3e}); {per_fac:.3f} ms per factorization over "
        f"its {levels} levels (bound {sum(r['bound_ms'] for r in rows):.6f} ms); "
        f"{sum(r['cuda_launches'] for r in rows)} CUDA launches per factorization; "
        f"card {card}")
    return dict(levels=rows, ms_per_factorization=per_fac, max_abs_err=max_abs_err,
                inputs=len(inputs), blocked_inputs=n_blocked, worst_backward_ratio=worst)


def multifrontal_path(dev, opts, card):
    """G1: solve(mittelmann_dist_control_3d(24), linear_solver=
    "multifrontal") on the card: set-up, cold, warm with the counts from 0
    (status 0; K1 once per level of every factorization, K2 never) and K1
    timed inside it per launch; K1 on every input of the cold solve (the
    same factorizations as the warm one's) against its plain version and
    relaunched per level; N = 16 against the reference's values; N = 10
    card against CPU."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import nested_dissection as nd
    from ipopt_torch.profile_main import capture_k1_inputs, time_k1_calls
    from ipopt_torch.sparse import canonicalize_sparse
    kw = dict(opts, **MF)
    # K1 is watched call by call, so both solves run the eager level loops:
    # a recorded solve (timing_statistics) replays no graph
    kw_eager = dict(kw, timing_statistics=True)
    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(modellib.mittelmann_dist_control_3d(ND_N),
                               ipopt_torch.Options(**kw), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = cnlp.chain
    fronts_gb = info.total_slots * 8 / 1e9
    log(f"G1 set-up: canonicalize_sparse(mittelmann_dist_control_3d({ND_N})) "
        f"{setup_s:.3f} s: n = {info.n}, m = {info.me + info.mi}, KKT {info.N}, "
        f"{len(info.levels)} levels (n_d, p, u) "
        f"{[(lv.n_nodes, lv.p, lv.u) for lv in info.levels]}, fronts {fronts_gb:.3f} GB")
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    # the cold solve also captures every K1 input (checked after the warm one)
    t0 = time.perf_counter()
    results = []
    inputs = capture_k1_inputs(
        lambda: results.append(ipopt_torch.solve(cnlp, device=dev, **kw_eager)))
    cold = results[0]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    nd.nd_factorize.calls = nd.nd_factorize.levels = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # K1 timed inside the warm solve by CUDA events around each launch
    res, k1_calls = time_k1_calls(lambda: ipopt_torch.solve(cnlp, device=dev, **kw_eager))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = bl.block_ldlt.launches, k2.block_ldlt_inv.launches
    want, n_fac = nd.nd_factorize.levels, nd.nd_factorize.calls
    # less the captured inputs, which the solve does not hold
    held = sum(A.element_size() * A.numel() for A in inputs)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    if int(cold.iter_count) != got[1]:
        raise SystemExit("G1: the cold and the warm solves differ")
    log(f"G1 multifrontal: solve(mittelmann_dist_control_3d({ND_N})) float64: "
        f"(status, iterations, factorizations, restorations) {got}, objective "
        f"{float(res.obj)!r}; warm solve, eager level loops (recorded) {wall:.3f} s "
        f"({wall / max(got[1], 1) * 1e3:.1f} ms/iteration), cold {cold_s:.3f} s, "
        f"set-up {setup_s:.3f} s, peak device memory {peak:.3f} GiB; K1 launches "
        f"{k1_n} (levels x factorizations: {want} over {n_fac} "
        f"factorizations), K2 launches {k2_n}; card {card}")
    if got[0] != 0 or k2_n or k1_n != want or k1_n == 0:
        raise SystemExit(f"G1: status {got[0]}, K1 launches {k1_n} (want {want}), "
                         f"K2 launches {k2_n}")
    if len(inputs) != want:
        raise SystemExit(f"G1: {len(inputs)} K1 inputs in the cold solve, {want} "
                         f"launches in the warm one")
    k1 = check_k1_levels(dev, inputs, len(info.levels), "G1 multifrontal", card)
    del inputs
    k1_solve_ms = sum(ms for _, ms in k1_calls)
    per_level = {}
    for shape, ms in k1_calls:
        per_level.setdefault(str(list(shape)), []).append(ms)
    per_level = {k: sum(v) / len(v) for k, v in per_level.items()}
    log(f"G1: K1 {k1_solve_ms / 1e3:.3f} s of the {wall:.3f} s warm solve "
        f"({k1_solve_ms / 1e3 / wall:.3f} of its wall; CUDA events around its "
        f"{len(k1_calls)} launches inside the solve); mean ms per launch by level "
        f"{ {k: round(v, 4) for k, v in per_level.items()} }; card {card}")
    out = dict(n=info.n, kkt=info.N, levels=[list(lv_[:3]) for lv_ in info.levels],
               fronts_gb=fronts_gb, status=got[0], iterations=got[1],
               factorizations=got[2], restorations=got[3], setup_s=setup_s,
               wall_s=wall, cold_s=cold_s, peak_gib=peak,
               ms_per_iteration=wall / max(got[1], 1) * 1e3, k1_launches=k1_n,
               k1_in_solve_ms=k1_solve_ms, k1_in_solve_ms_per_level=per_level,
               k1_share_of_wall=k1_solve_ms / 1e3 / wall,
               k1=k1)

    r16 = ipopt_torch.solve(modellib.mittelmann_dist_control_3d(ND_REF_N), device=dev, **kw)
    got16 = (int(r16.status), int(r16.iter_count), int(r16.counters.n_factorizations))
    rel16 = abs(float(r16.obj) - ND16_REF[3]) / abs(ND16_REF[3])
    log(f"G1 N = {ND_REF_N}: (status, iterations, factorizations) {got16}, objective "
        f"{float(r16.obj)!r}; reference {ND16_REF}, rel diff {rel16:.2e} (tol 1e-9)")
    if got16 != ND16_REF[:3] or rel16 > 1e-9:
        raise SystemExit(f"G1: N = {ND_REF_N} differs from the reference")
    _card_vs_cpu(f"G1 N = {ND_CPU_N}", lambda: modellib.mittelmann_dist_control_3d(ND_CPU_N),
                 dev, kw)
    return out


def k1_wide_stacks(dev, card):
    """G2: K1 on seeded stacks at the widest fronts of N = 32 (the blocked
    variant), held to its plain version by k1_rule and timed beside its
    bound, the plain version and torch.linalg.ldl_factor_ex."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    rng = np.random.default_rng(32)
    rows = []
    for nb, b in ND32_STACKS:
        A = k1_blocks(rng, nb, b, torch.float64).to(dev)
        L_k, d_k = bl.block_ldlt(A)
        L_p, d_p = bl.block_ldlt_plain(A)
        ok, why, _, ratio = k1_agrees(A, L_k, d_k, L_p, d_p)
        del L_k, d_k, L_p, d_p
        # timed without the inf block, whose CTA takes the library division
        At = A[:-1] if nb > 1 else A
        nb = At.shape[0]
        ms = time_cuda(lambda: bl.block_ldlt(At), reps=1, warmup=0)
        plain_ms = time_cuda(lambda: bl.block_ldlt_plain(At), reps=1, warmup=0)
        ldl_ms = time_cuda(lambda: torch.linalg.ldl_factor_ex(At), reps=1, warmup=0)
        bound_ms, bound_by, _, _ = k1_bound(nb, b, torch.float64)
        pl = bl.plan(nb, b, torch.float64)
        log(f"G2 K1 seeded ({nb}, {b}, {b}) float64 plan {pl.variant} ({pl.kernels} "
            f"CUDA launches per call): against the plain version {why}; {ms:.3f} ms per "
            f"call (CUDA events), bound "
            f"{bound_ms:.6f} ms ({bound_by}), {ms / bound_ms:.0f}x; plain "
            f"{plain_ms:.3f} ms; torch.linalg.ldl_factor_ex {ldl_ms:.3f} ms; card {card}")
        if not ok:
            raise SystemExit(f"G2: K1 differs from its plain version at ({nb}, {b}): {why}")
        rows.append(dict(shape=[nb, b, b], variant=pl.variant, cuda_launches=pl.kernels,
                         ms=ms, plain_ms=plain_ms, library_ms=ldl_ms, bound_ms=bound_ms,
                         bound_by=bound_by, backward_ratio=ratio))
    return rows


def multifrontal_checks(dev, opts, card):
    """G3: the multifrontal restoration (tests/test_nested_dissection.py:
    108-121's problem, and an infeasible one that runs the restoration on
    this backend), card against CPU; the 2-D control at N = 30 on the
    multifrontal and the banded backends, each against the reference's
    values on that backend (the two end 5.0e-7 apart in the objective, in
    the reference too)."""
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    torch_cases = _torch_cases()
    kw = dict(opts, **MF)
    bl.block_ldlt.launches = 0
    _card_vs_cpu("G3 multifrontal, the restoration analysis case",
                 lambda: torch_cases.build("nd_resto", "port"), dev, kw)
    got = _card_vs_cpu("G3 multifrontal restoration (infeasible)",
                       lambda: torch_cases.build("infeasible", "port"), dev, kw,
                       rtol=None, status=6)
    if got[3] == 0 or bl.block_ldlt.launches == 0:
        raise SystemExit("G3: no restoration, or K1 not launched")
    rows = {}
    for name, solver, ref in (("multifrontal", "multifrontal", MITT30_ND_REF),
                              ("banded-bcr", "banded-bcr", MITT30_REF)):
        r = ipopt_torch.solve(modellib.mittelmann_dist_control(30), device=dev,
                              **dict(opts, linear_solver=solver))
        rows[name] = (int(r.status), int(r.iter_count), int(r.counters.n_factorizations),
                      float(r.obj))
        rel = abs(rows[name][3] - ref[3]) / abs(ref[3])
        log(f"G3 mittelmann_dist_control(30) {name}: (status, iterations, "
            f"factorizations) {rows[name][:3]}, objective {rows[name][3]!r}; "
            f"reference {ref}, rel diff {rel:.2e} (tol 1e-9)")
        if rows[name][:3] != ref[:3] or rel > 1e-9:
            raise SystemExit(f"G3: mittelmann_dist_control(30) {name} differs from the "
                             f"reference")
    diff = abs(rows["multifrontal"][3] - rows["banded-bcr"][3])
    log(f"G3 mittelmann_dist_control(30): the two backends end {diff:.3e} apart in "
        f"the objective, as the reference's do; card {card}")
    return dict(infeasible=got, mitt30=rows, mitt30_diff=diff)


def step_paths(dev, opts, card):
    """G4: hs071 under minres, the inexact algorithm, cg-penalty and penalty
    (card against CPU and against the reference's values); the 1-D control
    of tests/test_inexact.py:43-71 with the inexact algorithm (card against
    CPU); cg-penalty on luksan_vlcek1(4096, 32), cold then warm with its K2
    launches counted (restorations included), and K2 held against its plain
    version on every input of the cold solve."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.profile_main import capture_k2_inputs
    torch_cases = _torch_cases()
    out = {}
    for name, (kw, ref) in G4_HS071.items():
        out[name] = _card_vs_cpu(f"G4 hs071 {name}", modellib.hs071, dev,
                                 dict(kw, print_level=0), ref=ref)
    _card_vs_cpu("G4 the 1-D control, inexact", lambda: torch_cases.build("control_1d", "port"),
                 dev, dict(print_level=0, inexact_algorithm=True, max_iter=300, tol=1e-7))
    kw = dict(opts, line_search_method="cg-penalty")
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**kw), device=dev)
    # the cold solve also captures every K2 input (checked after the warm one)
    results = []
    inputs = capture_k2_inputs(
        lambda: results.append(ipopt_torch.solve(cnlp, device=dev, **kw)))
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = bl.block_ldlt.launches, k2.block_ldlt_inv.launches
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    # every factorization of the main chain and of the restoration's has
    # LV1_K2_PER_FACTORIZATION levels
    log(f"G4 cg-penalty chained: solve(luksan_vlcek1({LV1_N}, {LV1_V})) (status, "
        f"iterations, factorizations, restorations) {got}, objective "
        f"{float(res.obj)!r}; reference {LV1_CGPEN_REF}; warm {wall:.3f} s "
        f"({wall / max(got[1], 1) * 1e3:.1f} ms/iteration); K2 launches {k2_n} "
        f"({k2_n // LV1_K2_PER_FACTORIZATION} factorizations of "
        f"{LV1_K2_PER_FACTORIZATION} levels, restorations' included), K1 {k1_n}; "
        f"card {card}")
    rel = abs(float(res.obj) - LV1_CGPEN_REF[4]) / LV1_CGPEN_REF[4]
    if (got != LV1_CGPEN_REF[:4] or rel > 1e-9 or k1_n
            or k2_n < LV1_K2_PER_FACTORIZATION * got[2]
            or k2_n % LV1_K2_PER_FACTORIZATION or len(inputs) != k2_n
            or int(results[0].iter_count) != got[1]):
        raise SystemExit(f"G4: cg-penalty on the chained path: {got}, K2 {k2_n}, "
                         f"K1 {k1_n}, {len(inputs)} inputs in the cold solve")
    k2_check = check_k2_stacked(inputs, "G4 cg-penalty chained", card)
    del inputs
    out["cg_penalty_chained"] = dict(status=got[0], iterations=got[1],
                                     factorizations=got[2], restorations=got[3],
                                     wall_s=wall, k2_launches=k2_n, k2=k2_check)
    return out


def slice_g_phases(dev, opts, card):
    """G1-G4; returns their numbers for the kernels line."""
    phase("G1 multifrontal, mittelmann_dist_control_3d(24)")
    g1 = multifrontal_path(dev, opts, card)
    phase("G2 K1 at the widest fronts of N = 32")
    g2 = k1_wide_stacks(dev, card)
    phase("G3 multifrontal restoration and backends")
    g3 = multifrontal_checks(dev, opts, card)
    phase("G4 minres, inexact, penalty and cg-penalty")
    g4 = step_paths(dev, opts, card)
    return dict(g1=g1, g2=g2, g3=g3, g4=g4)


# -- slice H: float32 factorizations on the solve paths, the blocked dense
#    LDL^T, sensitivity and the hooks -----------------------------------------
# H1: the mixed-precision options of the reference's tests/test_mixed_precision.py
F32FAC = dict(factorization_dtype="float32", tol=1e-7)
F32IT = dict(dtype="float32", refinement_precision="double", tol=1e-7)
# finite differences at tol 1e-7 (tests/torch_cases.py "fam*_fd": at 1e-8
# their noise decides the last iterations)
FD = dict(gradient_approximation="finite-difference-values",
          jacobian_approximation="finite-difference-values", tol=1e-7)
FAMILY_LANES = (0, 255, 511)
# H3: LuksanVlcek1 as one dense NLP: KKT 1998 wide, 16 panels of 128
BLOCKED_N = 1000
# H1's multifrontal solve at N = 24 stops after this many iterations (depth
# cut for the script's time: the whole float32 solve enters the restoration
# phase and takes ~120 s on the card; K1 runs in float32 on every level of
# each factorization all the same)
H1_ND_MAX_ITER = 3
# ... and its card-against-CPU check runs at N = 6 (tests/torch_cases.py
# "mp_nd3d_6_f32fac": the reference's float32 solve ends in status 10 after
# 19 iterations and one restoration)
H1_ND_CPU_N = 6
# H2's family: one lane of 512 runs to max_iter (3000 iterations, ~300 s on
# the card); the other lanes end within 12 iterations
H2_MAX_ITER = 100
# H4: the 1-D boundary control on the chained backend at N = 2048 (64 blocks
# of 156; status 0 in 10 iterations): at N = 4096 the solve ends in status 10
# after 7 iterations, on the card and on the CPU (ROADMAP Queue 3)
SENS_CHAIN_N, SENS_CHAIN_V, SENS_CPU_N = 2048, 32, 512


def _recorded(name):
    """The reference's recorded (status, iterations, objective) of a case of
    tests/torch_cases.py (tools/torch_reference_values.py)."""
    rec = _torch_cases().recorded()[name]
    return rec["status"], rec["iter_count"], rec["obj"]


def _lanes_vs_reference(path, res, name_of_lane, rtol=1e-9):
    """Lanes FAMILY_LANES of a batched result against the reference's
    recorded solves of those lanes: status and iterations equal, objective
    to ``rtol``."""
    for i in FAMILY_LANES:
        ref = _recorded(name_of_lane(i))
        got = (int(res.status[i]), int(res.iter_count[i]), float(res.obj[i]))
        rel = abs(got[2] - ref[2]) / abs(ref[2])
        log(f"{path} lane {i}: (status, iterations, objective) {got}; reference "
            f"{tuple(ref)}, rel diff {rel:.2e} (tol {rtol:g})")
        if got[:2] != tuple(ref[:2]) or rel > rtol:
            raise SystemExit(f"{path}: lane {i} differs from the reference")


def _count_reset():
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    bl.block_ldlt.launches = 0
    k2.block_ldlt_inv.launches = 0


def _counts():
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2
    return bl.block_ldlt.launches, k2.block_ldlt_inv.launches


def h1_dense(dev, card, family):
    """H1 dense: the HS071 family, B = 512, float64 iterate, float32 KKT
    factorizations: 512/512 status 0, lanes 0, 255, 511 at the reference's
    values, the first 8 lanes' iterations equal to the CPU's; K1 launches
    counted from 0 equal to the batched factorizations, bit-equal to its
    plain version on every input of the warm solve and timed on them."""
    import torch
    import ipopt_torch
    from ipopt_torch.profile_main import capture_k1_inputs
    kw = dict(F32FAC, print_level=0)
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**kw), device=dev)
    ipopt_torch.solve_batched(nlp_b, device=dev, **kw)
    _count_reset()
    out = []
    t0 = time.perf_counter()
    inputs = capture_k1_inputs(lambda: out.append(
        ipopt_torch.solve_batched(nlp_b, device=dev, **kw)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = out[0]
    k1_n, k2_n = _counts()
    n_ok = int((res.status == 0).sum())
    log(f"H1 dense: solve_batched(HS071 family, B = {FAMILY_B}) float64 iterate, "
        f"float32 factorizations, tol 1e-7: {n_ok}/{FAMILY_B} status 0, warm solve "
        f"{wall:.3f} s (inputs captured meanwhile); K1 launches {k1_n}, batched "
        f"factorizations {res.batched_factorizations}, K2 launches {k2_n}; K1 inputs "
        f"{sorted({(tuple(A.shape), str(A.dtype)[6:]) for A in inputs})}; card {card}")
    if n_ok != FAMILY_B or k1_n != res.batched_factorizations or k1_n == 0 or k2_n:
        raise SystemExit("H1 dense: not every lane converged, or the launches are off")
    # the KKT inputs (b = 7) in float32; the initial multipliers' system
    # (b = 2) is not a KKT factorization and keeps the model's dtype
    if any(A.dtype != torch.float32 for A in inputs if A.shape[-1] == 7):
        raise SystemExit("H1 dense: a KKT factorization was not float32")
    _lanes_vs_reference("H1 dense", res, lambda i: f"fam{i}_f32fac")
    cpu = ipopt_torch.solve_batched(family[:8], device="cpu", **kw)
    if cpu.iter_count.tolist() != res.iter_count[:8].tolist():
        raise SystemExit(f"H1 dense: iterations {res.iter_count[:8].tolist()} differ "
                         f"from the CPU's {cpu.iter_count.tolist()}")
    k1 = check_k1_inputs(dev, inputs, (FAMILY_B, 7, 7), "H1 dense float32", card)
    return dict(k1, k1_launches=k1_n, wall_s=wall)


def h1_chained(dev, card, kw=None, tag="H1 chained"):
    """luksan_vlcek1(4096, 32), float64 iterate, float32 BCR levels (K2 in
    float32, the cluster variant at (64, 156, 156)): cold capturing K2's
    inputs, warm with the counts from 0; K2 within its rule on every input
    and timed per level; (256, 32) card against CPU and the reference."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.profile_main import capture_k2_inputs
    kw = dict(F32FAC, print_level=0) if kw is None else kw
    assert not torch.backends.cuda.matmul.allow_tf32
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**kw), device=dev)
    cold = []
    inputs = capture_k2_inputs(lambda: cold.append(ipopt_torch.solve(cnlp, device=dev, **kw)))
    _count_reset()
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = _counts()
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    log(f"{tag}: solve(luksan_vlcek1({LV1_N}, {LV1_V})) {kw}: (status, iterations, "
        f"factorizations) {got}, objective {float(res.obj)!r} (float64 reference "
        f"{LV1_OBJ!r}); warm {wall:.3f} s ({wall / max(got[1], 1) * 1e3:.1f} "
        f"ms/iteration); K2 launches {k2_n}, K1 {k1_n}; K2 inputs "
        f"{sorted({str(A.dtype)[6:] for A in inputs})}; card {card}")
    ok_status = (0,) if kw.get("dtype") != "float32" else (0, 4, 5)
    if (got[0] not in ok_status or k1_n or k2_n != LV1_K2_PER_FACTORIZATION * got[2]
            or int(cold[0].iter_count) != got[1]
            or abs(float(res.obj) - LV1_OBJ) > 5e-6):
        raise SystemExit(f"{tag}: {got}, K2 {k2_n}, K1 {k1_n}")
    if any(A.dtype != torch.float32 for A in inputs):
        raise SystemExit(f"{tag}: a BCR level was not float32")
    return res, wall, k2_n, inputs


def h1_banded(dev, card):
    """luksan_vlcek1_flat(1e5) with mc19 and float32 BCR levels (K2 in
    float32 at (6250, 16, 16) first): status 0 or 5 (the reference's
    test_mixed_precision.py:44-55 admits the acceptable level), the
    objective at the float64 optimum to 1e-8 (refinement against the
    float64 K); n = 2000 card against CPU and the reference."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.sparse import canonicalize_sparse
    from ipopt_torch.profile_main import capture_k2_inputs
    kw = dict(F32FAC, print_level=0, linear_system_scaling="mc19", **BANDED)
    cnlp = canonicalize_sparse(modellib.luksan_vlcek1_flat(LVF_N),
                               ipopt_torch.Options(**kw), device=dev)
    cold = []
    inputs = capture_k2_inputs(lambda: cold.append(ipopt_torch.solve(cnlp, device=dev, **kw)))
    _count_reset()
    t0 = time.perf_counter()
    res = ipopt_torch.solve(cnlp, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = _counts()
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    log(f"H1 banded: solve(luksan_vlcek1_flat({LVF_N}), banded-bcr, mc19) float64 "
        f"iterate, float32 factorizations, tol 1e-7: (status, iterations, "
        f"factorizations) {got}, objective {float(res.obj)!r} (float64 reference "
        f"{LVF_OBJ!r}); warm {wall:.3f} s; K2 launches {k2_n}, K1 {k1_n}; card {card}")
    if (got[0] not in (0, 5) or k1_n or k2_n != LVF_K2_PER_FACTORIZATION * got[2]
            or abs(float(res.obj) - LVF_OBJ) > 1e-8 or int(cold[0].iter_count) != got[1]):
        raise SystemExit(f"H1 banded: {got}, K2 {k2_n}, K1 {k1_n}")
    if any(A.dtype != torch.float32 for A in inputs):
        raise SystemExit("H1 banded: a BCR level was not float32")
    _card_vs_cpu("H1 banded, luksan_vlcek1_flat(2000)",
                 lambda: modellib.luksan_vlcek1_flat(2000), dev, kw,
                 ref=_recorded("lv1flat_2000_f32fac"),
                 status=_recorded("lv1flat_2000_f32fac")[0])
    return res, wall, k2_n, inputs


def h1_multifrontal(dev, card):
    """mittelmann_dist_control_3d(24), float64 iterate, float32 fronts (K1 in
    float32 on every level), once: status, K1 once per level of every
    factorization, K1 bit-equal to its plain version on the first
    factorization's 15 level inputs and timed per level, peak device
    memory; N = 6 card against CPU and the reference."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.linalg import nested_dissection as nd
    from ipopt_torch.sparse import canonicalize_sparse
    kw = dict(F32FAC, print_level=0, **MF)
    cnlp = canonicalize_sparse(modellib.mittelmann_dist_control_3d(ND_N),
                               ipopt_torch.Options(**kw), device=dev)
    # K1's inputs are kept call by call: the eager level loops of a recorded
    # solve (timing_statistics), which replays no graph
    kw_n = dict(kw, max_iter=H1_ND_MAX_ITER, timing_statistics=True)
    levels = len(cnlp.chain.levels)
    _count_reset()
    nd.nd_factorize.calls = nd.nd_factorize.levels = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    from ipopt_torch.linalg import block_tridiag as btd
    inner = btd.block_ldlt
    held = []

    def keep_first(A):
        # the first factorization's level inputs only (a copy each)
        if len(held) < levels:
            held.append(A.clone())
        return inner(A)

    btd.block_ldlt = keep_first
    t0 = time.perf_counter()
    try:
        res = ipopt_torch.solve(cnlp, device=dev, **kw_n)
        torch.cuda.synchronize()
    finally:
        btd.block_ldlt = inner
    wall = time.perf_counter() - t0
    held_b = sum(A.element_size() * A.numel() for A in held)
    peak = (torch.cuda.max_memory_allocated() - held_b) / 2**30
    k1_n, k2_n = _counts()
    want = nd.nd_factorize.levels
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations),
           int(res.restoration_count))
    log(f"H1 multifrontal: solve(mittelmann_dist_control_3d({ND_N}), max_iter "
        f"{H1_ND_MAX_ITER}) float64 iterate, float32 fronts, tol 1e-7, eager level "
        f"loops (recorded): (status, "
        f"iterations, factorizations, "
        f"restorations) {got}, objective {float(res.obj)!r}; solve {wall:.3f} s "
        f"(one, cold); peak device memory {peak:.3f} GiB (float64 fronts: 10.55 GiB, "
        f"G1 of PR 8), {base / 2**30:.3f} GiB held before; K1 launches {k1_n} "
        f"(levels x factorizations {want}), K2 {k2_n}; card {card}")
    # the status is printed, not held (the solve stops at H1_ND_MAX_ITER);
    # N = 6 is held to the reference's recorded value below
    if (not np.isfinite(float(res.obj)) or k1_n != want or k2_n
            or len(held) != levels):
        raise SystemExit(f"H1 multifrontal: {got}, K1 {k1_n} (want {want}), K2 {k2_n}")
    if any(A.dtype != torch.float32 for A in held):
        raise SystemExit("H1 multifrontal: a front was not float32")
    k1 = check_k1_levels(dev, held, levels, "H1 multifrontal float32", card)
    del held
    _card_vs_cpu(f"H1 multifrontal N = {H1_ND_CPU_N}",
                 lambda: modellib.mittelmann_dist_control_3d(H1_ND_CPU_N), dev, kw,
                 ref=_recorded("mp_nd3d_6_f32fac"),
                 status=_recorded("mp_nd3d_6_f32fac")[0])
    return dict(k1, k1_launches=k1_n, status=got[0], iterations=got[1],
                factorizations=got[2], wall_s=wall, peak_gib=peak)


def h1_phase(dev, card, family, f64):
    """H1: float64 iterate, float32 factorization on the four factored
    backends; each kernel's float32 time per level beside its float64 time
    of this run (``f64``) and its bound."""
    from ipopt_torch import modellib
    dense = h1_dense(dev, card, family)
    phase("H1 chained")
    _card_vs_cpu("H1 chained, luksan_vlcek1(256, 32)",
                 lambda: modellib.luksan_vlcek1(256, 32), dev,
                 dict(F32FAC, print_level=0), ref=_recorded("lv1_256_f32fac"),
                 status=_recorded("lv1_256_f32fac")[0])
    _, c_wall, c_k2, c_inputs = h1_chained(dev, card)
    chained = check_k2_on_path(dev, c_inputs, LV1_K2_PER_FACTORIZATION,
                               "H1 chained float32", card)
    del c_inputs
    phase("H1 banded")
    _, b_wall, b_k2, b_inputs = h1_banded(dev, card)
    banded = check_k2_on_path(dev, b_inputs, LVF_K2_PER_FACTORIZATION,
                              "H1 banded float32", card)
    del b_inputs
    phase("H1 multifrontal")
    mf = h1_multifrontal(dev, card)
    log(f"H1 K1 (512, 7, 7): float32 {dense['ms']:.5f} ms, float64 "
        f"{f64.get('k1_hs071_ms', float('nan')):.5f} ms, float32 bound "
        f"{dense['bound_ms']:.6f} ms ({dense['bound_by']}); card {card}")
    log("H1 K2 chained per level, float32 / float64 ms: " + ", ".join(
        f"{a:.4f} / {b:.4f}" for a, b in zip(chained["level_ms"],
                                             f64.get("k2_chained_level_ms", []))))
    log("H1 K2 banded per level, float32 / float64 ms: " + ", ".join(
        f"{a:.4f} / {b:.4f}" for a, b in zip(banded["level_ms"],
                                             f64.get("k2_banded_level_ms", []))))
    log("H1 K1 multifrontal per level (n_d, p): float32 / float64 ms (bound): " + ", ".join(
        f"{tuple(r['shape'][:2])} {r['ms']:.4f} / {q['ms']:.4f} ({r['bound_ms']:.6f})"
        for r, q in zip(mf["levels"], f64.get("k1_nd_levels", []))))
    return dict(dense=dense, chained=dict(chained, launches=c_k2, wall_s=c_wall),
                banded=dict(banded, launches=b_k2, wall_s=b_wall), multifrontal=mf)


def h2_phase(dev, card, family):
    """H2: float32 iterate with refinement_precision="double": the family at
    B = 512 (statuses equal to the CPU's on the first 8 lanes and 255, 511,
    objectives to 1e-6, lane 0 at the reference's recorded status and
    iterations and objective to 1e-6) and luksan_vlcek1(4096, 32) (status
    0, 4 or 5 as the reference's test admits, objective at the float64
    optimum to 5e-6; (256, 32) card against the reference)."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    kw = dict(F32IT, print_level=0, max_iter=H2_MAX_ITER)
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**kw), device=dev)
    _count_reset()
    t0 = time.perf_counter()
    res = ipopt_torch.solve_batched(nlp_b, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = _counts()
    lanes = list(range(8)) + [FAMILY_B // 2 - 1, FAMILY_B - 1]
    cpu = ipopt_torch.solve_batched([family[i] for i in lanes], device="cpu", **kw)
    st = res.status.cpu()
    log(f"H2 dense: solve_batched(HS071 family, B = {FAMILY_B}) float32 iterate, "
        f"refinement_precision double, tol 1e-7, max_iter {H2_MAX_ITER}: statuses "
        f"{dict(zip(*np.unique(st.numpy(), return_counts=True)))}, x dtype "
        f"{res.x.dtype}; {wall:.3f} s; K1 launches {k1_n}, K2 {k2_n}; card {card}")
    for j, i in enumerate(lanes):
        rel = abs(float(res.obj[i]) - float(cpu.obj[j])) / abs(float(cpu.obj[j]))
        if int(res.status[i]) != int(cpu.status[j]) or rel > 1e-6:
            raise SystemExit(f"H2 dense: lane {i} card ({int(res.status[i])}, "
                             f"{float(res.obj[i])!r}) against CPU ({int(cpu.status[j])}, "
                             f"{float(cpu.obj[j])!r})")
    ref = _recorded("fam0_f32it")
    rel0 = abs(float(res.obj[0]) - ref[2]) / abs(ref[2])
    log(f"H2 dense lane 0: ({int(res.status[0])}, {int(res.iter_count[0])}, "
        f"{float(res.obj[0])!r}); reference {tuple(ref)}, rel diff {rel0:.2e} (tol "
        f"1e-6); lanes {lanes} equal the CPU's statuses, objectives to 1e-6 "
        f"(iterations card {res.iter_count[lanes].tolist()}, CPU "
        f"{cpu.iter_count.tolist()})")
    if (int(res.status[0]), int(res.iter_count[0])) != tuple(ref[:2]) or rel0 > 1e-6:
        raise SystemExit("H2 dense: lane 0 differs from the reference")
    kw = dict(F32IT, print_level=0)
    small = ipopt_torch.solve(modellib.luksan_vlcek1(256, 32), device=dev, **kw)
    ref = _recorded("lv1_256_f32it")
    rel = abs(float(small.obj) - ref[2]) / abs(ref[2])
    log(f"H2 chained luksan_vlcek1(256, 32): ({int(small.status)}, "
        f"{int(small.iter_count)}, {float(small.obj)!r}); reference {tuple(ref)}, "
        f"rel diff {rel:.2e} (tol 1e-6)")
    if int(small.status) != ref[0] or rel > 1e-6:
        raise SystemExit("H2 chained: (256, 32) differs from the reference")
    cres, c_wall, c_k2, inputs = h1_chained(dev, card, kw, "H2 chained")
    del inputs
    return dict(dense=dict(k1_launches=k1_n, wall_s=wall),
                chained=dict(k2_launches=c_k2, wall_s=c_wall, status=int(cres.status),
                             iterations=int(cres.iter_count)))


def h3_phase(dev, card):
    """H3: linear_solver="dense-ldlt-blocked": luksan_vlcek1_dense(100) (KKT
    198, 2 panels) card against CPU and the reference; luksan_vlcek1_dense(
    1000) (KKT 1998, 16 panels of 128) at status 0, K1 16 times per
    factorization at (1, 128, 128), bit-equal on every input, and its wall
    beside the same solve under dense-ldlt (K1's blocked variant at b =
    1998, held by k1_rule on every input of that solve)."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.profile_main import capture_k1_inputs
    assert not torch.backends.cuda.matmul.allow_tf32
    blk = dict(print_level=0, linear_solver="dense-ldlt-blocked")
    _card_vs_cpu("H3 blocked, luksan_vlcek1_dense(100)",
                 lambda: modellib.luksan_vlcek1_dense(100), dev, blk,
                 ref=_recorded("blk_lv1d100"),
                 status=_recorded("blk_lv1d100")[0])
    nlp = modellib.luksan_vlcek1_dense(BLOCKED_N)
    out = {}
    for solver in ("dense-ldlt-blocked", "dense-ldlt"):
        kw = dict(print_level=0, linear_solver=solver)
        ipopt_torch.solve(nlp, device=dev, **kw)
        _count_reset()
        t0 = time.perf_counter()
        res = ipopt_torch.solve(nlp, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_n, k2_n = _counts()
        got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
        out[solver] = dict(status=got[0], iterations=got[1], factorizations=got[2],
                           wall_s=wall, k1_launches=k1_n, obj=float(res.obj))
        log(f"H3 {solver}: solve(luksan_vlcek1_dense({BLOCKED_N})) (KKT "
            f"{2 * BLOCKED_N - 2}): (status, iterations, factorizations) {got}, objective "
            f"{float(res.obj)!r}; warm {wall:.3f} s; K1 launches {k1_n}, K2 {k2_n}; "
            f"card {card}")
        if got[0] != 0 or k2_n:
            raise SystemExit(f"H3 {solver}: {got}, K2 {k2_n}")
    blocked = out["dense-ldlt-blocked"]
    kw = dict(print_level=0, linear_solver="dense-ldlt-blocked")
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve(nlp, device=dev, **kw))
    panels = [A for A in inputs if tuple(A.shape) == (1, 128, 128)]
    per = -(-(2 * BLOCKED_N - 2) // 128)
    if len(panels) != per * blocked["factorizations"]:
        raise SystemExit(f"H3: {len(panels)} panel inputs, want {per} x "
                         f"{blocked['factorizations']}")
    if dev.type == "cuda" and blocked["k1_launches"] != len(inputs):
        raise SystemExit(f"H3: {blocked['k1_launches']} K1 launches, {len(inputs)} "
                         f"inputs in the same solve")
    k1 = check_k1_inputs(dev, inputs, (1, 128, 128), "H3 blocked panels", card)
    del inputs
    # dense-ldlt factors the whole KKT: K1's blocked variant at b = 1998
    kkt = 2 * BLOCKED_N - 2
    kw = dict(print_level=0, linear_solver="dense-ldlt")
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve(nlp, device=dev, **kw))
    with timed("H3 K1 on dense-ldlt's inputs (1, 1998)"):
        k1_dense = check_k1_inputs(dev, inputs, (1, kkt, kkt), "H3 dense-ldlt", card)
    del inputs
    log(f"H3: blocked {blocked['wall_s']:.3f} s against dense-ldlt "
        f"{out['dense-ldlt']['wall_s']:.3f} s for the same solve; {per} K1 panel "
        f"launches per factorization; card {card}")
    return dict(out, k1=k1, k1_dense_ldlt=k1_dense, panels_per_factorization=per)


def _parametric_hs071(p):
    """HS071 with its equality's right-hand side the parameter p (the bench
    family as NLP(params=...))."""
    import torch
    import ipopt_torch
    return ipopt_torch.NLP(
        f=lambda x, q: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        g=lambda x, q: torch.stack([x[0] * x[1] * x[2] * x[3],
                                    (x * x).sum() - q]),
        x_L=1.0, x_U=5.0, g_L=[25.0, 0.0], g_U=[2e19, 0.0],
        x0=[1.0, 5.0, 5.0, 1.0], params=np.asarray(p))


def h4_phase(dev, card):
    """H4: sensitivity.  The parametric HS071 family (p_i = 40 + 0.005 i,
    B = 512): solve, sensitivity_step of every lane in one call (one K1
    launch at (512, 7, 7), bit-equal), perturbed_solution of lane i to lane
    i + 1's parameter against lane i + 1's solve; the chained 1-D boundary
    control at N = 2048: sensitivity_step in alpha and reduced_hessian on
    the two boundary controls with K2 on the BCR levels, both card against
    CPU at N = 512."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib, sens
    from ipopt_torch.profile_main import capture_k1_inputs, capture_k2_inputs
    opts = ipopt_torch.Options(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10,
                               print_level=0)
    ps = 40.0 + 0.005 * np.arange(FAMILY_B)
    nlp_b = ipopt_torch.stack_problems([_parametric_hs071(p) for p in ps], opts,
                                       device=dev)
    res = ipopt_torch.solve_batched(nlp_b, opts, device=dev)
    if int((res.status == 0).sum()) != FAMILY_B:
        raise SystemExit("H4: the parametric family did not converge")
    dp = np.full(FAMILY_B, 0.005)
    _count_reset()
    t0 = time.perf_counter()
    out = []
    inputs = capture_k1_inputs(lambda: out.append(
        sens.sensitivity_step(nlp_b, opts, res.iterate, dp, device=dev)))
    torch.cuda.synchronize()
    s_ms = (time.perf_counter() - t0) * 1e3
    k1_n, k2_n = _counts()
    sr = out[0]
    if k1_n != 1 or k2_n or len(inputs) != 1:
        raise SystemExit(f"H4: sensitivity_step launched K1 {k1_n}, K2 {k2_n} times")
    k1 = check_k1_inputs(dev, inputs, (FAMILY_B, 7, 7), "H4 sensitivity", card)
    pert = sens.perturbed_solution(nlp_b, opts, res.iterate, ps + 0.005, device=dev)
    err = float((pert.x[:-1] - res.x[1:]).abs().max())
    err0 = float((res.x[:-1] - res.x[1:]).abs().max())
    cpu_lanes = [0, FAMILY_B // 2 - 1, FAMILY_B - 2]
    sub = nlp_b.take(torch.as_tensor(cpu_lanes, device=dev)).to("cpu")
    it_sub = [v[cpu_lanes].cpu() for v in res.iterate]
    sr_cpu = sens.sensitivity_step(sub, opts, it_sub, dp[:3], device="cpu")
    d_cpu = max(float((a[cpu_lanes].cpu() - b).abs().max()) for a, b in zip(sr, sr_cpu))
    log(f"H4 parametric HS071 family, B = {FAMILY_B}: sensitivity_step of every lane "
        f"in one call {s_ms:.2f} ms (K1 inputs captured), 1 K1 launch at ({FAMILY_B}, 7, 7); "
        f"perturbed_solution to lane i + 1's parameter: max |x - x_{{i+1}}| "
        f"{err:.3e} (unperturbed {err0:.3e}); lanes {cpu_lanes} card against CPU "
        f"{d_cpu:.2e} (tol 1e-10); card {card}")
    if err > 0.1 * err0 or d_cpu > 1e-10:
        raise SystemExit("H4: the first-order update or the CPU check failed")
    # the chained 1-D boundary control
    rows = {}
    for n in (SENS_CHAIN_N, SENS_CPU_N):
        cp = modellib.mittelmann_bndry_control_1d(n, SENS_CHAIN_V)
        cn = ipopt_torch.canonicalize_chained(cp, opts, device=dev)
        r = ipopt_torch.solve(cn, opts, device=dev)
        th = torch.zeros_like(cn.params["theta"])
        th[:, 0, 0] = 1e-3
        dtheta = {"theta": th}
        idx = [0, n - 1]
        _count_reset()
        k2_in = capture_k2_inputs(lambda: rows.setdefault(n, {}).update(
            card=(sens.sensitivity_step(cn, opts, r.iterate, dtheta, device=dev),
                  sens.reduced_hessian(cn, opts, r.iterate, idx, device=dev))))
        k1_c, k2_c = _counts()
        rows[n]["k2_launches"] = k2_c
        rows[n]["status"] = int(r.status)
        if n == SENS_CPU_N:
            cpu_n = cn.to("cpu")
            it_cpu = [v.cpu() for v in r.iterate]
            s_cpu = sens.sensitivity_step(cpu_n, opts, it_cpu, {"theta": th.cpu()},
                                          device="cpu")
            h_cpu = sens.reduced_hessian(cpu_n, opts, it_cpu, idx, device="cpu")
            s_card, h_card = rows[n]["card"]
            ds = float((s_card.dx.cpu() - s_cpu.dx).abs().max()
                       / s_cpu.dx.abs().max().clamp(min=1e-300))
            dh = float((h_card.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
            log(f"H4 chained N = {n}: card against CPU, dx rel {ds:.2e}, reduced "
                f"Hessian rel {dh:.2e} (tol 1e-8)")
            if ds > 1e-8 or dh > 1e-8:
                raise SystemExit("H4 chained: card and CPU disagree")
        else:
            s_card, h_card = rows[n]["card"]
            log(f"H4 chained mittelmann_bndry_control_1d({n}, {SENS_CHAIN_V}): status "
                f"{int(r.status)}, {int(r.iter_count)} iterations; sensitivity_step "
                f"max |dx| {float(s_card.dx.abs().max()):.3e}, reduced Hessian on the "
                f"boundary controls {h_card.cpu().numpy().round(8).tolist()}; K2 "
                f"launches {k2_c} ({sorted({tuple(A.shape) for A in k2_in})}), K1 "
                f"{k1_c}; card {card}")
            if int(r.status) != 0 or k2_c == 0 or not bool(torch.isfinite(h_card).all()):
                raise SystemExit("H4 chained: no K2 launch or a bad reduced Hessian")
            # K2 on the sensitivity's factorizations (mu = 0 at the solution,
            # no prior perturbation): their root blocks are nearly singular,
            # so the forward rule alone cannot hold; MittK2Check's rule (the
            # forward rule or a backward error within 10x the plain
            # version's) holds every block
            from ipopt_torch.linalg import block_ldlt_inv as k2mod
            check = MittK2Check()
            for A in k2_in:
                check(A, *k2mod.block_ldlt_inv(A))
            k2_check = check.report("H4 chained sensitivity")
        del k2_in
    return dict(k1=k1, k1_launches=k1_n, sens_ms=s_ms, first_order_err=err,
                chained=dict(k2_launches=rows[SENS_CHAIN_N]["k2_launches"], k2=k2_check))


def h5_phase(dev, card, family):
    """H5: the hooks, card against CPU and the reference's recorded values:
    the custom KKT solver (EighKKT) on hs071; finite differences on the
    family at B = 512; derivative_test="second-order" on hs071;
    profiling.solve_timed(hs071) with its report; profiling.trace with
    K1's kernel events counted in the trace."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib, profiling
    from ipopt_torch.deriv_check import check_derivatives, report
    torch_cases = _torch_cases()
    kw = dict(print_level=0, tol=1e-8)
    rows = [ipopt_torch.solve(modellib.hs071(), device=d, custom_kkt_solver=torch_cases
                              .eigh_kkt("port"), **kw) for d in (dev, "cpu")]
    ref = _recorded("custom_hs071")
    got = [(int(r.status), int(r.iter_count), float(r.obj)) for r in rows]
    log(f"H5 custom KKT solver (eigh) on hs071: card {got[0]}, CPU {got[1]}, "
        f"reference {tuple(ref)}")
    if (got[0][:2] != got[1][:2] or got[0][:2] != tuple(ref[:2])
            or abs(got[0][2] - ref[2]) > 1e-9 * abs(ref[2])):
        raise SystemExit("H5: the custom solver's solve differs")
    fd = dict(FD, print_level=0)
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**fd), device=dev)
    _count_reset()
    t0 = time.perf_counter()
    res = ipopt_torch.solve_batched(nlp_b, device=dev, **fd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, _ = _counts()
    log(f"H5 finite differences, HS071 family B = {FAMILY_B}: "
        f"{int((res.status == 0).sum())}/{FAMILY_B} status 0, {wall:.3f} s, K1 "
        f"launches {k1_n}; card {card}")
    _lanes_vs_reference("H5 finite differences", res, lambda i: f"fam{i}_fd")
    rep = check_derivatives(ipopt_torch.canonicalize(
        modellib.hs071(), ipopt_torch.Options(derivative_test="second-order"),
        device=dev), ipopt_torch.Options(derivative_test="second-order"), device=dev)
    for line in report(rep):
        log("H5 derivative_test second-order on hs071: " + line.rstrip())
    if not rep.ok:
        raise SystemExit("H5: the derivative checker failed on hs071")
    t_res, t_rep = profiling.solve_timed(modellib.hs071(), ipopt_torch.Options(print_level=0),
                                         print_report=False, device=dev)
    t_rep.print(out=lambda line: log("H5 solve_timed: " + line))
    if int(t_res.status) != 0:
        raise SystemExit("H5: solve_timed did not converge")
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                          "h5_trace")
    with profiling.trace(logdir):
        with profiling.annotate("hs071"):
            ipopt_torch.solve(modellib.hs071(), device=dev, print_level=0)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    k1_events = [e for e in events if e.get("cat") == "kernel" and "ldlt" in e.get("name", "")]
    log(f"H5 profiling.trace: {len(events)} events, {len(k1_events)} K1 kernel events "
        f"({sorted({e['name'] for e in k1_events})[:2]}); card {card}")
    if not k1_events:
        raise SystemExit("H5: the trace holds no K1 kernel event")
    return dict(fd_k1_launches=k1_n, fd_wall_s=wall, trace_k1_events=len(k1_events),
                solve_timed_overall_s=t_rep.overall)


def slice_h_phases(dev, card, family, f64):
    """H1-H5; returns their numbers for the kernels line."""
    phase("H1 float32 factorizations on the four factored backends")
    h1 = h1_phase(dev, card, family, f64)
    phase("H2 float32 iterate, refinement_precision double")
    h2 = h2_phase(dev, card, family)
    phase("H3 dense-ldlt-blocked")
    h3 = h3_phase(dev, card)
    phase("H4 sensitivity")
    h4 = h4_phase(dev, card)
    phase("H5 the hooks")
    h5 = h5_phase(dev, card, family)
    return dict(h1=h1, h2=h2, h3=h3, h4=h4, h5=h5)


# -- slice I: the chain axis over shards, batches and scenarios over devices,
#    the AMPL reader and the C API ---------------------------------------
# I1: the chained cell over CHAIN_SHARDS shards on the one card
CHAIN_SHARDS = 8
# I2, I3: device groups on the one card
I_GROUPS = 4
# I4: a read of the generated .nl above this many seconds cuts n to NL_CUT_N
NL_READ_LIMIT_S, NL_CUT_N = 60.0, 10_000


def bcr_k2_launches(nb):
    """K2 launches of one BCR factorization of nb blocks: one per level
    (the chain halves, an odd chain padded) and the root."""
    n = 1
    while nb > 1:
        nb = (nb + 1) // 2
        n += 1
    return n


def _k2_level_times(first, card, path):
    """K2 on the first input of each shape in ``first`` (one BCR's levels):
    CUDA events per wrapper call beside its bound, the plain version and
    torch.linalg.inv_ex (pivoted, the inverse only: a yardstick)."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    rows = {}
    for A in first:
        nb, b = A.shape[0], A.shape[-1]
        if f"{nb}x{b}" in rows:
            continue
        ms = time_cuda(lambda: k2.block_ldlt_inv(A), reps=20, warmup=2)
        plain_ms = time_cuda(lambda: k2.block_ldlt_inv_plain(A), reps=2, warmup=1)
        inv_ms = time_cuda(lambda: torch.linalg.inv_ex(A), reps=20, warmup=2)
        bound_ms, bound_by, nbytes, ops = k2_bound(nb, b)
        rows[f"{nb}x{b}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=inv_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
        log(f"K2 on the {path} path, ({nb}, {b}, {b}) float64: {ms:.4f} ms per call "
            f"(CUDA events), plain {plain_ms:.4f} ms, torch.linalg.inv_ex {inv_ms:.4f} "
            f"ms, bound {bound_ms:.6f} ms ({bound_by}), {ms / bound_ms:.1f}x; card {card}")
    return rows


def gj_pivots_extended(A):
    """The unpivoted Gauss-Jordan pivots of one block (numpy (b, b)) in
    extended precision (numpy longdouble), with the same guard."""
    X = A.astype(np.longdouble)
    tiny = np.finfo(np.float64).tiny
    d = np.empty(X.shape[0], dtype=np.longdouble)
    for k in range(X.shape[0]):
        p = X[k, k]
        d[k] = p
        sp = p if abs(p) > tiny else (np.longdouble(tiny) if p >= 0 else -np.longdouble(tiny))
        col, row = X[:, k].copy(), X[k, :].copy()
        X = X - np.outer(col, row) / sp
        X[k, :] = -row / sp
        X[:, k] = col / sp
        X[k, k] = 1 / sp
    return d


def i1_pivot_diagnosis(inputs, per, card):
    """Why K2's pivots on I1's sharded chain miss the chained path's rule (d
    to PATH_TOL_D relative): on every input of one sharded solve, by its
    launch within the factorization (the interiors' levels, then the reduced
    system's), the blocks without a guarded pivot whose d differs from the
    plain version's by more than PATH_TOL_D; and for each, how far the
    plain version itself moves between equally valid orders and inputs: the
    sweep of A^T (MittK2Check's second order), the same sweep on the CPU
    (another summation order of its panel products), and the sweep of A
    with every entry scaled by 1 +- eps (a seeded symmetric relative
    perturbation of one ulp: the block's conditioning); and how far the
    kernel and the plain version each lie from the same sweep in extended
    precision.  Where the plain version moves d by as much, or is itself as
    far from the extended sweep, the cause is the block, not the kernel.
    Printed, not held: I1 holds K2 by MittK2Check's rule."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    tiny = torch.finfo(torch.float64).tiny
    eps = torch.finfo(torch.float64).eps
    rng = np.random.default_rng(11)
    by_level = {}
    rows = []
    for n, A in enumerate(inputs):
        lev = n % per
        d_k, _ = k2.block_ldlt_inv(A)
        d_p, _ = k2.block_ldlt_inv_plain(A)
        guarded = (~(d_p.abs() > tiny)).any(-1)
        rel = ((d_k - d_p).abs() / d_p.abs()).nan_to_num(0.0, 0.0, 0.0).amax(-1)
        miss = (rel > PATH_TOL_D) & ~guarded & torch.isfinite(A).all(-1).all(-1)
        lv = by_level.setdefault(lev, dict(shape=list(A.shape), inputs=0, blocks=0,
                                           guarded=0, missing=0, worst_rel_d=0.0))
        lv["inputs"] += 1
        lv["blocks"] += A.shape[0]
        lv["guarded"] += int(guarded.sum())
        lv["missing"] += int(miss.sum())
        lv["worst_rel_d"] = max(lv["worst_rel_d"], float(rel[~guarded].max())
                                if bool((~guarded).any()) else 0.0)
        for j in torch.nonzero(miss).flatten().tolist():
            Aj = A[j:j + 1]
            ref = d_p[j:j + 1]

            def moved(d):
                return float(((d - ref).abs() / ref.abs()).nan_to_num(0.0, 0.0, 0.0).max())
            d_t, _ = k2.block_ldlt_inv_plain(Aj.transpose(1, 2).contiguous())
            d_c, _ = k2.block_ldlt_inv_plain(Aj.cpu())
            E = torch.as_tensor(rng.choice([-1.0, 1.0], size=Aj.shape), device=Aj.device)
            E = torch.triu(E) + torch.triu(E, 1).transpose(1, 2)
            d_e, _ = k2.block_ldlt_inv_plain(Aj * (1 + eps * E))
            # both against the sweep in extended precision (numpy longdouble)
            d_x = gj_pivots_extended(Aj[0].cpu().numpy())

            def off(d):
                d = d[0].cpu().numpy().astype(np.longdouble)
                return float(np.max(np.abs(d - d_x) / np.abs(d_x)))
            rows.append(dict(launch=lev, input=n, block=j, rel_d_kernel=float(rel[j]),
                             rel_d_transposed=moved(d_t), rel_d_cpu=moved(d_c.to(ref.device)),
                             rel_d_one_ulp=moved(d_e),
                             kernel_from_extended=off(d_k[j:j + 1]),
                             plain_from_extended=off(ref),
                             max_abs_pivot=float(ref.abs().max()),
                             min_abs_pivot=float(ref.abs().min())))
    for lev, lv in sorted(by_level.items()):
        log(f"I1 K2 pivots, launch {lev + 1} of {per} per factorization {tuple(lv['shape'])}: "
            f"{lv['inputs']} inputs, {lv['blocks']} blocks ({lv['guarded']} with a guarded "
            f"pivot); {lv['missing']} blocks without one whose d misses {PATH_TOL_D:g} "
            f"relative; worst rel d {lv['worst_rel_d']:.3e}")
    for r in rows[:20]:
        log(f"I1 K2 pivots: launch {r['launch'] + 1}, input {r['input']}, block "
            f"{r['block']}: kernel rel d {r['rel_d_kernel']:.3e}; the plain version "
            f"itself on A^T {r['rel_d_transposed']:.3e}, on the CPU {r['rel_d_cpu']:.3e}, "
            f"on A moved by one ulp {r['rel_d_one_ulp']:.3e}; against the sweep in "
            f"extended precision: kernel {r['kernel_from_extended']:.3e}, plain "
            f"{r['plain_from_extended']:.3e}; |d| from {r['min_abs_pivot']:.3e} to "
            f"{r['max_abs_pivot']:.3e}")
    spread = [max(r["rel_d_transposed"], r["rel_d_cpu"], r["rel_d_one_ulp"],
                  r["plain_from_extended"]) for r in rows]
    # "as much": the plain version's own spread, or its own error, within 10x
    # of the kernel's difference
    conditioning = sum(sp >= r["rel_d_kernel"] / 10 for sp, r in zip(spread, rows))
    verdict = ("no block misses the rule" if not rows else
               f"{conditioning} of {len(rows)} missing blocks move by at least a tenth as "
               f"much under the plain version's own orders or a one-ulp perturbation, "
               f"or the plain version is itself that far from the extended-precision "
               f"sweep")
    log(f"I1 K2 pivots: {len(rows)} blocks miss d to {PATH_TOL_D:g}; worst kernel rel d "
        f"{max((r['rel_d_kernel'] for r in rows), default=0.0):.3e}, worst plain spread "
        f"{max(spread, default=0.0):.3e}; {verdict}; card {card}")
    return dict(levels={str(k + 1): v for k, v in sorted(by_level.items())},
                missing_blocks=len(rows), conditioning_blocks=conditioning,
                worst_rel_d_kernel=max((r["rel_d_kernel"] for r in rows), default=0.0),
                worst_plain_spread=max(spread, default=0.0), blocks=rows[:20])


def i1_phase(dev, opts, card):
    """I1: luksan_vlcek1(4096, 32) with chain_shard=True over CHAIN_SHARDS
    shards on the card (lanes of one batched BCR): the reference's (0, 7,
    21) and the unsharded solve's status and iterations, objective to 1e-9;
    ms per iteration beside the unsharded solve; K2 launches per
    factorization (the interiors' BCR and the reduced system's); every K2
    input of one more sharded solve held by MittK2Check's rule, stacked by
    shape; K2 timed on the first interior and reduced levels."""
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.parallel.chain_shard import set_chain_mesh
    from ipopt_torch.profile_main import capture_k2_inputs
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(LV1_N, LV1_V),
                                            ipopt_torch.Options(**opts), device=dev)
    nb = cnlp.chain.K + 1
    k = nb // CHAIN_SHARDS
    base, base_wall, _, _, base_k2, _ = _timed_solves(cnlp, dev, opts)
    kw = dict(opts, chain_shard=True)
    set_chain_mesh([dev] * CHAIN_SHARDS)
    try:
        res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, kw)
        inputs = capture_k2_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **kw))
    finally:
        set_chain_mesh(None)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    obj, base_obj = float(res.obj), float(base.obj)
    per = bcr_k2_launches(k - 2) + bcr_k2_launches(2 * CHAIN_SHARDS)
    ms_it, base_ms_it = (w / max(got[1], 1) * 1e3 for w in (wall, base_wall))
    log(f"I1 chain_shard: solve(luksan_vlcek1({LV1_N}, {LV1_V})) over {CHAIN_SHARDS} "
        f"shards of {k} blocks on {dev}: (status, iterations, factorizations) {got}, "
        f"objective {obj!r} (unsharded {base_obj!r}, reference {LV1_OBJ!r}); warm "
        f"{wall:.3f} s, {ms_it:.1f} ms/iteration against {base_ms_it:.1f} unsharded "
        f"({base_wall:.3f} s), cold {cold_s:.3f} s, peak {peak:.3f} GiB; K2 launches "
        f"{k2_n} ({k2_n / max(got[2], 1):g} per factorization: the interiors' "
        f"{bcr_k2_launches(k - 2)} and the reduced system's "
        f"{bcr_k2_launches(2 * CHAIN_SHARDS)}; unsharded {base_k2}), K1 {k1_n}; "
        f"card {card}")
    checks = [
        (got == (LV1_STATUS, LV1_ITERS, LV1_FACTORIZATIONS), f"{got} != the reference's"),
        ((int(base.status), int(base.iter_count)) == got[:2], "unsharded solve differs"),
        (abs(obj - base_obj) <= 1e-9 * abs(base_obj), "objective off the unsharded"),
        (abs(obj - LV1_OBJ) <= 1e-9 * abs(LV1_OBJ), "objective off the reference"),
        (k2_n == per * got[2], f"K2 launches {k2_n} != {per} x {got[2]}"),
        (len(inputs) == per * got[2], f"captured {len(inputs)} K2 inputs")]
    for ok, msg in checks:
        if not ok:
            raise SystemExit(f"I1: {msg}")
    # every input by MittK2Check's rule, stacked by shape (the blocks a
    # rejected trial leaves non-finite by their finite pattern)
    from ipopt_torch.linalg import block_ldlt_inv as k2
    check = MittK2Check()
    for A in inputs:
        check(A, *k2.block_ldlt_inv(A))
    rows = check.report("I1 chain_shard")
    with timed("I1 pivot diagnosis"):
        diagnosis = i1_pivot_diagnosis(inputs, per, card)
    levels = _k2_level_times(inputs[:per], card, "I1 chain_shard")
    del inputs
    return dict(shards=CHAIN_SHARDS, blocks_per_shard=k, status=got[0],
                iterations=got[1], factorizations=got[2], obj=obj, wall_s=wall,
                ms_per_iteration=ms_it, unsharded_ms_per_iteration=base_ms_it,
                peak_gib=peak, k2_launches=k2_n, k2_per_factorization=per,
                k2_check=rows, k2_pivot_diagnosis=diagnosis, k2_levels=levels)


def i2_phase(dev, opts, card, nlp_b, one):
    """I2: the HS071 family (B = 512) with ``devices=[dev] * I_GROUPS``: every
    lane's status, iterations and x equal to the one-device solve ``one``;
    K1 launches = the batched factorizations."""
    import torch
    import ipopt_torch
    ipopt_torch.solve_batched(nlp_b, devices=[dev] * I_GROUPS, **opts)
    _count_reset()
    t0 = time.perf_counter()
    res = ipopt_torch.solve_batched(nlp_b, devices=[dev] * I_GROUPS, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = _counts()
    dx = float((res.x - one.x).abs().max())
    same = (torch.equal(res.status, one.status) and torch.equal(res.iter_count,
                                                                 one.iter_count))
    log(f"I2 solve_batched(devices=[{dev}] x {I_GROUPS}), B = {FAMILY_B}: status and "
        f"iterations equal to the one-device solve in every lane: {same}; max |dx| "
        f"{dx:.3e} (bit-equal {torch.equal(res.x, one.x)}); warm {wall:.3f} s "
        f"({FAMILY_B / wall:.1f} NLPs/s); K1 launches {k1_n}, batched factorizations "
        f"{res.batched_factorizations}, K2 {k2_n}; card {card}")
    if not same or dx > 1e-12 or k2_n or k1_n != res.batched_factorizations or not k1_n:
        raise SystemExit("I2: the device groups differ from the one-device solve")
    return dict(groups=I_GROUPS, wall_s=wall, max_dx=dx, bit_equal=torch.equal(res.x, one.x),
                k1_launches=k1_n, batched_factorizations=res.batched_factorizations)


def i3_phase(dev, opts, card, f1):
    """I3: stochastic_qp(8192, 30) with its scenarios in I_GROUPS device
    groups: F1's status and iterations, objective to 1e-9 of F1's; K1 once
    per group and once for the Schur root per factorization, bit-equal to
    its plain version on every input."""
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.profile_main import capture_k1_inputs
    S, ns = SQP_F1
    cnlp = ipopt_torch.canonicalize_scenario(modellib.stochastic_qp(S, ns),
                                             ipopt_torch.Options(**opts), device=dev,
                                             devices=[dev] * I_GROUPS)
    res, wall, cold_s, k1_n, k2_n, peak = _timed_solves(cnlp, dev, opts)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    obj = float(res.obj)
    rel = abs(obj - f1["obj"]) / abs(f1["obj"])
    log(f"I3 scenario groups: stochastic_qp({S}, {ns}) in {I_GROUPS} groups of "
        f"{S // I_GROUPS} on {dev}: (status, iterations, factorizations) {got}, "
        f"objective {obj!r} (F1 {f1['obj']!r}, rel diff {rel:.2e}); warm {wall:.3f} s "
        f"({wall / max(got[1], 1) * 1e3:.1f} ms/iteration, F1 "
        f"{f1['ms_per_iteration']:.1f}); K1 launches {k1_n} "
        f"({k1_n / max(got[2], 1):g} per factorization), K2 {k2_n}; card {card}")
    if (got[:2] != (f1["status"], f1["iterations"]) or rel > 1e-9 or k2_n
            or k1_n != (I_GROUPS + 1) * got[2]):
        raise SystemExit("I3: the scenario groups differ from F1's solve")
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve(cnlp, device=dev, **opts))
    bs = cnlp.chain.bs
    k1 = check_k1_inputs(dev, inputs, (S // I_GROUPS, bs, bs), "I3 scenario groups",
                         card)
    del inputs
    return dict(groups=I_GROUPS, status=got[0], iterations=got[1], factorizations=got[2],
                obj=obj, rel_to_f1=rel, wall_s=wall, k1_launches=k1_n, k1=k1)


def _fixture(name):
    """A string constant of tests/test_ampl.py, read with ast (the module
    itself imports the JAX package)."""
    import ast
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "test_ampl.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise SystemExit(f"I4: no {name} in tests/test_ampl.py")


def i4_phase(dev, opts, card, banded):
    """I4: the hs071 .nl fixture through the CLI (``ampl.main``) on the card,
    its .sol read back; LuksanVlcek1 written as ASCII .nl at n = LVF_N by
    ``ampl.write_luksan_vlcek1_nl``, transcoded to binary, read (seconds
    printed; above NL_READ_LIMIT_S the phase runs at NL_CUT_N) and solved
    with banded-bcr: the Python-built model's status and iterations,
    objective to 1e-9."""
    import torch
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.interfaces import ampl
    from ipopt_torch.sparse import canonicalize_sparse
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "ipopt_torch", "_build", "nl")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "hs071.nl")
    with open(path, "w") as fh:
        fh.write(_fixture("HS071_NL"))
    _count_reset()
    # the CLI's default device is the card
    rc = ampl.main([path, "-AMPL", "print_level=0"]
                   + ([] if dev.type == "cuda" else [f"device={dev.type}"]))
    k1_cli, _ = _counts()
    model = ampl.read_nl_model(path)
    x, y, status, suf = ampl.read_sol(path[:-3] + ".sol")
    f_sol = float(model.nlp.f(torch.as_tensor(x, dtype=torch.float64)))
    log(f"I4 AMPL CLI on hs071.nl ({dev}): rc {rc}, .sol status {status}, f(x_sol) "
        f"{f_sol!r} (|df| {abs(f_sol - F_STAR):.2e}), suffixes {sorted(suf)}; K1 "
        f"launches {k1_cli}")
    if rc != 0 or status != 0 or abs(f_sol - F_STAR) > 1e-7 or not k1_cli:
        raise SystemExit("I4: the CLI's hs071 solve failed")

    n = LVF_N
    out = dict(cli_k1_launches=k1_cli, cli_f=f_sol)
    while True:
        src = os.path.join(work, f"lv1_{n}.nl")
        t0 = time.perf_counter()
        ampl.write_luksan_vlcek1_nl(src, n)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ampl.ascii_nl_to_binary(src, src + ".bin")
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = ampl.read_nl_model(src + ".bin")
        read_s = time.perf_counter() - t0
        log(f"I4 LuksanVlcek1 .nl at n = {n}: written in {write_s:.2f} s (ASCII, "
            f"{os.path.getsize(src)} B), transcoded in {bin_s:.2f} s "
            f"({os.path.getsize(src + '.bin')} B), read (binary, tape compiled) in "
            f"{read_s:.2f} s: {m.f_tape.n_groups} + {m.g_tape.n_groups} tape groups")
        if read_s <= NL_READ_LIMIT_S or n == NL_CUT_N:
            break
        log(f"I4: reading took over {NL_READ_LIMIT_S:g} s: cut to n = {NL_CUT_N}")
        n = NL_CUT_N
    kw = dict(opts, **BANDED)
    t0 = time.perf_counter()
    cnlp = canonicalize_sparse(m.nlp, ipopt_torch.Options(**kw), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res, wall, cold_s, k1_n, k2_n, _ = _timed_solves(cnlp, dev, kw)
    got = (int(res.status), int(res.iter_count), int(res.counters.n_factorizations))
    if n == LVF_N:
        want = (banded["status"], banded["iterations"], banded["factorizations"])
        want_obj = banded["obj"]
    else:
        py = ipopt_torch.solve(modellib.luksan_vlcek1_flat(n), device=dev, **kw)
        want = (int(py.status), int(py.iter_count), int(py.counters.n_factorizations))
        want_obj = float(py.obj)
    obj = float(res.obj)
    log(f"I4 .nl LuksanVlcek1 n = {n}, banded-bcr: (status, iterations, "
        f"factorizations) {got}, objective {obj!r}; Python-built {want}, "
        f"{want_obj!r} (|d| {abs(obj - want_obj):.2e}); set-up {setup_s:.3f} s, warm "
        f"{wall:.3f} s, cold {cold_s:.3f} s; K2 launches {k2_n}, K1 {k1_n}; card {card}")
    if got[:2] != want[:2] or abs(obj - want_obj) > 1e-9 * abs(want_obj) or k1_n \
            or not k2_n:
        raise SystemExit("I4: the .nl model's banded solve differs from the "
                         "Python-built one")
    out.update(n=n, write_s=write_s, transcode_s=bin_s, read_s=read_s, setup_s=setup_s,
               status=got[0], iterations=got[1], factorizations=got[2], obj=obj,
               wall_s=wall, k2_launches=k2_n)
    return out


def i5_phase(dev, card):
    """I5: the port's C library built by ``ipopt_torch.native.build`` (gcc,
    sysconfig's paths), the reference's unchanged ``native/examples/
    hs071_c.c`` linked against it, run with IPOPT_TORCH_C_DEVICE=cuda."""
    from ipopt_torch.native import build as native_build
    t0 = time.perf_counter()
    out = native_build.build()
    build_s = time.perf_counter() - t0
    env = dict(os.environ, IPOPT_TORCH_C_DEVICE=dev.type)
    t0 = time.perf_counter()
    proc = subprocess.run([out["hs071_c"]], env=env, capture_output=True, text=True,
                          timeout=600)
    run_s = time.perf_counter() - t0
    log(f"I5 C library: built in {build_s:.1f} s ({os.path.basename(out['lib'])}, "
        f"hs071_c); hs071_c with IPOPT_TORCH_C_DEVICE={dev.type}: rc {proc.returncode} "
        f"in {run_s:.1f} s: {proc.stdout.strip()[-300:]!r}")
    if proc.returncode != 0 or "EXIT: Optimal Solution Found." not in proc.stdout:
        raise SystemExit(f"I5: hs071_c failed: {proc.stderr[-2000:]}")
    return dict(build_s=build_s, run_s=run_s)


def slice_i_phases(dev, opts, card, nlp_b, one, f1, banded):
    """I1-I5; returns their numbers for the kernels line."""
    phase("I1 the chain axis over shards")
    i1 = i1_phase(dev, opts, card)
    phase("I2 the HS071 family over device groups")
    i2 = i2_phase(dev, opts, card, nlp_b, one)
    phase("I3 the scenario groups")
    i3 = i3_phase(dev, opts, card, f1)
    phase("I4 AMPL")
    i4 = i4_phase(dev, opts, card, banded)
    phase("I5 the C library")
    i5 = i5_phase(dev, card)
    return dict(i1=i1, i2=i2, i3=i3, i4=i4, i5=i5)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    import ipopt_torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg import block_ldlt_inv as k2mod
    from ipopt_torch.linalg import cuda_lib
    from ipopt_torch.linalg import ldlt as ldlt_mod
    from ipopt_torch import modellib
    t0 = time.perf_counter()
    libs = cuda_lib.build()
    here = os.path.dirname(os.path.abspath(__file__))
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        + ", ".join(os.path.relpath(p, here) for p in libs.values()))
    for name in libs:
        with open(os.path.join(cuda_lib.build_dir(), f"{name}.log")) as fh:
            for line in fh.read().splitlines():
                if "registers" in line or "smem" in line or "Compiling" in line:
                    log("  ptxas: " + line.strip())
    # K2's float64 panel products must run on the FP64 tensor cores (DMMA)
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs["block_ldlt_inv"]], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {op: sum(f" {op}" in line for line in sass.splitlines())
              for op in ("DMMA", "HMMA", "DFMA")}
    log("K2 SASS (cuobjdump -sass): " + ", ".join(f"{n} {op}" for op, n in counts.items()))
    if counts["DMMA"] == 0:
        raise SystemExit("K2 has no DMMA instruction")

    opts = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)
    family = [modellib.hs071_family(0.005 * i) for i in range(FAMILY_B)]
    t0 = time.perf_counter()
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**opts),
                                       device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # 3. kernels against their plain versions
    phase("K1 and K2 against their plain versions")
    k1_stats = check_k1(dev, card)
    k2_stats = check_k2(dev)

    # 4. the main path: canonicalize + stack on the host (set-up), then solve
    phase("HS071 family (main path)")
    t0 = time.perf_counter()
    cold = ipopt_torch.solve_batched(nlp_b, device=dev, **opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bl.block_ldlt.launches = 0
    k2mod.block_ldlt_inv.launches = 0
    calls0 = ldlt_mod.ldlt.calls
    t0 = time.perf_counter()
    res = ipopt_torch.solve_batched(nlp_b, device=dev, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bl.block_ldlt.launches
    if k2mod.block_ldlt_inv.launches:
        raise SystemExit("main path: the dense path launched K2")
    status = res.status.cpu().numpy()
    iters = res.iter_count.cpu().numpy()
    n_ok = int((status == 0).sum())
    obj0 = float(res.obj[0])
    log(f"main path: solve_batched B={FAMILY_B} float64: {n_ok}/{FAMILY_B} status 0, "
        f"median iterations {statistics.median(iters.tolist())}, "
        f"warm solve {wall:.3f} s ({FAMILY_B / wall:.1f} NLPs/s), cold solve "
        f"{cold_s:.3f} s, set-up (canonicalize + stack) {setup_s:.3f} s, "
        f"obj[0] {obj0!r}; K1 launches {launches}, batched factorizations "
        f"{res.batched_factorizations} (ldlt calls {ldlt_mod.ldlt.calls - calls0}); "
        f"card {card}")
    if n_ok != FAMILY_B:
        raise SystemExit(f"main path: only {n_ok}/{FAMILY_B} converged")
    if abs(obj0 - F_STAR) > 1e-7:
        raise SystemExit(f"main path: obj[0] {obj0} != {F_STAR}")
    if not (launches > 0 and launches == res.batched_factorizations):
        raise SystemExit(f"main path: K1 launches {launches} != batched "
                         f"factorizations {res.batched_factorizations}")
    if not bool((cold.iter_count == res.iter_count).all()):
        raise SystemExit("main path: cold and warm solves differ")
    ref = ipopt_torch.solve_batched(family[:8], device="cpu", **opts)
    if ref.iter_count.tolist() != iters[:8].tolist():
        raise SystemExit(f"main path: iteration counts {iters[:8].tolist()} differ "
                         f"from the CPU solve {ref.iter_count.tolist()}")
    log(f"main path: first 8 iteration counts {iters[:8].tolist()} equal the CPU solve")
    from ipopt_torch.profile_main import capture_k1_inputs
    k1_inputs = capture_k1_inputs(
        lambda: ipopt_torch.solve_batched(nlp_b, device=dev, **opts))
    k1_stats.update(check_k1_on_path(dev, k1_inputs, card))
    del k1_inputs
    # E1: the same family with the adaptive strategy and with Mehrotra's mode
    e1 = {mode: adaptive_family_path(dev, opts, card, nlp_b, family, mode)
          for mode in MODES}
    log(f"E1 against the monotone main path: {wall / int(iters.max()) * 1e3:.1f} ms "
        f"per outer iteration monotone, "
        + ", ".join(f"{m} {v['ms_per_iteration']:.1f}" for m, v in e1.items())
        + f"; card {card}")

    # 5. one solve on the card
    phase("solve(hs071), the dense LuksanVlcek1")
    r1 = ipopt_torch.solve(modellib.hs071(), device=dev, print_level=0)
    log(f"solve(hs071): status {int(r1.status)}, {int(r1.iter_count)} iterations, "
        f"f* {float(r1.obj)!r}")
    if int(r1.status) != 0 or int(r1.iter_count) != 8 or abs(float(r1.obj) - F_STAR) > 1e-7:
        raise SystemExit("solve(hs071) on the card failed")

    # 6. a dense KKT above the old one-CTA limit of K1
    dense_path(dev, opts, card)

    # 7. the chained path, and at 496-wide blocks
    phase("chained path")
    k2_chained_launches, k2_inputs, chained_ms = chained_path(dev, opts, card)
    k2_chained = check_k2_on_path(dev, k2_inputs, LV1_K2_PER_FACTORIZATION,
                                  "chained", card)
    del k2_inputs
    paths = {"chained_lv1_4096_32": k2_chained_launches,
             "chained_lv1_1000_100": wide_chained_path(dev, opts, card)}
    e2_launches, e2_k2, e2 = chained_adaptive_path(dev, opts, card)
    paths["e2_chained_lv1_4096_32_adaptive"] = e2_launches

    # 8. the chained restoration at 204- and 504-wide blocks
    phase("chained restoration, E3")
    for v in HARD_CHAIN_VS:
        paths[f"hard_chain_{v}"] = restoration_path(dev, card, v)

    # E3: a warm start on the chained backend
    e3_launches, e3_k2, e3 = warm_start_path(dev, opts, card)
    paths["e3_mittelmann_bndry_10_cold_warm_cold"] = e3_launches

    # 9. the banded path, Mittelmann, E4, the banded restoration
    phase("banded path")
    k2_launches, k2_inputs, banded = banded_path(dev, opts, card)
    k2_banded = check_k2_on_path(dev, k2_inputs, LVF_K2_PER_FACTORIZATION, "banded",
                                 card)
    del k2_inputs
    paths["banded_lv1_flat_1e5"] = k2_launches
    phase("Mittelmann")
    mitt = mittelmann_path(dev, opts, card)
    phase("E4 and the banded restoration")
    paths["mittelmann_100"] = mitt["k2_launches"]
    e4 = {}
    for name, n in BANDED_E4:
        e4_launches, e4_k2, e4[name] = banded_adaptive_path(dev, opts, card, name, n)
        e4[name]["k2"] = e4_k2
        paths[f"e4_banded_{name}_1e5_adaptive"] = e4_launches
    banded_restoration_path(dev, card)

    # F1-F4: the arrow backend and limited-memory Hessians
    exact_ms = dict(dense=wall / int(iters.max()) * 1e3, chained=chained_ms,
                    banded=banded["wall_s"] / max(banded["iterations"], 1) * 1e3,
                    banded_peak_gib=banded["peak_gib"])
    f = slice_f_phases(dev, opts, card, nlp_b, family, exact_ms)
    for tag in ("f1", "f2"):
        paths_k1 = f"{tag}_arrow_sqp_{f[tag]['S']}_{f[tag]['ns']}"
        f.setdefault("k1_launches_per_path", {})[paths_k1] = f[tag]["k1_launches"]
    g = slice_g_phases(dev, opts, card)
    f["k1_launches_per_path"].update(
        g1_multifrontal_3d_24=g["g1"]["k1_launches"],
        f3_arrow_restoration_1024=f["f3"][1024]["k1_launches"],
        f4_lbfgs_dense_hs071_512=f["f4"]["dense_hs071_512"]["k1_launches"],
        f4_lbfgs_arrow_sqp_8192_30=f["f4"]["arrow_sqp_8192_30"]["k1_launches"])
    paths.update(f4_lbfgs_chained_lv1_4096_32=f["f4"]["chained_lv1_4096_32"]["k2_launches"],
                 f4_lbfgs_banded_lv1_flat_1e5=f["f4"]["banded_lv1_flat_1e5"]["k2_launches"],
                 g4_cg_penalty_chained_lv1_4096_32=(
                     g["g4"]["cg_penalty_chained"]["k2_launches"]))
    # H1-H5: float32 factorizations, the blocked LDL^T, sensitivity, hooks
    h = slice_h_phases(dev, card, family, dict(
        k1_hs071_ms=k1_stats["ms"], k2_chained_level_ms=k2_chained["level_ms"],
        k2_banded_level_ms=k2_banded["level_ms"], k1_nd_levels=g["g1"]["k1"]["levels"]))
    f["k1_launches_per_path"].update(
        h1_dense_hs071_512_float32=h["h1"]["dense"]["k1_launches"],
        h1_multifrontal_3d_24_float32=h["h1"]["multifrontal"]["k1_launches"],
        h2_dense_hs071_512_float32_iterate=h["h2"]["dense"]["k1_launches"],
        h3_blocked_lv1_dense_1000=h["h3"]["dense-ldlt-blocked"]["k1_launches"],
        h3_dense_ldlt_lv1_dense_1000=h["h3"]["dense-ldlt"]["k1_launches"],
        h4_sensitivity_hs071_512=h["h4"]["k1_launches"],
        h5_finite_differences_hs071_512=h["h5"]["fd_k1_launches"])
    paths.update(h1_chained_lv1_4096_32_float32=h["h1"]["chained"]["launches"],
                 h1_banded_lv1_flat_1e5_float32=h["h1"]["banded"]["launches"],
                 h2_chained_lv1_4096_32_float32_iterate=h["h2"]["chained"]["k2_launches"],
                 h4_sensitivity_mittelmann_1d_2048=h["h4"]["chained"]["k2_launches"])
    # I1-I5: the chain axis over shards, device groups, AMPL, the C library
    i = slice_i_phases(dev, opts, card, nlp_b, res, f["f1"], banded)
    f["k1_launches_per_path"].update(
        i2_hs071_512_4_device_groups=i["i2"]["k1_launches"],
        i3_arrow_sqp_8192_30_4_device_groups=i["i3"]["k1_launches"],
        i4_ampl_cli_hs071=i["i4"]["cli_k1_launches"])
    paths.update(i1_chain_shard_lv1_4096_32_8_shards=i["i1"]["k2_launches"],
                 i4_ampl_lv1_flat_nl=i["i4"]["k2_launches"])

    log("seconds of PR-11's checks and timings: " + json.dumps(
        {k: round(v, 1) for k, v in CHECK_SECONDS.items()}))
    # 10. kernels line, 11. result line
    phase("kernels line")
    k2_entry = dict(k2_banded)
    k2_entry.update(
        banded=banded, chained=dict(k2_chained, launches=k2_chained_launches),
        mittelmann=mitt, launches_per_path=paths,
        slice_e=dict(e2=dict(e2, k2=e2_k2), e3=dict(e3, k2=e3_k2), e4=e4),
        seeded_ms=k2_stats["seeded_ms"], seeded_max_abs_err=k2_stats["seeded_max_abs_err"],
        device_memory_variant=k2_stats["device_memory_variant"],
        banded_stacks=k2_stats["banded_stacks"],
        slice_g=dict(cg_penalty_chained=g["g4"]["cg_penalty_chained"]),
        slice_h=dict(h1_chained_float32=h["h1"]["chained"],
                     h1_banded_float32=h["h1"]["banded"], h2_chained=h["h2"]["chained"],
                     h4_sensitivity_chained=h["h4"]["chained"]),
        slice_i=dict(i1_chain_shard=i["i1"], i4_ampl=i["i4"]))
    k1_entry = dict(k1_stats)
    k1_entry["library_ms"] = k1_entry.pop("ldl_factor_ms")
    k1_entry["launches_per_path"] = {"hs071_512": launches, **{
        f"e1_hs071_512_{m}": v["k1_launches"] for m, v in e1.items()},
        **f.pop("k1_launches_per_path")}
    k1_entry["slice_e"] = e1
    k1_entry["slice_f"] = f
    k1_entry["slice_g"] = dict(multifrontal=g["g1"], wide_fronts=g["g2"])
    k1_entry["slice_h"] = dict(h1_dense_float32=h["h1"]["dense"],
                               h1_multifrontal_float32=h["h1"]["multifrontal"],
                               h2_dense=h["h2"]["dense"], h3_blocked=h["h3"],
                               h4_sensitivity=dict(k1=h["h4"]["k1"],
                                                   sens_ms=h["h4"]["sens_ms"]),
                               h5=h["h5"])
    k1_entry["slice_i"] = dict(i2_device_groups=i["i2"], i3_scenario_groups=i["i3"],
                               i5_c_library=i["i5"])
    # the variants each wrapper launched over the whole script
    k1_entry["variants_launched"] = dict(bl.block_ldlt.by_variant)
    k2_entry["variants_launched"] = dict(k2mod.block_ldlt_inv.by_variant)
    print(json.dumps({"kernels": [{
        "name": "block_ldlt", "route": "cuda",
        "source": "ipopt_torch/csrc/block_ldlt.cu",
        "replaces": "ipopt_tpu/linalg/pallas_ldlt.py:26",
        "launches": launches, **k1_entry}, {
        "name": "block_ldlt_inv", "route": "cuda",
        "source": "ipopt_torch/csrc/block_ldlt_inv.cu",
        "replaces": "ipopt_tpu/linalg/pallas_ldlt.py:86",
        "launches": k2_launches, **k2_entry}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
