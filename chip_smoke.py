"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure exits non-zero before the result line):
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from the sources in this checkout (one nvcc
   per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it: K1 at (512, 7, 7) and other block sizes, K2 at every
   BCR level of the chained path, (64|32|...|1, 156, 156) float64, and at
   other block sizes and in float32;
4. the HS071 path: ``solve_batched`` on the 512-instance HS071 family in
   float64, with every kernel's launch count set to 0 just before and read
   just after;
5. a single ``solve(hs071)`` on the card;
6. the chained path: ``solve(luksan_vlcek1(4096, 32))`` in float64 (128
   blocks of 156, block cyclic reduction), cold then warm, the launch counts
   set to 0 before the warm solve and read after it, held against the
   reference's float64 values; and ``luksan_vlcek1(256, 32)`` on the card
   against the same solve on the CPU;
7. one JSON line ``{"kernels": [...]}`` with each kernel's launches, error,
   time, the plain version's time and the least time the card could take;
8. the last line: ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the ``ipopt_torch`` package next to it; without
either it fails.  It imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the peak rate of each
# type (float64 on the tensor cores; float32 outside them), and the float64
# rate outside the tensor cores, which a scalar sweep is held to.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}
FP64_VECTOR_OPS_PER_S = 34e12
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


def log(msg):
    print(msg, flush=True)


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


def check_k1(dev):
    """K1 against block_ldlt_plain on the card; returns (max abs error at the
    main-path shape, kernel ms, plain ms, bound ms, bound_by)."""
    import torch
    from ipopt_torch.linalg import block_ldlt as bl
    from ipopt_torch.linalg.ldlt import _pivot_tols
    rng = np.random.default_rng(0)
    cases = [(FAMILY_B, 7, torch.float64), (FAMILY_B, 7, torch.float32)]
    cases += [(64, b, torch.float64) for b in (1, 16, 32, 64, 156)]
    main_err = None
    for nb, b, dtype in cases:
        A = kkt_like_blocks(rng, nb, b, dtype).to(dev)
        L_k, d_k = bl.block_ldlt(A)
        torch.cuda.synchronize()
        L_p, d_p = bl.block_ldlt_plain(A)
        torch.cuda.synchronize()
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        err = max(float((L_k - L_p).abs().max()), float((d_k - d_p).abs().max()))
        scale = max(float(L_p.abs().max()), float(d_p.abs().max()), 1e-300)
        rel = err / scale
        zero_tol = _pivot_tols(d_p.abs().amax(-1), dtype, 0.0)[:, None]
        live = d_p.abs() > zero_tol
        signs_ok = bool(((torch.sign(d_k) == torch.sign(d_p)) | ~live).all())
        finite = bool(torch.isfinite(L_k).all() and torch.isfinite(d_k).all())
        ok = rel <= tol and signs_ok and finite
        log(f"K1 check nb={nb} b={b} {str(dtype)[6:]}: max_abs_err={err:.3e} "
            f"rel={rel:.3e} (tol {tol:g}) signs_equal={signs_ok} "
            f"tiny_pivots={int((~live).sum())} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at "
                             f"nb={nb} b={b} {dtype}")
        if (nb, b, dtype) == (FAMILY_B, 7, torch.float64):
            main_err = err
            A_main = A
    ms = time_cuda(lambda: bl.block_ldlt(A_main))
    plain_ms = time_cuda(lambda: bl.block_ldlt_plain(A_main), reps=50)
    nb, b = FAMILY_B, 7
    nbytes = 8 * (nb * b * b + nb * b * b + nb * b)  # A read, L and d written
    ops = nb * sum(3 * j * j + j for j in range(b))  # mul/div/sub + L divides
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["float64"] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    log(f"K1 timing (512, 7, 7) float64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops)")
    return main_err, ms, plain_ms, bound_ms, bound_by


def gj_flops(nb, b):
    """Least floating-point work of nb block inverses with their pivots:
    b^3 multiply-adds (2 b^3 flops) per block."""
    return 2 * nb * b ** 3


def gj_sweep_ops(nb, b):
    """Scalar operations of the unfused Gauss-Jordan sweep that K2 runs: per
    step, mul/div/sub off row and column k, neg/div on row k, div on column
    k, and 1/p."""
    return nb * b * (3 * (b - 1) ** 2 + 3 * (b - 1) + 1)


def check_k2(dev):
    """K2 against block_ldlt_inv_plain on the card; returns a dict of the
    error at the main-path shapes and the timings."""
    import torch
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.linalg.ldlt import _pivot_tols
    rng = np.random.default_rng(1)
    b_main = 156
    main = [(ne, b_main, torch.float64) for ne in (64, 32, 16, 8, 4, 2, 1)]
    cases = main + [(16, b, torch.float64) for b in (1, 8, 16, 32, 33)]
    cases += [(64, b_main, torch.float32)]
    main_err = 0.0
    for nb, b, dtype in cases:
        A = kkt_like_blocks(rng, nb, b, dtype).to(dev)
        d_k, inv_k = k2.block_ldlt_inv(A)
        torch.cuda.synchronize()
        d_p, inv_p = k2.block_ldlt_inv_plain(A)
        torch.cuda.synchronize()
        err_inv = float((inv_k - inv_p).abs().max())
        err_d = float((d_k - d_p).abs().max())
        live = d_p.abs() > _pivot_tols(d_p.abs().amax(-1), dtype, 0.0)[:, None]
        signs_ok = bool(((torch.sign(d_k) == torch.sign(d_p)) | ~live).all())
        nonsingular = live.all(-1)
        A64, inv64 = A[nonsingular].double(), inv_k[nonsingular].double()
        resid = float((A64 @ inv64 - torch.eye(b, dtype=torch.float64, device=dev))
                      .abs().max()) if bool(nonsingular.any()) else 0.0
        finite = bool(torch.isfinite(inv_k).all() and torch.isfinite(d_k).all())
        ok = err_inv == 0.0 and err_d == 0.0 and signs_ok and finite
        log(f"K2 check nb={nb} b={b} {str(dtype)[6:]}: max_abs_err Ainv={err_inv:.3e} "
            f"d={err_d:.3e} (tol 0: the same IEEE operations) signs_equal={signs_ok} "
            f"tiny_pivots={int((~live).sum())} max|A Ainv - I| on "
            f"{int(nonsingular.sum())} nonsingular blocks={resid:.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version at "
                             f"nb={nb} b={b} {dtype}")
        if (nb, b, dtype) in main:
            main_err = max(main_err, err_inv, err_d)
    # times on nonsingular blocks (torch.linalg.inv refuses a singular one)
    A = kkt_like_blocks(rng, 64, b_main, torch.float64, tiny_block=False).to(dev)
    level_ms = [time_cuda(lambda Ab=A[:ne].contiguous(): k2.block_ldlt_inv(Ab),
                          reps=20, warmup=3)
                for ne in (64, 32, 16, 8, 4, 2, 1, 1)]
    ms = level_ms[0]
    plain_ms = time_cuda(lambda: k2.block_ldlt_inv_plain(A), reps=5, warmup=1)
    inv_ms = time_cuda(lambda: torch.linalg.inv(A), reps=50)
    nbytes = 8 * (2 * 64 * b_main * b_main + 64 * b_main)  # A read, Ainv and d written
    ops = gj_flops(64, b_main)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["float64"] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    sweep_ops = gj_sweep_ops(64, b_main)
    sweep_bound_ms = max(t_bytes, sweep_ops / FP64_VECTOR_OPS_PER_S * 1e3)
    log(f"K2 timing (64, 156, 156) float64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} flops), "
        f"bound of the unfused scalar sweep {sweep_bound_ms:.6f} ms ({sweep_ops} ops "
        f"outside the tensor cores), "
        f"torch.linalg.inv (inverse only, pivoted) {inv_ms:.4f} ms")
    log("K2 per launch of one factorization (ne = 64, 32, 16, 8, 4, 2, 1, root): "
        + ", ".join(f"{t:.4f}" for t in level_ms) + " ms")
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, sweep_bound_ms=sweep_bound_ms, inv_ms=inv_ms,
                level_ms=level_ms)


def chained_path(dev, opts, card):
    """The chained path at full width on the card, held against the
    reference; returns the K2 launches of the warm solve."""
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
    return k2_launches


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

    # 3. kernels against their plain versions
    main_err, k_ms, plain_ms, bound_ms, bound_by = check_k1(dev)
    k2_stats = check_k2(dev)

    # 4. the main path: canonicalize + stack on the host (set-up), then solve
    opts = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)
    family = [modellib.hs071_family(0.005 * i) for i in range(FAMILY_B)]
    t0 = time.perf_counter()
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**opts),
                                       device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
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

    # 5. one solve on the card
    r1 = ipopt_torch.solve(modellib.hs071(), device=dev, print_level=0)
    log(f"solve(hs071): status {int(r1.status)}, {int(r1.iter_count)} iterations, "
        f"f* {float(r1.obj)!r}")
    if int(r1.status) != 0 or int(r1.iter_count) != 8 or abs(float(r1.obj) - F_STAR) > 1e-7:
        raise SystemExit("solve(hs071) on the card failed")

    # 6. the chained path
    k2_launches = chained_path(dev, opts, card)

    # 7. kernels line, 8. result line
    print(json.dumps({"kernels": [{
        "name": "block_ldlt", "route": "cuda",
        "source": "ipopt_torch/csrc/block_ldlt.cu",
        "replaces": "ipopt_tpu/linalg/pallas_ldlt.py:26",
        "launches": launches, "max_abs_err": main_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "block_ldlt_inv", "route": "cuda",
        "source": "ipopt_torch/csrc/block_ldlt_inv.cu",
        "replaces": "ipopt_tpu/linalg/pallas_ldlt.py:86",
        "launches": k2_launches, **k2_stats, "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
