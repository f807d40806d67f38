"""K2: batched unpivoted Gauss-Jordan inverse -> pivots + explicit inverse.

Replaces the TPU kernel ``ipopt_tpu/linalg/pallas_ldlt.py::_gj_inv_kernel``
(wrapper ``pallas_block_ldlt_inv``, ``pallas_ldlt.py:131-152``), with the
algorithm the reference's BCR levels run, ``_gj_inv_auto``
(``block_tridiag.py:366-370``): the scalar sweep ``_gj_inv_lanes`` for
b <= 32, the panel-32 sweep ``_gj_inv_lanes_blocked`` (``:299-349``) above.
The unpivoted Gauss-Jordan pivot at step k equals the k-th LDL^T pivot, so
one sweep gives the inverse and the inertia.  Every BCR level and the root
factor their eliminated blocks with one launch: on the chained path
(64, 156, 156) float64 first, then 32, 16, ..., 1 blocks and the root, eight
launches per factorization; on the banded path of LuksanVlcek1 at n = 1e5
(6250, 16, 16) first, fifteen launches per factorization.

- ``block_ldlt_inv_plain(A)``: the plain PyTorch version (scalar loop over k
  on the whole (nb, b, b) tensor for b <= 32; panels of 32 with
  ``torch.matmul`` products above).  The CPU path and the tests use it.
- ``block_ldlt_inv(A)``: the wrapper, A (nb, b, b) -> (d (nb, b),
  Ainv (nb, b, b)); the reference pads d to (nb, 8, b) for TPU tiles, the
  port does not.  A CPU tensor goes to the plain version; a CUDA tensor goes
  to the hand-written kernel ``csrc/block_ldlt_inv.cu`` or raises.  There is
  no fallback from the kernel to the plain version.
  ``block_ldlt_inv.launches`` counts the kernel launches.
- ``plan(nb, b, dtype)``: the kernel's launch plan.  Up to b = 32 the warp
  variant: the scalar sweep in registers, one lane per row, 32 //
  next_pow2(b) blocks per warp, the warps spread over the SMs before a CTA
  takes more than one.  Up to ``CLUSTER_MAX_B[dtype]`` (416 in float64, 576
  in float32) the cluster variant: one thread-block cluster of ``cs`` CTAs per block, each CTA
  holding a strip of whole panels of rows in shared memory.  Above, the
  device-memory variant: the block stays in the output buffer and each panel
  step is three launches over all the blocks (the sweep of the panel, the
  panel's row and column products, the rank-32 update), so every b runs on
  the card.

What bounds the kernel on an H100: at (64, 156, 156) float64 the function
needs b^3 multiply-adds per block (486 M flops per launch, 7.3 us at the
67 TFLOP/s of the FP64 tensor cores) against 25 MB moved (7.5 us at
3.35 TB/s): bytes, barely; at (6250, 16, 16) bytes (26.4 MB, 7.9 us); at
(20, 1288, 1288) operations (85.5 GFLOP, 1.28 ms).  See the source note in
``csrc/block_ldlt_inv.cu`` for the design.  No PyTorch call computes this function:
``torch.linalg.inv`` pivots and gives no pivot sequence, and
``torch.linalg.ldl_factor`` pivots (Bunch-Kaufman).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import cuda_lib
from .block_ldlt import _safe_pivot

# Panel width of the blocked sweep; at or below it one scalar sweep.
PANEL = 32
# The kernel's clusters stay within the portable size, so no launch needs
# cudaFuncAttributeNonPortableClusterSizeAllowed.
MAX_CLUSTER = 8
# The plan widens clusters while the launch fits the SMs.
NUM_SMS = cuda_lib.NUM_SMS

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
# the device-memory variant: A, Ainv, d, the scratch R, nb, b, device, stream
_GLOBAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the warp variant: A, Ainv, d, nb, b, lanes, grid, threads, smem, device, stream
_WARP_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class Plan(NamedTuple):
    cs: int                 # CTAs per cluster, one cluster per block
    rows: Tuple[int, ...]   # rows of the block each CTA holds, in order
    smem: int               # dynamic shared bytes per CTA
    variant: str = "cluster"  # "warp" (b <= 32), or "global": the block in device memory
    lanes: int = 0          # warp variant: lanes per block, next_pow2(b)
    grid: int = 0           # warp variant: CTAs
    threads: int = 0        # warp variant: threads per CTA


def _strip_panels(n_panels: int, cs: int):
    """Panels of rows per CTA: as even as possible, the larger first."""
    base, extra = divmod(n_panels, cs)
    return [base + (c < extra) for c in range(cs)]


def _smem(b: int, cs: int, esize: int) -> int:
    """Shared bytes per CTA: a strip of whole 32-row panels with a padded
    row stride (round_up(b, 32) + 4 elements: whole panels of columns, and
    conflict-free fragment loads), plus the panel inverse and its sweep
    buffer (2 x 32 x 32)."""
    n_panels = -(-b // PANEL)
    ld = n_panels * PANEL + 4
    strip_rows = max(_strip_panels(n_panels, cs)) * PANEL
    return (strip_rows * ld + 2 * PANEL * PANEL) * esize


def plan(nb: int, b: int, dtype) -> Plan:
    """The launch plan of ``nb`` blocks of width ``b``.  Warp variant up to
    b = 32: lanes = next_pow2(b) lanes per block, 32 // lanes blocks per
    warp, packed by ``cuda_lib.warp_pack``.  Cluster variant:
    the smallest cluster whose strips fit one CTA's shared memory, widened
    while the launch fits the card's SMs (nb * cs <= 132), a CTA still holds
    a panel and the cluster stays portable (<= 8), to the smallest cluster
    whose strips are the shortest those bounds allow.  Above
    ``CLUSTER_MAX_B`` the device-memory variant (``rows`` the whole block,
    ``smem`` the panel sweep's two 32 x 32 tiles)."""
    esize = torch.finfo(dtype).bits // 8
    n_panels = -(-b // PANEL)
    if b <= PANEL:
        lanes = 1 << (b - 1).bit_length()
        grid, threads, smem = cuda_lib.warp_pack(nb, 32 // lanes, b * b * esize)
        return Plan(cs=1, rows=(b,), smem=smem, variant="warp", lanes=lanes,
                    grid=grid, threads=threads)
    if b > CLUSTER_MAX_B[dtype]:
        return Plan(cs=1, rows=(b,), smem=2 * PANEL * PANEL * esize, variant="global")
    cs = 1
    while _smem(b, cs, esize) > cuda_lib.SMEM_BYTES:
        cs += 1
    widest = max(cs, min(MAX_CLUSTER, n_panels, NUM_SMS // max(nb, 1)))
    shortest = -(-n_panels // widest)
    while -(-n_panels // cs) > shortest:
        cs += 1
    rows = [PANEL * p for p in _strip_panels(n_panels, cs)]
    rows[-1] -= n_panels * PANEL - b
    return Plan(cs=cs, rows=tuple(rows), smem=_smem(b, cs, esize))


def _max_block(esize: int) -> int:
    """The largest b of the cluster variant: whole panels, each CTA of the
    widest portable cluster holding its strip (the shared bytes grow with
    the panel count)."""
    n = 1
    while _smem(PANEL * (n + 1), min(MAX_CLUSTER, n + 1), esize) <= cuda_lib.SMEM_BYTES:
        n += 1
    return PANEL * n


# Largest b of the cluster variant per dtype: 416 in float64, 576 in float32.
CLUSTER_MAX_B = {dt: _max_block(torch.finfo(dt).bits // 8)
                 for dt in (torch.float32, torch.float64)}


def _gj_sweep(A: torch.Tensor):
    """Scalar Gauss-Jordan sweep: A (nb, b, b) -> (d (nb, b), Ainv).  Step
    for step the arithmetic of ``_gj_inv_kernel`` and ``_gj_inv_lanes``;
    every update reads the previous step's X."""
    nb, b, _ = A.shape
    X = A.clone()
    d = A.new_empty((nb, b))
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for k in range(b):
        p = X[:, k, k].clone()
        d[:, k] = p
        sp = _safe_pivot(p)[:, None]
        col = X[:, :, k].clone()
        row = X[:, k, :].clone()
        Xn = X - (col[:, :, None] * row[:, None, :]) / sp[:, :, None]
        Xn[:, k, :] = -row / sp
        Xn[:, :, k] = col / sp
        Xn[:, k, k] = one / sp[:, 0]
        X = Xn
    return d, X


def block_ldlt_inv_plain(A: torch.Tensor):
    """Plain PyTorch ``_gj_inv_auto``: A (nb, b, b) -> (d (nb, b),
    Ainv (nb, b, b)).  For b <= 32 the scalar sweep; above, panels P of 32
    (the last may be ragged), each: Pinv = the sweep of X_PP, CP = X_oP Pinv,
    X_oo -= CP X_Po, X_oP = CP, X_Po = -Pinv X_Po, X_PP = Pinv."""
    nb, b, _ = A.shape
    if b <= PANEL:
        return _gj_sweep(A)
    X = A.clone()
    d = A.new_empty((nb, b))
    for p0 in range(0, b, PANEL):
        P = slice(p0, min(p0 + PANEL, b))
        d[:, P], Pinv = _gj_sweep(X[:, P, P])
        C, R = X[:, :, P], X[:, P, :]
        CP = torch.matmul(C, Pinv)
        Xn = X - torch.matmul(CP, R)
        Xn[:, :, P] = CP
        Xn[:, P, :] = -torch.matmul(Pinv, R)
        Xn[:, P, P] = Pinv
        X = Xn
    return d, X


def _library():
    return cuda_lib.load("block_ldlt_inv", {"block_ldlt_inv_f32": _ARGTYPES,
                                            "block_ldlt_inv_f64": _ARGTYPES,
                                            "block_ldlt_inv_global_f32": _GLOBAL_ARGTYPES,
                                            "block_ldlt_inv_global_f64": _GLOBAL_ARGTYPES,
                                            "block_ldlt_inv_warp_f32": _WARP_ARGTYPES,
                                            "block_ldlt_inv_warp_f64": _WARP_ARGTYPES})


def block_ldlt_inv(A: torch.Tensor):
    """Batched pivots + inverse: A (nb, b, b) -> (d (nb, b), Ainv (nb, b, b)).

    CPU tensors take the plain version; CUDA tensors launch the kernel (the
    variant ``plan`` names) or raise; the device-memory variant raises only
    when its tensors do not fit the card's memory."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"block_ldlt_inv expects (nb, b, b), got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_ldlt_inv: unsupported dtype {A.dtype}")
    if A.device.type == "cpu":
        return block_ldlt_inv_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"block_ldlt_inv: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("block_ldlt_inv: A must be contiguous")
    nb, b, _ = A.shape
    Ainv = torch.empty_like(A)
    d = torch.empty((nb, b), dtype=A.dtype, device=A.device)
    if nb == 0 or b == 0:
        return d, Ainv
    pl = plan(nb, b, A.dtype)
    lib = _library()
    f64 = A.dtype == torch.float64
    dev = A.device.index if A.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if pl.variant == "warp":
        fn = lib.block_ldlt_inv_warp_f64 if f64 else lib.block_ldlt_inv_warp_f32
        err = fn(A.data_ptr(), Ainv.data_ptr(), d.data_ptr(), nb, b, pl.lanes, pl.grid,
                 pl.threads, pl.smem, dev, stream)
    elif pl.variant == "global":
        R = torch.empty((nb, PANEL, b), dtype=A.dtype, device=A.device)
        fn = lib.block_ldlt_inv_global_f64 if f64 else lib.block_ldlt_inv_global_f32
        err = fn(A.data_ptr(), Ainv.data_ptr(), d.data_ptr(), R.data_ptr(), nb, b,
                 dev, stream)
    else:
        fn = lib.block_ldlt_inv_f64 if f64 else lib.block_ldlt_inv_f32
        err = fn(A.data_ptr(), Ainv.data_ptr(), d.data_ptr(), nb, b, pl.cs, pl.smem,
                 dev, stream)
    if err != 0:
        raise RuntimeError(f"block_ldlt_inv kernel launch failed: CUDA error {err}")
    block_ldlt_inv.launches += 1
    block_ldlt_inv.by_variant[pl.variant] = block_ldlt_inv.by_variant.get(pl.variant, 0) + 1
    return d, Ainv


block_ldlt_inv.launches = 0
block_ldlt_inv.by_variant = {}  # launches per variant of plan
