"""K1: batched unpivoted LDL^T of many symmetric blocks.

Replaces the TPU kernel ``ipopt_tpu/linalg/pallas_ldlt.py::_ldlt_block_kernel``
(wrapper ``pallas_block_ldlt``, ``pallas_ldlt.py:55-76``).  On the main path it
factors the augmented KKT matrix of every instance of a batch in one launch:
(512, 7, 7) float64 for the HS071 family, once per inertia-correction trial.

- ``block_ldlt_plain(A)``: the plain PyTorch version, the same loop over k on
  the whole (nb, b, b) tensor.  The CPU path and the tests use it.
- ``block_ldlt(A)``: the wrapper.  A CPU tensor goes to the plain version; a
  CUDA tensor goes to the hand-written kernel ``csrc/block_ldlt.cu`` (built
  with nvcc for sm_90a at first use, loaded with ctypes) or raises.  There is
  no fallback from the kernel to the plain version.  ``block_ldlt.launches``
  counts the wrapper's launches (one per call, whatever the variant's CUDA
  launches), ``block_ldlt.by_variant`` the same per variant.

What bounds the kernel on an H100: at (512, 7, 7) float64 it moves
2 * 512 * 49 * 8 B + 512 * 7 * 8 B = 430 KB (0.13 us at 3.35 TB/s), and each
block is a chain of b dependent steps, so that chain's latency bounds it; at
(1, 1726), the multifrontal backend's top front, ~b^3 / 3 multiply-adds
(0.026 ms on the FP64 tensor cores).  ``plan(nb, b, dtype)`` picks one of
three variants (source note in ``csrc/block_ldlt.cu``): b <= 32 packs blocks
into warps (each row in the registers of two lanes, one reciprocal per
pivot, certified quotients, and an exact pass with the library division for
a warp whose quotients were not all vouched for); larger blocks take one CTA
each with the lower triangle in shared memory, and the rest (wider blocks,
and from b = 64 up when there are at most 32 blocks) the blocked variant:
panels of 32 over many CTAs per block, the float64 trailing update on the
FP64 tensor cores, so every b runs on the card.  The warp and CTA
variants, and the blocked one in float32, equal the plain version bit for
bit (NaN in the same places); the blocked one in float64 sums the trailing
update in another order.  No PyTorch call computes an unpivoted LDL^T
(``torch.linalg.ldl_factor`` pivots, ``cholesky`` needs a definite matrix).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]
# the blocked variant: A, L, d, the scratch W, nb, b, device, stream
_BLOCKED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# Largest b of the warp variant.
WARP_MAX_B = 32
_VARIANTS = {"warp": 0, "cta": 1}
# The blocked variant: panel width, threads of its kernels, rows of a
# panel's strip per CTA, the trailing update's output tile, and the row
# stride of that tile's operands in shared memory.
PANEL = 32
BLOCKED_THREADS = 256
STRIP = 16
UPDATE_TILE = 64
_UPDATE_LD = PANEL + 4
_INIT_GRID = 1024


class Plan(NamedTuple):
    variant: str   # "warp", "cta" or "blocked"
    rows: int      # warp variant: b padded to a power of two (at least 2);
                   # blocked: rows of a panel's strip per CTA
    lanes: int     # warp variant: lanes per block, two per row up to 16 rows
    grid: int      # CTAs (blocked: of its largest launch)
    threads: int   # threads per CTA
    smem: int      # shared bytes per CTA (dynamic; the blocked variant's are static)
    kernels: int = 1  # CUDA launches per call


def variant_plan(variant: str, nb: int, b: int, dtype) -> Plan:
    """The launch of ``variant`` for nb blocks of width b.

    - warp (b <= 32): two lanes per row up to 16 rows (one above), its
      warps spread over the SMs before a CTA takes more than one;
    - cta: one CTA per block, the packed lower triangle in shared memory
      (b(b+1)/2 elements must fit);
    - blocked: an init over every element, then per panel of 32 a strip
      launch (nb x ceil(rows below / STRIP) CTAs) and, but for the last, the
      trailing update (nb x the 64 x 64 tiles on or below the trailing
      matrix's diagonal); ``grid`` is the largest launch's."""
    esize = torch.finfo(dtype).bits // 8
    if variant == "warp" and b <= WARP_MAX_B:
        rows = max(2, 1 << (b - 1).bit_length())
        lanes = min(32, 2 * rows)
        grid, threads, smem = cuda_lib.warp_pack(nb, 32 // lanes, b * b * esize)
        return Plan("warp", rows, lanes, grid, threads, smem)
    tri = b * (b + 1) // 2 * esize
    if variant == "cta" and tri <= cuda_lib.SMEM_BYTES:
        return Plan("cta", 0, 0, nb, 256 if b <= 96 else 512, tri)
    if variant == "blocked":
        n_panels = -(-b // PANEL)
        below = b - min(PANEL, b)
        strips = max(1, -(-below // STRIP))
        nt = -(-below // UPDATE_TILE)
        init = min(_INIT_GRID, -(-nb * b * b // BLOCKED_THREADS))
        grid = max(init, nb * strips, nb * nt * (nt + 1) // 2)
        # the update's operand tiles and the panel's pivots (static)
        smem = 2 * UPDATE_TILE * _UPDATE_LD * esize + PANEL * (2 * esize + 2)
        return Plan("blocked", STRIP, 0, grid, BLOCKED_THREADS, smem, 2 * n_panels)
    raise ValueError(f"K1 has no {variant} launch for b = {b} in {dtype}")


# The CTA variant factors each block on one SM, one step at a time; the
# blocked variant spreads a block over many SMs but pays two launches per
# panel of 32.  Measured side by side on the same seeded stacks (ms per call,
# CTA against blocked, float64 / float32; chip_smoke.py check_k1, NVIDIA
# H100 80GB HBM3 at 700 W): (1, 40) 0.050 / 0.070 and 0.050 / 0.075;
# (1, 64) 0.115 / 0.086 and 0.111 / 0.104; (1, 198) 0.818 / 0.299 and
# 0.755 / 0.417; (30, 240) 1.260 / 0.523 and 1.166 / 0.632; (16, 156)
# 0.479 / 0.230 and 0.453 / 0.310; (104, 161) 0.516 / 0.605 and 0.489 /
# 0.691; (156, 82) 0.216 / 0.246; (300, 64) 0.161 / 0.214; (1024, 128)
# 1.852 / 2.599 and 1.651 / 2.370.  So the blocked variant takes b >= 64 at
# nb <= 32, and every b whose triangle does not fit shared memory.
BLOCKED_MIN_B = 64
BLOCKED_MAX_NB = 32


def plan(nb: int, b: int, dtype) -> Plan:
    """K1's launch for nb blocks of width b (plain Python, so the CPU tests
    check it): the warp variant up to b = 32; the blocked variant from
    b = BLOCKED_MIN_B at nb <= BLOCKED_MAX_NB (the times above), and
    wherever the packed lower triangle does not fit shared memory (b > 240
    in float64, 340 in float32); the CTA variant otherwise."""
    if b <= WARP_MAX_B:
        return variant_plan("warp", nb, b, dtype)
    fits = b * (b + 1) // 2 * (torch.finfo(dtype).bits // 8) <= cuda_lib.SMEM_BYTES
    if fits and not (b >= BLOCKED_MIN_B and nb <= BLOCKED_MAX_NB):
        return variant_plan("cta", nb, b, dtype)
    return variant_plan("blocked", nb, b, dtype)


def _safe_pivot(d):
    tiny = torch.full_like(d, torch.finfo(d.dtype).tiny)
    return torch.where(d.abs() > tiny, d, torch.where(d >= 0, tiny, -tiny))


def block_ldlt_plain(A: torch.Tensor):
    """Plain PyTorch unpivoted LDL^T: A (nb, b, b) -> (L (nb, b, b) unit
    lower, d (nb, b)).  Step for step the arithmetic of
    ``ipopt_tpu/linalg/ldlt.py:105-138`` and of the Pallas kernel."""
    nb, b, _ = A.shape
    M = A.clone()
    idx = torch.arange(b, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for k in range(b):
        safe = _safe_pivot(M[:, k, k])
        below = idx > k
        a = torch.where(below, M[:, :, k], zero)
        M = M - (a[:, :, None] * a[:, None, :]) / safe[:, None, None]
        M[:, :, k] = torch.where(below, a / safe[:, None], M[:, :, k])
    d = M.diagonal(dim1=1, dim2=2).clone()
    L = torch.tril(M, -1) + torch.eye(b, dtype=A.dtype, device=A.device)
    return L, d


# The rule the blocked variant is held to in float64 against the plain
# version (the warp and CTA variants, and the blocked one in float32, equal
# it bit for bit).  Its float64 trailing update sums on the FP64 tensor cores
# in another order than the rank-1 loop, so bit-equality cannot hold.  Per
# input: the same finite pattern of L and d; per block, the same (pos, neg,
# zero) pivot counts by ``block_tridiag._block_inertia_counts`` at the
# solve's pivot_tol (0 unless the caller says otherwise); and, on the blocks
# whose input and outputs are finite, a backward error
# ||A - L D L^T||_F / || |L| |D| |L^T| ||_F (in float64) at most
# K1_BACKWARD_FACTOR times the plain version's own plus b u (u the unit
# roundoff of the input's type).  Stated before the variant's first run on
# the card; not to be widened.
K1_BACKWARD_FACTOR = 4.0


def k1_backward_error(A, L, d):
    """||A - L D L^T||_F / || |L| |D| |L^T| ||_F per block, in float64."""
    A, L, d = A.double(), L.double(), d.double()
    LD = L * d[:, None, :]
    num = torch.linalg.matrix_norm(A - LD @ L.transpose(1, 2))
    den = torch.linalg.matrix_norm(LD.abs() @ L.abs().transpose(1, 2))
    return num / den.clamp(min=1e-300)


def k1_rule(A, L_k, d_k, L_p, d_p, pivot_tol=0.0):
    """The rule above on one input, the kernel's (L_k, d_k) against the
    plain version's (L_p, d_p): (ok, why, worst ratio of the kernel's
    backward error to its limit)."""
    from .block_tridiag import _block_inertia_counts
    pattern = (torch.equal(torch.isfinite(L_k), torch.isfinite(L_p))
               and torch.equal(torch.isfinite(d_k), torch.isfinite(d_p)))
    counts_k = torch.stack(_block_inertia_counts(d_k[:, None], pivot_tol))
    counts_p = torch.stack(_block_inertia_counts(d_p[:, None], pivot_tol))
    inertia = torch.equal(counts_k, counts_p)
    fin = (torch.isfinite(A).all(-1).all(-1) & torch.isfinite(L_k).all(-1).all(-1)
           & torch.isfinite(L_p).all(-1).all(-1) & torch.isfinite(d_k).all(-1)
           & torch.isfinite(d_p).all(-1))
    worst = 0.0
    backward = True
    if bool(fin.any()):
        b = A.shape[-1]
        u = torch.finfo(A.dtype).eps / 2
        be_k = k1_backward_error(A[fin], L_k[fin], d_k[fin])
        be_p = k1_backward_error(A[fin], L_p[fin], d_p[fin])
        limit = K1_BACKWARD_FACTOR * be_p + b * u
        worst = float((be_k / limit).max())
        backward = worst <= 1.0
    why = (f"finite pattern equal {pattern}, inertia equal per block {inertia}, "
           f"backward error / limit {worst:.3e} on {int(fin.sum())} finite blocks")
    return pattern and inertia and backward, why, worst


def _library():
    return cuda_lib.load("block_ldlt", {"block_ldlt_f32": _ARGTYPES,
                                        "block_ldlt_f64": _ARGTYPES,
                                        "block_ldlt_blocked_f32": _BLOCKED_ARGTYPES,
                                        "block_ldlt_blocked_f64": _BLOCKED_ARGTYPES})


def block_ldlt(A: torch.Tensor):
    """Batched LDL^T: A (nb, b, b) -> (L (nb, b, b) unit lower, d (nb, b)).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"block_ldlt expects (nb, b, b), got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return block_ldlt_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"block_ldlt: unsupported device {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_ldlt: unsupported dtype {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("block_ldlt: A must be contiguous")
    nb, b, _ = A.shape
    if nb >= 2 ** 31:
        raise ValueError(f"block_ldlt: {nb} blocks exceed one launch's grid")
    pl = plan(nb, b, A.dtype)
    out = launch(A, pl)
    block_ldlt.launches += 1
    block_ldlt.by_variant[pl.variant] = block_ldlt.by_variant.get(pl.variant, 0) + 1
    return out


def launch(A: torch.Tensor, pl: Plan):
    """Run K1 on the CUDA tensor A (contiguous (nb, b, b), float32 or
    float64) with the launch plan ``pl``; ``block_ldlt`` gives it
    ``plan``'s, ``chip_smoke.py`` also the other variants', to time them."""
    nb, b, _ = A.shape
    L = torch.empty_like(A)
    d = torch.empty((nb, b), dtype=A.dtype, device=A.device)
    if nb == 0 or b == 0:
        return L, d
    lib = _library()
    f64 = A.dtype == torch.float64
    device = A.device.index if A.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if pl.variant == "blocked":
        W = torch.empty((nb, b, PANEL), dtype=A.dtype, device=A.device)
        fn = lib.block_ldlt_blocked_f64 if f64 else lib.block_ldlt_blocked_f32
        err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), W.data_ptr(), nb, b, device,
                 stream)
    else:
        fn = lib.block_ldlt_f64 if f64 else lib.block_ldlt_f32
        err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), nb, b, _VARIANTS[pl.variant],
                 pl.rows, pl.lanes, pl.grid, pl.threads, pl.smem, device, stream)
    if err != 0:
        raise RuntimeError(f"block_ldlt kernel launch failed: CUDA error {err}")
    return L, d


block_ldlt.launches = 0
block_ldlt.by_variant = {}  # launches per variant of plan
