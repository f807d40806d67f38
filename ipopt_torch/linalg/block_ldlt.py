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
  counts the kernel launches.

What bounds the kernel on an H100: at (512, 7, 7) float64 it moves
2 * 512 * 49 * 8 B + 512 * 7 * 8 B = 430 KB (0.13 us at 3.35 TB/s), and each
block is a chain of b dependent steps, so that chain's latency bounds it.
``plan(nb, b, dtype)`` picks one of three variants (source note in
``csrc/block_ldlt.cu``): b <= 32 packs blocks into warps (each row in the
registers of two lanes, one reciprocal per pivot, certified quotients, and an
exact pass with the library division for a warp whose quotients were not
all vouched for); larger blocks take one CTA each with the lower triangle in
shared memory while b(b+1)/2 elements fit (b <= 240 in float64, 340 in
float32), and in device memory above that, so every b runs on the card.  The
kernel equals the plain version bit for bit (NaN in the same places).  No PyTorch call computes an unpivoted LDL^T
(``torch.linalg.ldl_factor`` pivots, ``cholesky`` needs a definite matrix).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]
# Largest b of the warp variant, and its CTAs' most warps (it spreads its
# warps over the SMs first).
WARP_MAX_B = 32
MAX_WARPS_PER_CTA = 4
_VARIANTS = {"warp": 0, "cta": 1, "global": 2}


class Plan(NamedTuple):
    variant: str   # "warp", "cta" or "global"
    rows: int      # warp variant: b padded to a power of two (at least 2)
    lanes: int     # warp variant: lanes per block, two per row up to 16 rows
    grid: int      # CTAs
    threads: int   # threads per CTA
    smem: int      # dynamic shared bytes per CTA


def plan(nb: int, b: int, dtype) -> Plan:
    """K1's launch for nb blocks of width b (plain Python, so the CPU tests
    check it): the warp variant up to b = 32 (two lanes per row up to 16
    rows, one above), its warps spread over the SMs before a CTA takes more
    than one; one CTA per block above, with the packed lower triangle in
    shared memory while it fits and in device memory otherwise."""
    esize = torch.finfo(dtype).bits // 8
    if b <= WARP_MAX_B:
        rows = max(2, 1 << (b - 1).bit_length())
        lanes = min(32, 2 * rows)
        per_warp = 32 // lanes
        warps = -(-nb // per_warp)
        per_cta = min(MAX_WARPS_PER_CTA, -(-warps // cuda_lib.NUM_SMS))
        return Plan("warp", rows, lanes, -(-warps // per_cta), 32 * per_cta,
                    per_cta * per_warp * b * b * esize)
    tri = b * (b + 1) // 2 * esize
    if tri <= cuda_lib.SMEM_BYTES:
        return Plan("cta", 0, 0, nb, 256 if b <= 96 else 512, tri)
    return Plan("global", 0, 0, nb, 1024, 0)


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


def _library():
    return cuda_lib.load("block_ldlt", {"block_ldlt_f32": _ARGTYPES,
                                        "block_ldlt_f64": _ARGTYPES})


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
    L = torch.empty_like(A)
    d = torch.empty((nb, b), dtype=A.dtype, device=A.device)
    if nb == 0 or b == 0:
        return L, d
    fn = (_library().block_ldlt_f64 if A.dtype == torch.float64
          else _library().block_ldlt_f32)
    if nb >= 2 ** 31:
        raise ValueError(f"block_ldlt: {nb} blocks exceed one launch's grid")
    pl = plan(nb, b, A.dtype)
    device = A.device.index if A.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), nb, b, _VARIANTS[pl.variant],
             pl.rows, pl.lanes, pl.grid, pl.threads, pl.smem, device, stream)
    if err != 0:
        raise RuntimeError(f"block_ldlt kernel launch failed: CUDA error {err}")
    block_ldlt.launches += 1
    return L, d


block_ldlt.launches = 0
