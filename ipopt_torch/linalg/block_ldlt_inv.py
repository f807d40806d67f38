"""K2: batched unpivoted Gauss-Jordan sweep -> pivots + explicit inverse.

Replaces the TPU kernel ``ipopt_tpu/linalg/pallas_ldlt.py::_gj_inv_kernel``
(wrapper ``pallas_block_ldlt_inv``, ``pallas_ldlt.py:131-152``), whose
contract the reference's BCR levels compute in jnp (``_gj_inv_lanes``,
``block_tridiag.py:243-282``).  The unpivoted Gauss-Jordan pivot at step k
equals the k-th LDL^T pivot, so one sweep gives the inverse and the inertia.
On the chained main path every BCR level and the root factor their
eliminated blocks with one launch: (64, 156, 156) float64 first, then
32, 16, ..., 1 blocks and the root, eight launches per factorization.

- ``block_ldlt_inv_plain(A)``: the plain PyTorch version, the same loop over
  k on the whole (nb, b, b) tensor.  The CPU path and the tests use it.
- ``block_ldlt_inv(A)``: the wrapper, A (nb, b, b) -> (d (nb, b),
  Ainv (nb, b, b)); the reference pads d to (nb, 8, b) for TPU tiles, the
  port does not.  A CPU tensor goes to the plain version; a CUDA tensor goes
  to the hand-written kernel ``csrc/block_ldlt_inv.cu`` or raises.  There is
  no fallback from the kernel to the plain version.
  ``block_ldlt_inv.launches`` counts the kernel launches.

What bounds the kernel on an H100: at (64, 156, 156) float64, the function
needs ~b^3 multiply-adds per block (486 M flops per launch, 7.3 us at the
67 TFLOP/s of the FP64 tensor cores) against 25 MB moved (7.5 us at
3.35 TB/s): bytes, barely.  The bit-exact scalar sweep does ~3 b^3
operations outside the tensor cores (729 M, 21 us at 34 TFLOP/s).  See the source note in
``csrc/block_ldlt_inv.cu`` for the design.  No PyTorch call computes this
function: ``torch.linalg.inv`` pivots and gives no pivot sequence, and
``torch.linalg.ldl_factor`` pivots (Bunch-Kaufman).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .block_ldlt import _safe_pivot

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def max_block(dtype) -> int:
    """Largest b the kernel takes for ``dtype``: (b*b + 2b) elements must
    fit in a CTA's shared memory (169 in float64, 240 in float32)."""
    return cuda_lib.max_block(torch.finfo(dtype).bits // 8, 2)


_MAX_B = {dt: max_block(dt) for dt in (torch.float32, torch.float64)}


def block_ldlt_inv_plain(A: torch.Tensor):
    """Plain PyTorch Gauss-Jordan sweep: A (nb, b, b) -> (d (nb, b),
    Ainv (nb, b, b)).  Step for step the arithmetic of ``_gj_inv_kernel``
    and ``_gj_inv_lanes``; every update reads the previous step's X."""
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


def _library():
    return cuda_lib.load("block_ldlt_inv", {"block_ldlt_inv_f32": _ARGTYPES,
                                            "block_ldlt_inv_f64": _ARGTYPES})


def block_ldlt_inv(A: torch.Tensor):
    """Batched pivots + inverse: A (nb, b, b) -> (d (nb, b), Ainv (nb, b, b)).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
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
    if b > _MAX_B[A.dtype]:
        raise ValueError(f"block_ldlt_inv: b = {b} exceeds the kernel's limit "
                         f"{_MAX_B[A.dtype]} for {A.dtype}")
    Ainv = torch.empty_like(A)
    d = torch.empty((nb, b), dtype=A.dtype, device=A.device)
    if nb == 0 or b == 0:
        return d, Ainv
    lib = _library()
    fn = lib.block_ldlt_inv_f64 if A.dtype == torch.float64 else lib.block_ldlt_inv_f32
    dev = A.device.index if A.device.index is not None else torch.cuda.current_device()
    err = fn(A.data_ptr(), Ainv.data_ptr(), d.data_ptr(), nb, b, dev,
             torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_ldlt_inv kernel launch failed: CUDA error {err}")
    block_ldlt_inv.launches += 1
    return d, Ainv


block_ldlt_inv.launches = 0
