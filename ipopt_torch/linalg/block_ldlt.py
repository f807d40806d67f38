"""K1: batched unpivoted LDL^T of many small symmetric blocks.

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
2 * 512 * 49 * 8 B = 401 KB (about 0.12 us at 3.35 TB/s) and does ~b^3 scalar
steps per block, so a launch's latency bounds it.  The design keeps each
block in shared memory through the whole elimination and covers the batch in
one launch (four blocks per 128-thread CTA for b <= 32); see the source note
in ``csrc/block_ldlt.cu``.  No PyTorch call computes an unpivoted LDL^T
(``torch.linalg.ldl_factor`` pivots, ``cholesky`` needs a definite matrix).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def max_block(dtype) -> int:
    """Largest b the kernel takes for ``dtype``: (b*b + b) elements must fit
    in a CTA's shared memory."""
    return cuda_lib.max_block(torch.finfo(dtype).bits // 8, 1)


_MAX_B = {dt: max_block(dt) for dt in (torch.float32, torch.float64)}


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
    if b > _MAX_B[A.dtype]:
        raise ValueError(f"block_ldlt: b = {b} exceeds the kernel's limit "
                         f"{_MAX_B[A.dtype]} for {A.dtype}")
    L = torch.empty_like(A)
    d = torch.empty((nb, b), dtype=A.dtype, device=A.device)
    if nb == 0 or b == 0:
        return L, d
    fn = (_library().block_ldlt_f64 if A.dtype == torch.float64
          else _library().block_ldlt_f32)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), nb, b,
             A.device.index if A.device.index is not None else torch.cuda.current_device(),
             stream)
    if err != 0:
        raise RuntimeError(f"block_ldlt kernel launch failed: CUDA error {err}")
    block_ldlt.launches += 1
    return L, d


block_ldlt.launches = 0
