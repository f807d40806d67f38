"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 SXM (data sheet, dense rates) and the least work of each
hand-written kernel of the port, counted from its shapes.

K1 (``block_ldlt``): nb unpivoted LDL^T factorizations of width b: the
lower triangle of A read, L (b x b) and d written; at each step with s rows
below the pivot, s quotients and s (s + 1) / 2 multiply-adds (two operations
each).  K2 (``block_ldlt_inv``): nb block inverses with their pivots: A
read, the inverse and d written, b^3 multiply-adds (2 b^3 operations) per
block.  The least time is the larger of bytes over the bandwidth and
operations over the peak rate (float64 on the tensor cores).
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}


def _esize(dtype: str) -> int:
    return 8 if dtype.endswith("float64") else 4


def _least_s(nbytes: float, ops: float, dtype: str) -> float:
    name = "float64" if dtype.endswith("float64") else "float32"
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[name])


def k1_work(nb: int, b: int, dtype: str):
    """(bytes, operations) of one K1 call on an (nb, b, b) stack."""
    nbytes = _esize(dtype) * nb * (b * (b + 1) // 2 + b * b + b)
    # sum over s = 0 .. b-1 of s (s + 1) + s, in closed form
    ops = nb * ((b - 1) * b * (b + 1) // 3 + (b - 1) * b // 2)
    return nbytes, ops


def k2_work(nb: int, b: int, dtype: str):
    """(bytes, operations) of one K2 call on an (nb, b, b) stack."""
    return _esize(dtype) * (2 * nb * b * b + nb * b), 2 * nb * b ** 3


def k1_least_s(shape, dtype: str) -> float:
    nb, b = shape[0], shape[-1]
    return _least_s(*k1_work(nb, b, dtype), dtype)


def k2_least_s(shape, dtype: str) -> float:
    nb, b = shape[0], shape[-1]
    return _least_s(*k2_work(nb, b, dtype), dtype)
