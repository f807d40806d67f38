"""Dense unpivoted LDL^T with inertia, over a batch (port of
``ipopt_tpu/linalg/ldlt.py``).

The contract of ``SparseSymLinearSolverInterface`` (hpp:30-118) is kept:
factorize -> report inertia -> solve.  The factorization stays unpivoted:
``torch.linalg.ldl_factor`` pivots (Bunch-Kaufman), which would change D, the
inertia counts and the whole trajectory (``ldlt.py:10-16`` of the reference).
``ldlt`` factors every lane of a (B, N, N) batch with one call of K1
(``block_ldlt``); the triangular solves are the substitution loops of the
reference's CPU path (``ldlt.py:31-72``) on every device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .block_ldlt import block_ldlt


class LDLTResult(NamedTuple):
    L: Any         # (B, N, N) unit lower triangular factor
    d: Any         # (B, N) diagonal of D
    num_pos: Any   # (B,) inertia: positive pivots
    num_neg: Any   # (B,) negative pivots
    num_zero: Any  # (B,) pivots treated as zero
    singular: Any  # (B,) bool
    # Symmetric equilibration: the factorization is of (S K S), S = diag.
    row_scale: Any = None


def _pivot_tols(d_abs_max, dtype, pivot_tol):
    eps = torch.finfo(dtype).eps
    base = pivot_tol if pivot_tol > 0 else eps
    return base * torch.clamp(d_abs_max, min=1.0)


def _finish(L, d, pivot_tol) -> LDLTResult:
    """Pivot tolerance and inertia counts (``ldlt.py:141-148``)."""
    zero_tol = _pivot_tols(d.abs().amax(-1), d.dtype, pivot_tol)
    is_zero = d.abs() <= zero_tol[:, None]
    num_zero = is_zero.sum(-1)
    num_pos = (~is_zero & (d > 0)).sum(-1)
    num_neg = (~is_zero & (d < 0)).sum(-1)
    return LDLTResult(L, d, num_pos, num_neg, num_zero, num_zero > 0,
                      torch.ones_like(d))


def ldlt(A: torch.Tensor, pivot_tol: float = 0.0) -> LDLTResult:
    """Unpivoted LDL^T of every lane of A (B, N, N), in one K1 call.
    ``ldlt.calls`` counts these batched factorizations."""
    B, n, _ = A.shape
    if n == 0:
        z = A.new_zeros((B, 0))
        zi = torch.zeros((B,), dtype=torch.int64, device=A.device)
        return LDLTResult(A.new_zeros((B, 0, 0)), z, zi, zi, zi,
                          torch.zeros((B,), dtype=torch.bool, device=A.device), z)
    ldlt.calls += 1
    L, d = block_ldlt(A.contiguous())
    return _finish(L, d, pivot_tol)


ldlt.calls = 0


def ldlt_blocked(A: torch.Tensor, block: int = 128,
                 pivot_tol: float = 0.0) -> LDLTResult:
    """Blocked right-looking LDL^T of every lane of A (B, N, N)
    (``linear_solver="dense-ldlt-blocked"``, ``ipopt_tpu/linalg/ldlt.py:
    151-220``): N padded with identity to a multiple of ``block``, then per
    panel j, in the reference's order: the diagonal block's LDL^T (K1 at
    (B, block, block), one launch per panel; the reference runs a jnp loop
    there, so these launches are the port's choice), the panel below it by a
    triangular solve (``tri_solve_blocks``: substitution on the CPU,
    ``torch.linalg.solve_triangular`` on the card), and the trailing update
    by ``torch.matmul`` (TF32 must stay off for float32).  A pivot K1 guards
    to +-tiny adds nothing to the trailing update, as the reference's raw
    zero pivot does.  ``ldlt.calls`` counts it as one factorization."""
    B, n, _ = A.shape
    if n == 0 or n <= block:
        return ldlt(A, pivot_tol)
    ldlt.calls += 1
    npad = -(-n // block) * block
    M = A.new_zeros((B, npad, npad))
    M[:, :n, :n] = A
    if npad != n:
        pad = torch.arange(n, npad, device=A.device)
        M[:, pad, pad] = 1.0
    tiny = torch.finfo(A.dtype).tiny
    for r0 in range(0, npad, block):
        r1 = r0 + block
        Lkk, dk = block_ldlt(M[:, r0:r1, r0:r1].contiguous())
        M[:, r0:r1, r0:r1] = Lkk + torch.diag_embed(dk) - torch.eye(
            block, dtype=A.dtype, device=A.device)
        if r1 == npad:
            break
        # X Lkk^T = B  <=>  Lkk X^T = B^T
        Xt = tri_solve_blocks(Lkk, M[:, r1:, r0:r1].transpose(-1, -2))
        Lpan = Xt.transpose(-1, -2) / _safe(dk)[:, None, :]
        d_upd = torch.where(dk.abs() <= tiny, torch.zeros_like(dk), dk)
        M[:, r1:, r1:] -= torch.matmul(Lpan * d_upd[:, None, :],
                                       Lpan.transpose(-1, -2))
        M[:, r1:, r0:r1] = Lpan
    d = M.diagonal(dim1=1, dim2=2)[:, :n].clone()
    L = torch.tril(M[:, :n, :n], -1) + torch.eye(n, dtype=A.dtype, device=A.device)
    return _finish(L, d, pivot_tol)


def _safe(d):
    tiny = torch.full_like(d, torch.finfo(d.dtype).tiny)
    return torch.where(d.abs() > tiny, d, torch.where(d >= 0, tiny, -tiny))


def _subst_fwd(L, Y):
    """Solve L Y = B (L unit lower (B, N, N), Y (B, N, m)) by substitution."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    zero = torch.zeros((), dtype=Y.dtype, device=Y.device)
    for k in range(n):
        mask = (idx > k)[None, :, None]
        Y = Y - torch.where(mask, L[:, :, k, None] * Y[:, k, None, :], zero)
    return Y


def _subst_bwd(L, X):
    """Solve L^T X = B by substitution."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for i in range(n):
        k = n - 1 - i
        mask = (idx < k)[None, :, None]
        X = X - torch.where(mask, L[:, k, :, None] * X[:, k, None, :], zero)
    return X


def tri_solve_unit_lower(L, B, transpose: bool = False):
    """Solve L Y = B (or L^T Y = B) for unit-lower-triangular L, per lane."""
    return _subst_bwd(L, B) if transpose else _subst_fwd(L, B)


def tri_solve_blocks(L, Bm, transpose: bool = False):
    """Unit-lower triangular solves per block: the substitution on the CPU,
    the library's triangular solve on the card (the reference's split,
    ``ipopt_tpu/linalg/ldlt.py:58-74``).  L (..., p, p), Bm (..., p, k)."""
    if L.device.type == "cpu":
        shape = Bm.shape
        out = tri_solve_unit_lower(L.reshape((-1,) + L.shape[-2:]),
                                   Bm.reshape((-1,) + shape[-2:]),
                                   transpose=transpose)
        return out.reshape(shape)
    if transpose:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), Bm, upper=True,
                                             unitriangular=True)
    return torch.linalg.solve_triangular(L, Bm, upper=False, unitriangular=True)


def ldlt_solve(fac: LDLTResult, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b per lane given (S A S) = L D L^T.  b is (B, N) or
    (B, N, k)."""
    L, d = fac.L, fac.d
    n = L.shape[-1]
    if n == 0:
        return b
    vec = b.dim() == 2
    Bm = b[..., None] if vec else b
    if fac.row_scale is not None:
        Bm = Bm * fac.row_scale[..., None]
    y = tri_solve_unit_lower(L, Bm)
    z = y / _safe(d)[..., None]
    x = tri_solve_unit_lower(L, z, transpose=True)
    if fac.row_scale is not None:
        x = x * fac.row_scale[..., None]
    return x[..., 0] if vec else x


def dense_solve(A, b):
    """Solve A x = b for small symmetric matrices through the unpivoted
    LDL^T (the reference's CPU path, ``ldlt.py:75-84``)."""
    return ldlt_solve(ldlt(A), b)
