"""Block-tridiagonal symmetric-indefinite factorization by block cyclic
reduction (BCR), over a batch (port of ``ipopt_tpu/linalg/block_tridiag.py``).

The matrix of each lane is block-tridiagonal (nb blocks of size b): diagonal
blocks ``diag[:, i]`` and sub-diagonal couplings ``sub[:, i] = K(i+1, i)``.
Each level eliminates the odd-indexed blocks of the current chain and keeps
the even ones; the eliminated blocks of every lane are inverted by one K2
launch (``block_ldlt_inv`` on the (B*ne, b, b) stack), whose pivots give the
inertia: odd-even elimination is a congruence, so by Sylvester's law the
inertia of K is the sum of the eliminated pivots' signs and the root's.
An odd chain is padded with an identity block, whose b positive pivots are
taken off again.  The root is the classic single block (the reference's
``_ROOT_DENSE_N = 0``).

Layout: batch-first, chain axis second, ``(B, nb, b, b)`` / ``(B, nb, b)``
(the reference keeps the chain axis last for the TPU's lanes).  The block
products are ``torch.matmul``; TF32 must stay off for float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
Neighbour updates are made in place on tensors each function has just
allocated, never on its inputs.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .block_ldlt import block_ldlt
from .block_ldlt_inv import block_ldlt_inv
from .ldlt import tri_solve_unit_lower, _safe
from ..types import torch_dtype


def _t(M):
    return M.transpose(-1, -2)


def _mv(M, x):
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Independent blocks: LDL^T and explicit inverses (the scenario blocks of the
# arrow backend, ``block_tridiag.py:99-182`` of the reference)
# ---------------------------------------------------------------------------

def batched_block_ldlt(A):
    """(nb, b, b) -> (L, d): K1 on a CUDA tensor, its plain version on a CPU
    tensor (``block_tridiag.py:118-124``)."""
    return block_ldlt(A.contiguous())


def _block_solve(L, d, B):
    """(L D L^T)^{-1} B per block by substitution; B is (nb, b, k)."""
    y = tri_solve_unit_lower(L, B)
    return tri_solve_unit_lower(L, y / _safe(d)[..., None], transpose=True)


def _tri_unit_inv_logdepth(L):
    """Inverse of the unit-lower-triangular L (nb, b, b) by the nilpotent
    product inv(L) = prod_k (I + T^(2^k)), T = I - L: ceil(log2 b) batched
    products (``block_tridiag.py:127-143``)."""
    b = L.shape[-1]
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    T = eye - L
    acc = eye + T
    steps = max((max(b, 2) - 1).bit_length(), 1)
    for _ in range(steps - 1):
        T = torch.matmul(T, T)
        acc = torch.matmul(acc, eye + T)
    return acc


def ldlt_inverse_newton(A, L, d):
    """A^{-1} = L^{-T} D^{-1} L^{-1} from the log-depth inverse of L, then
    one Newton step X (2 I - A X) (``block_tridiag.py:163-176``): the inverse
    step of ``batched_block_ldlt_inv``'s card branch for b <= 64.  The
    products are IEEE float64/float32 matmuls (TF32 stays off)."""
    Li = _tri_unit_inv_logdepth(L)
    Ainv = torch.matmul(_t(Li), Li / _safe(d)[..., None])
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.matmul(Ainv, 2.0 * eye - torch.matmul(A, Ainv))


def batched_block_ldlt_inv(A):
    """(nb, b, b) -> (d, Ainv): the pivots (for the inertia) and explicit
    inverses of independent symmetric blocks (``block_tridiag.py:146-182``).
    The reference runs two algorithms and so does the port, by the tensor's
    device: on the CPU the plain LDL^T and substitution; on the card K1,
    then for b <= 64 ``ldlt_inverse_newton`` and above the substitution."""
    L, d = batched_block_ldlt(A)
    b = A.shape[-1]
    if A.device.type != "cpu" and b <= 64:
        return d, ldlt_inverse_newton(A, L, d)
    eye = torch.eye(b, dtype=A.dtype, device=A.device).expand(A.shape)
    return d, _block_solve(L, d, eye)


class BTDMatrix(NamedTuple):
    """Block-tridiagonal symmetric matrices of a batch.

    diag: (B, nb, b, b) symmetric diagonal blocks
    sub:  (B, nb, b, b); sub[:, i] = K(i+1, i) (sub[:, nb-1] is ignored)
    """

    diag: Any
    sub: Any

    @property
    def nb(self):
        return self.diag.shape[1]

    @property
    def b(self):
        return self.diag.shape[2]

    def to_dense(self):
        B, nb, b = self.diag.shape[0], self.nb, self.b
        M = self.diag.new_zeros((B, nb * b, nb * b))
        for i in range(nb):
            M[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = self.diag[:, i]
            if i + 1 < nb:
                M[:, (i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = self.sub[:, i]
                M[:, i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = _t(self.sub[:, i])
        return M

    def matvec(self, x):
        """K x per lane: x (B, nb*b) -> (B, nb*b)."""
        B, nb, b = x.shape[0], self.nb, self.b
        X = x.reshape(B, nb, b)
        out = _mv(self.diag, X)
        out[:, 1:] += _mv(self.sub[:, :-1], X[:, :-1])
        out[:, :-1] += _mv(_t(self.sub[:, :-1]), X[:, 1:])
        return out.reshape(B, -1)


class BCRLevel(NamedTuple):
    """One level's data over its eliminated blocks (ne of them)."""

    ds: Any     # (B, ne, b) pivots
    Ainv: Any   # (B, ne, b, b)
    Gl: Any     # (B, ne, b, b): Ainv @ K(elim_t, keep_t)
    Gr: Any     # (B, ne, b, b): Ainv @ K(keep_{t+1}, elim_t)^T


class BCRFactor(NamedTuple):
    levels: Tuple       # of BCRLevel
    Ainv_root: Any      # (B, b, b)
    d_root: Any         # (B, b)
    nb: int
    b: int
    num_pos: Any        # (B,)
    num_neg: Any
    num_zero: Any
    singular: Any
    # Symmetric Ruiz equilibration: the factorization is of D K D with
    # D = diag(row_scale) (B, nb, b); ones when equilibration is off.
    row_scale: Any = None


def _block_inertia_counts(ds, pivot_tol):
    """(pos, neg, zero) pivot counts per lane of ds (B, nblocks, b); the zero
    threshold scales with each block's largest pivot.  NaN/Inf pivots fail
    every comparison and count as zeros, so the retry loop sees them as
    singular (``block_tridiag.py:409-424``)."""
    scale = torch.clamp(ds.abs().amax(-1, keepdim=True), min=1.0)
    base = pivot_tol if pivot_tol > 0 else torch.finfo(ds.dtype).eps
    is_zero = ds.abs() <= base * scale
    pos = (~is_zero & (ds > 0)).sum((-1, -2))
    neg = (~is_zero & (ds < 0)).sum((-1, -2))
    zer = is_zero.sum((-1, -2))
    missing = ds.shape[-1] * ds.shape[-2] - (pos + neg + zer)
    return pos, neg, zer + missing


def _next_row_scale(d):
    """d of block i+1 for every block i (ones for the last)."""
    return torch.cat([d[:, 1:], torch.ones_like(d[:, :1])], 1)


def btd_ruiz_scale(K: BTDMatrix, sweeps: int = 2):
    """Symmetric Ruiz equilibration scale D (B, nb, b) over the block
    structure (the MC19 analog, ``block_tridiag.py:427-448``)."""
    B, nb, b = K.diag.shape[:3]
    dtype = K.diag.dtype
    d = torch.ones((B, nb, b), dtype=dtype, device=K.diag.device)
    for _ in range(sweeps):
        dn = _next_row_scale(d)
        diag_s = K.diag.abs() * d[..., :, None] * d[..., None, :]
        sub_s = K.sub.abs() * dn[..., :, None] * d[..., None, :]
        rn = diag_s.amax(-1)
        # rows of block i+1 see sub[i][r, :]; rows of block i see sub[i][:, r]
        rn[:, 1:] = torch.maximum(rn[:, 1:], sub_s[:, :-1].amax(-1))
        rn[:, :-1] = torch.maximum(rn[:, :-1], sub_s[:, :-1].amax(-2))
        d = d / torch.sqrt(torch.clamp(rn, min=torch.finfo(dtype).tiny))
    return torch.clamp(d, 1e-8, 1e8)


def btd_apply_scale(K: BTDMatrix, d) -> BTDMatrix:
    """D K D over the block-tridiagonal structure."""
    dn = _next_row_scale(d)
    return BTDMatrix(diag=K.diag * d[..., :, None] * d[..., None, :],
                     sub=K.sub * dn[..., :, None] * d[..., None, :])


def btd_cast(K: BTDMatrix, dtype_str: str) -> BTDMatrix:
    """The blocks in ``factorization_dtype`` ("" keeps them,
    ``block_tridiag.py:459-467``); the caller keeps the full-precision K
    for the refinement."""
    if not dtype_str:
        return K
    dt = torch_dtype(dtype_str)
    return BTDMatrix(diag=K.diag.to(dt), sub=K.sub.to(dt))


def _gj_inv(D):
    """K2 on the blocks D (B, ne, b, b) of every lane in one launch."""
    B, ne, b, _ = D.shape
    ds, Ainv = block_ldlt_inv(D.reshape(B * ne, b, b).contiguous())
    return ds.reshape(B, ne, b), Ainv.reshape(B, ne, b, b)


def bcr_factorize(K: BTDMatrix, pivot_tol: float = 0.0,
                  equilibrate: bool = False) -> BCRFactor:
    """Factorize every lane of K by block cyclic reduction; ``calls`` counts
    these batched factorizations."""
    bcr_factorize.calls += 1
    B, nb, b = K.diag.shape[:3]
    dtype, dev = K.diag.dtype, K.diag.device
    if equilibrate:
        row_scale = btd_ruiz_scale(K)
        K = btd_apply_scale(K, row_scale)
    else:
        row_scale = torch.ones((B, nb, b), dtype=dtype, device=dev)

    diag, C = K.diag, K.sub          # C[:, j] couples block j+1 to j
    na = nb
    eye = torch.eye(b, dtype=dtype, device=dev).expand(B, 1, b, b)
    levels = []
    zi = torch.zeros((B,), dtype=torch.int64, device=dev)
    num_pos, num_neg, num_zero = zi, zi, zi
    n_pad_blocks = 0
    while na > 1:
        if na % 2 == 1:
            # an identity block, eliminated at this level: its b positive
            # pivots are taken off the inertia below
            diag = torch.cat([diag, eye], 1)
            C = torch.cat([C, torch.zeros_like(eye)], 1)
            na += 1
            n_pad_blocks += 1
        diag_e = diag[:, 1::2]       # eliminated
        diag_k = diag[:, 0::2]       # kept
        Ca = C[:, 0::2]              # K(elim_t, keep_t)
        Ci = C[:, 1::2]              # K(keep_{t+1}, elim_t); the last is padding
        ds, Ainv = _gj_inv(diag_e)
        p, n_, z = _block_inertia_counts(ds, pivot_tol)
        num_pos, num_neg, num_zero = num_pos + p, num_neg + n_, num_zero + z
        Gl = torch.matmul(Ainv, Ca)
        Gr = torch.matmul(Ainv, _t(Ci))
        # keep_t loses Ca_t^T Ainv Ca_t; keep_{t+1} loses Ci_t Ainv Ci_t^T
        updA = torch.matmul(_t(Ca), Gl)
        updC = torch.matmul(Ci, Gr)
        nk = diag_k.shape[1]
        diag_k = diag_k - updA
        diag_k[:, 1:] -= updC[:, :nk - 1]
        # new coupling K(keep_{t+1}, keep_t) = -Ci_t Ainv Ca_t
        C = -torch.matmul(Ci, Gl)[:, :nk]
        levels.append(BCRLevel(ds=ds, Ainv=Ainv, Gl=Gl, Gr=Gr))
        diag = diag_k
        na = nk
    d_root, Ainv_root = _gj_inv(diag)
    p, n_, z = _block_inertia_counts(d_root, pivot_tol)
    num_pos = num_pos + p - n_pad_blocks * b
    num_neg, num_zero = num_neg + n_, num_zero + z
    return BCRFactor(levels=tuple(levels), Ainv_root=Ainv_root[:, 0],
                     d_root=d_root[:, 0], nb=nb, b=b, num_pos=num_pos,
                     num_neg=num_neg, num_zero=num_zero, singular=num_zero > 0,
                     row_scale=row_scale)


bcr_factorize.calls = 0


def bcr_solve(fac: BCRFactor, rhs):
    """Solve K x = rhs per lane (rhs (B, nb*b), or (B, nb*b, k) for k
    right-hand sides over the one factorization) with the BCR
    factorization; with equilibration, x = D (D K D)^{-1} (D rhs)."""
    B, nb, b = rhs.shape[0], fac.nb, fac.b
    R = rhs.reshape(B, nb, b, -1) * fac.row_scale[..., None]
    k = R.shape[-1]
    stack = []
    for lvl in fac.levels:
        prepad = R.shape[1]
        if prepad % 2 == 1:
            R = torch.cat([R, R.new_zeros((B, 1, b, k))], 1)
        R_e = R[:, 1::2]
        R_k = R[:, 0::2]
        # r_keep_t -= Gl^T r_e;  r_keep_{t+1} -= Gr^T r_e
        R_k = R_k - _t(lvl.Gl) @ R_e
        R_k[:, 1:] -= (_t(lvl.Gr) @ R_e)[:, :R_k.shape[1] - 1]
        stack.append((R_e, prepad))
        R = R_k
    X = (fac.Ainv_root @ R[:, 0])[:, None]
    for lvl, (R_e, prepad) in zip(reversed(fac.levels), reversed(stack)):
        ne, nk = R_e.shape[1], X.shape[1]
        # x_e = Ainv r_e - Gl x_keep_t - Gr x_keep_{t+1}
        x_e = lvl.Ainv @ R_e
        x_e = x_e - lvl.Gl @ X[:, :ne]
        nbr = X.new_zeros((B, ne, b, k))
        take = min(ne, nk - 1)
        if take > 0:
            nbr[:, :take] = X[:, 1:1 + take]
        x_e = x_e - lvl.Gr @ nbr
        Xn = X.new_empty((B, nk + ne, b, k))
        Xn[:, 0::2] = X
        Xn[:, 1::2] = x_e
        X = Xn[:, :prepad]
    return (X * fac.row_scale[..., None]).reshape(rhs.shape)
