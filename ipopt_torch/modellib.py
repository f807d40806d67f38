"""Model library of the port: the HS071 problem and the family the batched
benchmark solves (``bench.py:121-133``), LuksanVlcek1 as a plain NLP for the
dense backend (``tests/problems.py:146``), the chained LuksanVlcek1 and 1-D
boundary-control problems (``bench.py:302-314``, ``tests/test_chained.py``),
and the flat problems with declared sparsity of the banded backend,
LuksanVlcek1 and the 2-D Mittelmann distributed control
(``bench.py:247-299``).
Port of the part of ``ipopt_tpu/modellib.py`` on the ported paths; the other
models come with the slices that use them.

The stage functions of a chained model are module-level functions or
value-compared callables, so that two instances of one model share one
``ChainInfo`` and stack into a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .chained import ChainedNLP
from .problem import NLP

HS071_F_STAR = 17.0140171451792


def _hs071_f(x):
    return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]


def _hs071_g(x):
    return torch.stack([x[0] * x[1] * x[2] * x[3],
                        x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2])


def hs071_family(delta: float) -> NLP:
    """HS071 with the equality right-hand side moved to 40 + delta; the
    callables are shared by every member, so the members stack into one
    batch."""
    d = float(delta)
    return NLP(f=_hs071_f, g=_hs071_g, x_L=1.0, x_U=5.0,
               g_L=[25.0, 40.0 + d], g_U=[2e19, 40.0 + d],
               x0=[1.0, 5.0, 5.0, 1.0], name="hs071")


def hs071() -> NLP:
    """Hock-Schittkowski #71, the reference's canonical fixture
    (f* = 17.0140171451792)."""
    return hs071_family(0.0)


def _rosen(w):
    """Chained Rosenbrock terms with leading index in w[:-1]."""
    return (100.0 * (w[:-1] ** 2 - w[1:]) ** 2 + (w[:-1] - 1.0) ** 2).sum()


def _lv1_g(x):
    """The equalities with leading index 0..len(x)-3 (constraint j couples
    x_j, x_{j+1}, x_{j+2})."""
    a, b, c = x[:-2], x[1:-1], x[2:]
    return (3.0 * b ** 3 + 2.0 * c - 5.0 + torch.sin(b - c) * torch.sin(b + c)
            + 4.0 * b - a * torch.exp(a - b) - 3.0)


def _lv1_f_stage(xk, xk1, theta):
    return _rosen(torch.cat([xk, xk1[:1]]))


def _lv1_f_last(xK):
    return _rosen(xK)


def _lv1_g_stage(xk, xk1, theta):
    # rows with leading index j = k*v + i, i = 0..2v-3, over the 2v window
    return _lv1_g(torch.cat([xk, xk1]))


def luksan_vlcek1_dense(n: int) -> NLP:
    """LuksanVlcek1 as one plain NLP (``tests/problems.py:146-169``): n
    variables, n - 2 equalities, no declared structure, so the dense backend
    factors its whole augmented KKT, 2n - 2 wide (198 at n = 100)."""
    if n < 3:
        raise ValueError(f"need n >= 3, got {n}")
    x0 = np.full(n, -1.0)
    x0[1::2] = 1.0
    return NLP(f=_rosen, g=_lv1_g, g_L=np.zeros(n - 2), g_U=np.zeros(n - 2),
               x0=x0, name=f"luksan_vlcek1_dense{n}")


def luksan_vlcek1(n: int, v: int = 2) -> ChainedNLP:
    """LuksanVlcek1 (examples/ScalableProblems/LuksanVlcek1.cpp) as a chained
    problem with groups of ``v`` variables (``ipopt_tpu/modellib.py:35-94``):
    chained Rosenbrock objective, trigonometric-exponential equalities
    (constraint j couples x_j, x_{j+1}, x_{j+2}).  Stage k owns the rows with
    leading index in group k (the last stage also the tail up to n-3); the
    window's other rows are freed by infinite bounds.  Needs n % v == 0 and
    n >= 3v; the KKT blocks are v + 2(2v-2) wide."""
    if n % v or n < 3 * v:
        raise ValueError(f"need n divisible by v and n >= 3v, got {n}, {v}")
    K = n // v - 1
    mk = 2 * v - 2
    g_L = np.zeros((K, mk))
    g_U = np.zeros((K, mk))
    for k in range(K):
        for i in range(mk):
            j = k * v + i
            owned = (i < v) or (k == K - 1 and j <= n - 3)
            if not owned or j > n - 3:
                g_L[k, i] = -np.inf
                g_U[k, i] = np.inf
    x0 = np.full((K + 1, v), -1.0)
    x0.reshape(-1)[1::2] = 1.0
    return ChainedNLP(f_stage=_lv1_f_stage, g_stage=_lv1_g_stage,
                      f_last=_lv1_f_last, x0=x0, g_L=g_L, g_U=g_U,
                      name=f"luksan_vlcek1_n{n}_v{v}")


_BC_Y_T = 0.5
_BC_ALPHA = 0.01


@dataclasses.dataclass(frozen=True)
class _BndryControlObjective:
    h: float

    def __call__(self, yk, yk1, theta):
        return (0.5 * self.h * ((yk - _BC_Y_T) ** 2).sum()
                + 0.5 * theta[0] * yk[0] ** 2)


@dataclasses.dataclass(frozen=True)
class _BndryControlTerminal:
    h: float

    def __call__(self, yK):
        return (0.5 * self.h * ((yK - _BC_Y_T) ** 2).sum()
                + 0.5 * _BC_ALPHA * yK[-1] ** 2)


@dataclasses.dataclass(frozen=True)
class _BndryControlPDE:
    h: float

    def __call__(self, yk, yk1, theta):
        w = torch.cat([yk, yk1])
        ym, yc, yp = w[:-2], w[1:-1], w[2:]
        return (-ym + 2.0 * yc - yp) / (self.h * self.h) - (yc ** 3 - yc)


def mittelmann_bndry_control_1d(N: int, v: int = 0) -> ChainedNLP:
    """1-D analogue of MittelmannBndryCntrlDiri
    (``ipopt_tpu/modellib.py:129-192``): discretized Poisson boundary control

        min  0.5 h sum_i (y_i - y_t)^2  +  alpha/2 (u_0^2 + u_1^2)
        s.t. (-y_{i-1} + 2 y_i - y_{i+1})/h^2 = y_i^3 - y_i,   i = 1..N-2
             y_0 = u_0,  y_{N-1} = u_1,  -2 <= u <= 2

    chained over the grid in groups of v points."""
    if v == 0:
        v = max(2, min(32, N // 8))
    if N % v or N < 3 * v or v < 2:
        raise ValueError(f"need N divisible by v >= 2, got {N}, {v}")
    h = 1.0 / (N - 1)
    K = N // v - 1
    mk = 2 * v - 2
    g_L = np.zeros((K, mk))
    g_U = np.zeros((K, mk))
    for k in range(K):
        for i in range(mk):
            center = k * v + 1 + i
            owned = (center <= k * v + v) or (k == K - 1 and center <= N - 2)
            if not owned or center >= N - 1:
                g_L[k, i] = -np.inf
                g_U[k, i] = np.inf
    theta = np.zeros((K, 1))
    theta[0, 0] = _BC_ALPHA  # the control penalty on y_0 lives in stage 0
    x_L = np.full((K + 1, v), -np.inf)
    x_U = np.full((K + 1, v), np.inf)
    x_L[0, 0], x_U[0, 0] = -2.0, 2.0
    x_L[-1, -1], x_U[-1, -1] = -2.0, 2.0
    return ChainedNLP(
        f_stage=_BndryControlObjective(h), g_stage=_BndryControlPDE(h),
        f_last=_BndryControlTerminal(h), theta=theta, x0=np.full((K + 1, v), 0.3),
        g_L=g_L, g_U=g_U, x_L=x_L, x_U=x_U, name=f"mittelmann1d_N{N}_v{v}")


def band_sparsity(m: int, n: int, lo_off: int, hi_off: int):
    """COO pattern (rows, cols) of a banded (m, n) matrix whose row i covers
    the columns i + lo_off .. i + hi_off (clipped), to declare a Jacobian or
    Hessian pattern for ``linear_solver="banded-bcr"``
    (``ipopt_tpu/modellib.py:245``)."""
    rows = []
    cols = []
    for off in range(lo_off, hi_off + 1):
        i = np.arange(max(0, -off), min(m, n - off), dtype=np.int32)
        rows.append(i)
        cols.append(i + np.int32(off))
    return np.concatenate(rows), np.concatenate(cols)


def luksan_vlcek1_flat(n: int) -> NLP:
    """LuksanVlcek1 as one flat NLP with its declared sparsity, for the
    banded backend (``ipopt_tpu/modellib.py:97-126``): the Jacobian's row i
    covers x_i..x_{i+2} (m = n - 2 equalities), the Lagrangian Hessian has
    bandwidth 2.  Solve it with ``linear_solver="banded-bcr"``."""
    if n < 4:
        raise ValueError(f"need n >= 4, got {n}")
    m = n - 2
    x0 = np.full(n, -1.0)
    x0[1::2] = 1.0
    return NLP(f=_rosen, g=_lv1_g, g_L=np.zeros(m), g_U=np.zeros(m), x0=x0,
               jac_g_sparsity=band_sparsity(m, n, 0, 2),
               lag_hess_sparsity=band_sparsity(n, n, -2, 2),
               name=f"luksan_vlcek1_flat{n}")


class _DeviceConstant:
    """A numpy constant as a tensor on the device and dtype of each call's
    argument, made once per (device, dtype)."""

    def __init__(self, value: np.ndarray):
        self.value = value
        self._cache = {}

    def like(self, x: torch.Tensor) -> torch.Tensor:
        key = (str(x.device), x.dtype)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(self.value, dtype=x.dtype, device=x.device)
            self._cache[key] = t
        return t


def mittelmann_dist_control(N: int) -> NLP:
    """MittelmannDistCntrlNeumA1 (``ipopt_tpu/modellib.py:489-590``;
    examples/ScalableProblems/MittelmannDistCntrlNeumA.hpp:413-439): 2-D
    elliptic distributed control with Neumann boundary conditions,

        min  hh sum_int 0.5 ((y_ij - yd)^2 + alpha u_ij^2)
        s.t. 4 y_ij - y_nbrs + hh (-exp(y_ij) - u_ij) = 0   (interior PDE)
             (1 + h b) y_bnd - y_adj = 0                    (Neumann rows)
             y <= 0.371,  -8 <= u <= 9

    with yd = sin(2 pi x1) sin(2 pi x2), alpha = 0.001, b = 1, on an
    (N+2)^2 grid with N^2 interior controls: x = [Y | U].  Its Jacobian and
    Hessian patterns are declared, built in numpy as the reference builds
    them; RCM recovers the O(N) bandwidth.  Solve it with
    ``linear_solver="banded-bcr"``."""
    Ng = N + 2
    h = 1.0 / (N + 1)
    hh = h * h
    alpha = 0.001
    b = 1.0
    ny = Ng * Ng
    n = ny + N * N

    def yi(i, j):
        return i * Ng + j

    ii, jj = np.meshgrid(np.arange(1, N + 1), np.arange(1, N + 1), indexing="ij")
    x1 = ii.astype(np.float64) * h
    x2 = jj.astype(np.float64) * h
    yd = _DeviceConstant(
        (np.sin(2.0 * np.pi * x1) * np.sin(2.0 * np.pi * x2)).reshape(-1))

    def f(x):
        Y = x[:ny].reshape(Ng, Ng)
        u = x[ny:]
        y_int = Y[1:-1, 1:-1].reshape(-1)
        return hh * (0.5 * ((y_int - yd.like(x)) ** 2 + alpha * u ** 2)).sum()

    def g(x):
        Y = x[:ny].reshape(Ng, Ng)
        u = x[ny:].reshape(N, N)
        yc = Y[1:-1, 1:-1]
        pde = (4.0 * yc - Y[:-2, 1:-1] - Y[2:, 1:-1]
               - Y[1:-1, :-2] - Y[1:-1, 2:]
               + hh * (-torch.exp(yc) - u))
        nbr = [(1.0 + h * b) * Y[1:-1, 0] - Y[1:-1, 1],      # j = 0 side
               (1.0 + h * b) * Y[1:-1, -1] - Y[1:-1, -2],    # j = N+1
               (1.0 + h * b) * Y[0, 1:-1] - Y[1, 1:-1],      # i = 0
               (1.0 + h * b) * Y[-1, 1:-1] - Y[-2, 1:-1]]    # i = N+1
        return torch.cat([pde.reshape(-1)] + nbr)

    m = N * N + 4 * N
    jr, jc = [], []
    r = 0
    for i in range(1, N + 1):
        for j in range(1, N + 1):
            for (a, bb) in ((i, j), (i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                jr.append(r)
                jc.append(yi(a, bb))
            jr.append(r)
            jc.append(ny + (i - 1) * N + (j - 1))
            r += 1
    for i in range(1, N + 1):                    # j = 0 side
        jr += [r, r]
        jc += [yi(i, 0), yi(i, 1)]
        r += 1
    for i in range(1, N + 1):                    # j = N+1
        jr += [r, r]
        jc += [yi(i, Ng - 1), yi(i, Ng - 2)]
        r += 1
    for j in range(1, N + 1):                    # i = 0
        jr += [r, r]
        jc += [yi(0, j), yi(1, j)]
        r += 1
    for j in range(1, N + 1):                    # i = N+1
        jr += [r, r]
        jc += [yi(Ng - 1, j), yi(Ng - 2, j)]
        r += 1
    assert r == m
    diag = np.arange(n, dtype=np.int32)

    x_L = np.full(n, -1e20)
    x_U = np.full(n, np.inf)
    x_U[:ny] = 0.371
    x_L[ny:] = -8.0
    x_U[ny:] = 9.0
    x0 = np.zeros(n)
    x0[ny:] = 0.5 * (-8.0 + 9.0)
    return NLP(f=f, g=g, g_L=np.zeros(m), g_U=np.zeros(m), x_L=x_L, x_U=x_U, x0=x0,
               jac_g_sparsity=(np.asarray(jr, np.int32), np.asarray(jc, np.int32)),
               lag_hess_sparsity=(diag, diag), name=f"mittelmann_dist_control_N{N}")
