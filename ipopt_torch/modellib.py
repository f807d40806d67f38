"""Model library of the port (``ipopt_tpu/modellib.py``): the HS071 problem
and the family the batched benchmark solves (``bench.py:121-133``),
LuksanVlcek1 as a plain NLP for the dense backend (``tests/problems.py:146``),
the chained LuksanVlcek1 and 1-D boundary-control problems
(``bench.py:302-314``, ``tests/test_chained.py``), the flat problems with
declared sparsity of the banded backend (LuksanVlcek1 and the 2-D Mittelmann
distributed control, ``bench.py:247-299``), LuksanVlcek 2-7 in equality (E)
and inequality (I) form, and the 2-D Mittelmann boundary control chained
over pairs of grid rows, and the two-stage stochastic QP of the reference's
scenario tests (``tests/test_scenario.py:11``) for the block-arrow backend.
``mittelmann_dist_control_3d`` and the 3-D Dirichlet boundary control
``mittelmann_bndry_control_3d`` come with the multifrontal backend that
solves them.

The stage functions of a chained model are module-level functions or
value-compared callables, so that two instances of one model share one
``ChainInfo`` and stack into a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .chained import ChainedNLP
from .parallel.scenario import ScenarioNLP
from .problem import NLP
from .types import DeviceConstant

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
    yd = DeviceConstant(
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


def mittelmann_dist_control_3d(N: int) -> NLP:
    """3-D elliptic distributed control (``ipopt_tpu/modellib.py:593-668``):
    ``mittelmann_dist_control``'s semilinear PDE constraint carried to a
    7-point stencil with the Dirichlet boundary y = 0.  No problem of
    Ipopt's examples/ScalableProblems states it, so its constants are the
    2-D problem's; ``mittelmann_bndry_control_3d`` is the published 3-D
    problem of that directory.

        min  hh sum 0.5 ((y_ijk - yd)^2 + alpha u_ijk^2)
        s.t. 6 y_ijk - y_nbrs + hh (-exp(y_ijk) - u_ijk) = 0
             y <= 0.371,  -8 <= u <= 9

    with yd = sin(2 pi x1) sin(2 pi x2) sin(2 pi x3), alpha = 0.001, and
    x = [Y (N^3 interior) | U (N^3)].  The declared 7-point Jacobian
    pattern has an RCM bandwidth of O(N^2), too wide for banded BCR: solve
    it with ``linear_solver="multifrontal"``."""
    h = 1.0 / (N + 1)
    hh = h * h
    alpha = 0.001
    ny = N * N * N
    n = 2 * ny
    m = ny

    ii, jj, kk = np.meshgrid(np.arange(1, N + 1), np.arange(1, N + 1),
                             np.arange(1, N + 1), indexing="ij")
    yd = DeviceConstant((np.sin(2 * np.pi * ii * h) * np.sin(2 * np.pi * jj * h)
                         * np.sin(2 * np.pi * kk * h)).reshape(-1))

    def f(x):
        y = x[:ny]
        u = x[ny:]
        return hh * (0.5 * ((y - yd.like(x)) ** 2 + alpha * u ** 2)).sum()

    def g(x):
        Y = x[:ny].reshape(N, N, N)
        u = x[ny:].reshape(N, N, N)
        Yp = torch.nn.functional.pad(Y, (1, 1, 1, 1, 1, 1))   # y = 0 outside
        pde = (6.0 * Y
               - Yp[:-2, 1:-1, 1:-1] - Yp[2:, 1:-1, 1:-1]
               - Yp[1:-1, :-2, 1:-1] - Yp[1:-1, 2:, 1:-1]
               - Yp[1:-1, 1:-1, :-2] - Yp[1:-1, 1:-1, 2:]
               + hh * (-torch.exp(Y) - u))
        return pde.reshape(-1)

    # the declared 7-point-stencil Jacobian pattern, built as the reference's
    idx = np.arange(ny, dtype=np.int32).reshape(N, N, N)
    rows = [idx.reshape(-1)]                     # center y
    cols = [idx.reshape(-1)]
    for axis, off in ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)):
        sl_r = [slice(None)] * 3
        sl_c = [slice(None)] * 3
        sl_r[axis] = slice(1, None) if off == -1 else slice(None, -1)
        sl_c[axis] = slice(None, -1) if off == -1 else slice(1, None)
        rows.append(idx[tuple(sl_r)].reshape(-1))
        cols.append(idx[tuple(sl_c)].reshape(-1))
    rows.append(idx.reshape(-1))                 # u column
    cols.append(ny + idx.reshape(-1))
    jr = np.concatenate(rows)
    jc = np.concatenate(cols)
    diag = np.arange(n, dtype=np.int32)

    x_L = np.full(n, -1e20)
    x_U = np.full(n, np.inf)
    x_U[:ny] = 0.371
    x_L[ny:] = -8.0
    x_U[ny:] = 9.0
    x0 = np.zeros(n)
    x0[ny:] = 0.5
    return NLP(name=f"mittelmann_dist_control_3d_N{N}",
               f=f, g=g, g_L=np.zeros(m), g_U=np.zeros(m),
               x_L=x_L, x_U=x_U, x0=x0,
               jac_g_sparsity=(jr, jc), lag_hess_sparsity=(diag, diag))


def mittelmann_bndry_control_3d(N: int) -> NLP:
    """MittelmannBndryCntrlDiri3D (examples/ScalableProblems/
    MittelmannBndryCntrlDiri3D.{hpp,cpp}): the 3-D form of
    ``mittelmann_bndry_control``'s example 1, Poisson Dirichlet boundary
    control on the unit cube,

        min  h^3/2 sum_int (y_ijk - y_d)^2 + alpha h^2/2 sum_bnd y^2
        s.t. 6 y_ijk - y_{i+-1,j,k} - y_{i,j+-1,k} - y_{i,j,k+-1}
                 = -h^2 d_const                (interior i, j, k = 1..N)
             y_int <= ub_y,  lb_u <= y_bnd <= ub_u

    on an (N+2)^3 grid, h = 1/(N+1), x = y row-major over (i, j, k): the
    controls are the boundary values of y, edges and corners included (they
    enter no PDE row).  y_d = 3 + 5 x1 (x1 - 1) x2 (x2 - 1) x3 (x3 - 1) and
    example 1's alpha = 0.01, ub_y = 3.5, lb_u = 0, ub_u = 10, d_const =
    -20; the start is y_d inside and (lb_u + ub_u) / 2 on the boundary, as
    ``mittelmann_bndry_control``'s.  Edges and corners are kept as bounded
    controls with the control weight, as that builder keeps its corners:
    they enter no PDE row, so their optimum is lb_u = 0.  The 7-point
    Jacobian pattern and the diagonal Hessian are declared: solve it with
    ``linear_solver="multifrontal"``."""
    alpha, ub_y, lb_u, ub_u = _MITTELMANN_EXAMPLES[1]
    Ng = N + 2
    h = 1.0 / (N + 1)
    n = Ng ** 3
    t = np.arange(Ng) / (N + 1)
    q = t * (t - 1.0)
    yd_grid = 3.0 + 5.0 * q[:, None, None] * q[None, :, None] * q[None, None, :]
    y_d = DeviceConstant(yd_grid[1:-1, 1:-1, 1:-1].reshape(-1))
    interior = np.zeros((Ng, Ng, Ng), bool)
    interior[1:-1, 1:-1, 1:-1] = True
    bnd = DeviceConstant(np.flatnonzero(~interior))

    def f(x):
        Y = x.reshape(Ng, Ng, Ng)
        y_int = Y[1:-1, 1:-1, 1:-1].reshape(-1)
        return (h ** 3 / 2.0 * ((y_int - y_d.like(x)) ** 2).sum()
                + alpha * h * h / 2.0 * (x[bnd.like(x)] ** 2).sum())

    def g(x):
        Y = x.reshape(Ng, Ng, Ng)
        pde = (6.0 * Y[1:-1, 1:-1, 1:-1]
               - Y[:-2, 1:-1, 1:-1] - Y[2:, 1:-1, 1:-1]
               - Y[1:-1, :-2, 1:-1] - Y[1:-1, 2:, 1:-1]
               - Y[1:-1, 1:-1, :-2] - Y[1:-1, 1:-1, 2:])
        return pde.reshape(-1)

    idx = np.arange(n, dtype=np.int32).reshape(Ng, Ng, Ng)
    rows = np.arange(N ** 3, dtype=np.int32)
    cols = [idx[1:-1, 1:-1, 1:-1]]
    for axis in range(3):
        for lo in (0, 2):
            sl = [slice(1, -1)] * 3
            sl[axis] = slice(lo, lo + N)
            cols.append(idx[tuple(sl)])
    jr = np.tile(rows, 7)
    jc = np.concatenate([c.reshape(-1) for c in cols])
    diag = np.arange(n, dtype=np.int32)
    rhs = -(h * h) * -20.0                 # -h^2 d_const
    x_L = np.where(interior, -1e20, lb_u).reshape(-1)
    x_U = np.where(interior, ub_y, ub_u).reshape(-1)
    x0 = np.where(interior, yd_grid, 0.5 * (lb_u + ub_u)).reshape(-1)
    return NLP(f=f, g=g, g_L=np.full(N ** 3, rhs), g_U=np.full(N ** 3, rhs),
               x_L=x_L, x_U=x_U, x0=x0, jac_g_sparsity=(jr, jc),
               lag_hess_sparsity=(diag, diag), name=f"mittelmann_bndry_control_3d_N{N}")


def _lv_bounds(m: int, equality: bool):
    """g_L, g_U of the LukVlE (g = 0) and LukVlI (-1 <= g <= 0) instances."""
    return (np.zeros(m) if equality else np.full(m, -1.0)), np.zeros(m)


def _lv_name(k: int, n: int, equality: bool) -> str:
    return f"luksan_vlcek{k}_{'E' if equality else 'I'}{n}"


def _window_sums(q, rows: int, total: int):
    """sum_{k = max(0, i-5)}^{min(total-1, i+1)} q_k for i = 0..rows-1."""
    cq = torch.cat([q.new_zeros(1), torch.cumsum(q, 0)])
    i = torch.arange(rows, device=q.device)
    lo = torch.clamp(i - 5, min=0)
    hi = torch.clamp(i + 1, max=total - 1)
    return cq[hi + 1] - cq[lo]


def luksan_vlcek2(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek2 (``ipopt_tpu/modellib.py:195-242``): chained Wood-like
    objective over variable pairs and the 11-wide window constraints
    g_i = (2 + 5 x_{i+5}^2) x_{i+5} + 1 + sum_{k=max(0,i-5)}^{i+1} x_k (x_k + 1),
    i = 0..n-10.  n % 2 == 0, n >= 12."""
    assert n % 2 == 0 and n >= 12
    m = n - 9

    def f(x):
        xe, xo, xe2, xo2 = x[0:n - 2:2], x[1:n - 1:2], x[2:n:2], x[3:n:2]
        return (100.0 * (xe ** 2 - xo) ** 2 + (xe - 1.0) ** 2
                + 90.0 * (xe2 ** 2 - xo2) ** 2 + (xe2 - 1.0) ** 2
                + 10.0 * (xo + xo2 - 2.0) ** 2 + 0.1 * (xo - xo2) ** 2).sum()

    def g(x):
        x5 = x[5:5 + m]
        return (2.0 + 5.0 * x5 ** 2) * x5 + 1.0 + _window_sums(x * (x + 1.0), m, n + 1)

    x0 = np.empty(n)
    x0[0::2] = -2.0
    x0[1::2] = 1.0
    g_L, g_U = _lv_bounds(m, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=x0, name=_lv_name(2, n, equality))


def luksan_vlcek3(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek3 (``ipopt_tpu/modellib.py:669-702``): chained Powell
    singular objective and two boundary constraints.  n % 4 == 0, n >= 8."""
    assert n % 4 == 0 and n >= 8

    def f(x):
        xe, xo, xe2, xo2 = x[0:n - 2:2], x[1:n - 1:2], x[2:n:2], x[3:n:2]
        return ((xe + 10.0 * xo) ** 2 + 5.0 * (xe2 - xo2) ** 2
                + (xo - 2.0 * xe2) ** 4 + 10.0 * (xe - xo2) ** 4).sum()

    def g(x):
        return torch.stack([
            3.0 * x[0] ** 3 + 2.0 * x[1] - 5.0
            + torch.sin(x[0] - x[1]) * torch.sin(x[0] + x[1]),
            4.0 * x[n - 3] - x[n - 4] * torch.exp(x[n - 4] - x[n - 3]) - 3.0])

    x0 = np.empty(n)
    x0[0::4], x0[1::4], x0[2::4], x0[3::4] = 3.0, -1.0, 0.0, 1.0
    g_L, g_U = _lv_bounds(2, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=x0, name=_lv_name(3, n, equality))


def luksan_vlcek4(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek4 (``ipopt_tpu/modellib.py:259-299``): chained exponential/
    tangent objective over 4-wide windows and the cubic constraints
    g_i = 8 x_{i+1}(x_{i+1}^2 - x_i) - 2(1 - x_{i+1}) + 4(x_{i+1} - x_{i+2}^2),
    i = 0..n-5, with the declared sparsity of the reference (the Jacobian's
    row i covers x_i..x_{i+2}, the Lagrangian Hessian is tridiagonal) for
    ``linear_solver="banded-bcr"``.  n % 4 == 0, n >= 8."""
    assert n % 4 == 0 and n >= 8
    m = n - 4

    def f(x):
        x0, x1, x2, x3 = x[0:n - 2:2], x[1:n - 1:2], x[2:n:2], x[3:n:2]
        return ((torch.exp(x0) - x1) ** 4 + 100.0 * (x1 - x2) ** 6
                + torch.tan(x2 - x3) ** 4 + x0 ** 8 + (x3 - 1.0) ** 2).sum()

    def g(x):
        xi, xi1, xi2 = x[0:m], x[1:m + 1], x[2:m + 2]
        return (8.0 * xi1 * (xi1 ** 2 - xi) - 2.0 * (1.0 - xi1)
                + 4.0 * (xi1 - xi2 ** 2))

    x0 = np.full(n, 2.0)
    x0[0::4] = 1.0
    g_L, g_U = _lv_bounds(m, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=x0, name=_lv_name(4, n, equality),
               jac_g_sparsity=band_sparsity(m, n, 0, 2),
               lag_hess_sparsity=band_sparsity(n, n, -1, 1))


def luksan_vlcek5(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek5 (``ipopt_tpu/modellib.py:302-330``): chained |.|^(7/3)
    tridiagonal objective and 5-wide cubic constraints, i = 0..n-7, x0 = -1,
    with the declared sparsity of the reference (the Jacobian's row i covers
    x_{i+1}..x_{i+5}, the Hessian has bandwidth 2).  n >= 8."""
    assert n >= 8
    m = n - 6

    def f(x):
        xm, xc, xp = x[0:n - 2], x[1:n - 1], x[2:n]
        return (((3.0 - 2.0 * xc) * xc - xm - xp + 1.0).abs() ** (7.0 / 3.0)).sum()

    def g(x):
        x1, x2, x3, x4, x5 = (x[k:m + k] for k in range(1, 6))
        return (8.0 * x3 * (x3 ** 2 - x2) - 2.0 * (1.0 - x3)
                + 4.0 * (x3 - x4 ** 2) + x2 ** 2 - x1 + x4 - x5 ** 2)

    g_L, g_U = _lv_bounds(m, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=np.full(n, -1.0),
               name=_lv_name(5, n, equality),
               jac_g_sparsity=band_sparsity(m, n, 1, 5),
               lag_hess_sparsity=band_sparsity(n, n, -2, 2))


def luksan_vlcek6(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek6 (``ipopt_tpu/modellib.py:333-366``): chained |.|^(7/3)
    objective over a 7-wide window sum and exponential constraints over
    variable pairs, (n-1)/2 rows, x0 = 3.  Odd n >= 3."""
    assert n % 2 == 1 and n >= 3
    N = n - 1
    m = N // 2

    def f(x):
        xs = x[:N]
        b = (2.0 + 5.0 * xs ** 2) * xs + 1.0 + _window_sums(xs * (1.0 + xs), N, N)
        return (b.abs() ** (7.0 / 3.0)).sum()

    def g(x):
        xe, xo, xe2 = x[0:2 * m:2], x[1:2 * m + 1:2], x[2:2 * m + 2:2]
        return 4.0 * xo - (xe - xe2) * torch.exp(xe - xo - xe2) - 3.0

    g_L, g_U = _lv_bounds(m, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=np.full(n, 3.0),
               name=_lv_name(6, n, equality))


def luksan_vlcek7(n: int, equality: bool = True) -> NLP:
    """LuksanVlcek7 (``ipopt_tpu/modellib.py:369-400``): chained
    trigonometric objective with linearly growing weights and four boundary
    constraints, x0 = 1.  n >= 5."""
    assert n >= 5
    N = n - 2

    def f(x):
        i = torch.arange(1, N + 1, device=x.device).to(x.dtype)
        return (i * ((1.0 - torch.cos(x[1:N + 1])) + torch.sin(x[0:N])
                     - torch.sin(x[2:N + 2]))).sum()

    def g(x):
        return torch.stack([
            4.0 * (x[1] - x[2] ** 2) + x[2] - x[3] ** 2,
            8.0 * x[2] * (x[2] ** 2 - x[1]) - 2.0 * (1.0 - x[2])
            + 4.0 * (x[2] - x[3] ** 2) + x[3] - x[4] ** 2,
            8.0 * x[N - 1] * (x[N - 1] ** 2 - x[N - 2])
            - 2.0 * (1.0 - x[N - 1]) + 4.0 * (x[N - 1] - x[N] ** 2)
            + x[N - 2] ** 2 - x[N - 3],
            8.0 * x[N] * (x[N] ** 2 - x[N - 1]) - 2.0 * (1.0 - x[N])
            + x[N - 1] ** 2 - x[N - 2]])

    g_L, g_U = _lv_bounds(4, equality)
    return NLP(f=f, g=g, g_L=g_L, g_U=g_U, x0=np.full(n, 1.0),
               name=_lv_name(7, n, equality))


# example -> (alpha, ub_y, lb_u, ub_u) of MittelmannBndryCntrlDiri 1-4
# (MittelmannBndryCntrlDiri.hpp:281-298, :329-346, :380-397, :432-448); all
# share d_const = -20 and y_d(x1, x2) = 3 + 5 x1 (x1 - 1) x2 (x2 - 1)
_MITTELMANN_EXAMPLES = {1: (0.01, 3.5, 0.0, 10.0), 2: (0.0, 3.5, 0.0, 10.0),
                        3: (0.01, 3.2, 1.6, 2.3), 4: (0.0, 3.2, 1.6, 2.3)}


def _bndry_grid(N: int, example: int):
    """(y_d, interior-term weights, control-term weights) on the (N+2)^2 grid."""
    alpha = _MITTELMANN_EXAMPLES[example][0]
    Ng = N + 2
    h = 1.0 / (N + 1)
    ij = np.arange(Ng) * h
    y_d = 3.0 + 5.0 * (ij[:, None] * (ij[:, None] - 1.0)
                       * ij[None, :] * (ij[None, :] - 1.0))
    interior = np.zeros((Ng, Ng), bool)
    interior[1:-1, 1:-1] = True
    return (y_d, np.where(interior, h * h / 2.0, 0.0),
            np.where(~interior, alpha * h / 2.0, 0.0), interior)


def _bndry_obj(rows, yd, wi, wc):
    return (wi * (rows - yd) ** 2).sum() + (wc * rows ** 2).sum()


def _bndry_f_stage(xk, xk1, theta):
    return _bndry_obj(xk.reshape(2, -1), theta["yd"], theta["wi"], theta["wc"])


def _bndry_g_stage(xk, xk1, theta):
    """The 5-point stencil rows centred in the two grid rows between the
    groups: 4 y_c - y_up - y_down - y_left - y_right."""
    w = torch.cat([xk.reshape(2, -1), xk1.reshape(2, -1)])

    def pde(up, c, dn):
        return 4.0 * c[1:-1] - up[1:-1] - dn[1:-1] - c[:-2] - c[2:]

    return torch.cat([pde(w[0], w[1], w[2]), pde(w[1], w[2], w[3])])


_BNDRY_LAST = {}


@dataclasses.dataclass(frozen=True)
class _BndryLast:
    """The objective terms of the last two grid rows (compared by value, so
    that two instances of one model share one ChainInfo)."""

    N: int
    example: int

    def __call__(self, xK):
        c = _BNDRY_LAST.get((self.N, self.example))
        if c is None:
            y_d, w_int, w_ctl, _ = _bndry_grid(self.N, self.example)
            c = _BNDRY_LAST[(self.N, self.example)] = tuple(
                DeviceConstant(a[-2:]) for a in (y_d, w_int, w_ctl))
        return _bndry_obj(xK.reshape(2, -1), *(t.like(xK) for t in c))


def mittelmann_bndry_control(N: int, example: int = 1) -> ChainedNLP:
    """MittelmannBndryCntrlDiri 1-4 (``ipopt_tpu/modellib.py:406-486``;
    examples/ScalableProblems/MittelmannBndryCntrlDiri.{hpp,cpp}): 2-D
    Poisson Dirichlet boundary control on the unit square,

        min  hh/2 sum_int (y_ij - y_d)^2 + alpha h/2 sum_bnd y^2
        s.t. 4 y_ij - y_{i-1,j} - y_{i+1,j} - y_{i,j-1} - y_{i,j+1}
                 = -hh d_const                 (interior i, j = 1..N)
             y_int <= ub_y,  lb_u <= y_bnd <= ub_u

    on an (N+2)^2 grid, h = 1/(N+1); the controls are the boundary values
    of y.  Chained over pairs of grid rows (group k = rows 2k, 2k+1), so the
    KKT is block-tridiagonal with v = 2(N+2) and 2N constraint rows per
    stage.  As in the reference, the four corners are bounded controls with
    the control weight.  Even N >= 2."""
    if N % 2 or N < 2:
        raise ValueError(f"need even N >= 2, got {N}")
    _, ub_y, lb_u, ub_u = _MITTELMANN_EXAMPLES[example]
    Ng = N + 2
    h = 1.0 / (N + 1)
    K = Ng // 2 - 1
    y_d, w_int, w_ctl, interior = _bndry_grid(N, example)
    theta = {name: np.stack([a[2 * k:2 * k + 2] for k in range(K)])
             for name, a in (("yd", y_d), ("wi", w_int), ("wc", w_ctl))}
    rhs = -(h * h) * -20.0  # -hh * d_const
    x_L = np.where(interior, -1e20, lb_u)
    x_U = np.where(interior, ub_y, ub_u)
    x0 = np.where(interior, y_d, 0.5 * (lb_u + ub_u))
    return ChainedNLP(
        f_stage=_bndry_f_stage, g_stage=_bndry_g_stage,
        f_last=_BndryLast(N, example), theta=theta, x0=x0.reshape(K + 1, 2 * Ng),
        g_L=np.full((K, 2 * N), rhs), g_U=np.full((K, 2 * N), rhs),
        x_L=x_L.reshape(K + 1, 2 * Ng), x_U=x_U.reshape(K + 1, 2 * Ng),
        name=f"mittelmann_bndry{example}_N{N}")


def _sqp_f_scen(x0, xs, th):
    return 0.5 * torch.sum((xs - th["t"]) ** 2)


def _sqp_g_scen(x0, xs, th):
    return torch.stack([x0[0] + torch.sum(xs)]) - th["b"]


def _sqp_f0(x0):
    return 0.5 * torch.sum(x0 ** 2)


def stochastic_qp(S: int = 4, ns: int = 3, seed: int = 0) -> ScenarioNLP:
    """Two-stage stochastic QP (``tests/test_scenario.py:11-38``):

        min 0.5 ||x0||^2 + sum_s 0.5 ||x_s - t_s||^2
        s.t. x0[0] + sum(x_s) = b_s  (one equality per scenario),  x_s >= -5

    with x0 of 2 entries and t (S, ns), b (S, 1) drawn from
    ``numpy.random.default_rng(seed)``; its scenario blocks are ns + 2 wide."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((S, ns))
    b = rng.standard_normal((S, 1))
    return ScenarioNLP(
        f_scen=_sqp_f_scen, g_scen=_sqp_g_scen, f0=_sqp_f0,
        x0_init=np.zeros(2), xs_init=np.zeros((S, ns)),
        g_L=np.zeros((S, 1)), g_U=np.zeros((S, 1)), xs_L=-5.0,
        theta={"t": t, "b": b}, name="stoch_qp")
