"""Model library of the port: the HS071 problem and the family the batched
benchmark solves (``bench.py:121-133``), LuksanVlcek1 as a plain NLP for the
dense backend (``tests/problems.py:146``), and the chained LuksanVlcek1 and
1-D boundary-control problems (``bench.py:302-314``, ``tests/test_chained.py``).
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
