"""MittelmannDistCntrlNeumA1 (Ipopt's examples/ScalableProblems/
MittelmannDistCntrlNeumA.cpp) as the port's ``NLP``: the benchmark's own
frozen copy, so that a change to the program's model library never changes
the yardstick.  2-D elliptic distributed control with Neumann boundary
conditions on the unit square, an (N+2) x (N+2) grid, h = 1 / (N + 1):

    min  hh sum_interior 0.5 ((y_ij - yd_ij)^2 + alpha u_ij^2)
    s.t. 4 y_ij - y_{i-1,j} - y_{i+1,j} - y_{i,j-1} - y_{i,j+1}
             + hh (-exp(y_ij) - u_ij) = 0            (N^2 interior points)
         (1 + h b) y_bnd - y_adj = 0                 (4 N boundary points)
         y <= 0.371,  -8 <= u <= 9

with yd = sin(2 pi x1) sin(2 pi x2), alpha = 0.001, b = 1; x = [Y ((N+2)^2,
row-major) | U (N^2)].  The Jacobian's pattern and the diagonal Hessian are
declared, as the multifrontal backend needs them.
"""
from __future__ import annotations

import numpy as np
import torch

from ipopt_torch import NLP
from ipopt_torch.types import DeviceConstant


def start(cfg):
    """(x0, x_L, x_U) of the published starting point, y = 0 and u = (lb_u +
    ub_u) / 2."""
    N = int(cfg["N"])
    ny, nu = (N + 2) ** 2, N * N
    lo, hi = float(cfg["u_lower"]), float(cfg["u_upper"])
    x0 = np.concatenate([np.zeros(ny), np.full(nu, 0.5 * (lo + hi))])
    x_L = np.concatenate([np.full(ny, -1e20), np.full(nu, lo)])
    x_U = np.concatenate([np.full(ny, float(cfg["y_upper"])), np.full(nu, hi)])
    return x0, x_L, x_U


def desired_state(N):
    s = np.sin(2.0 * np.pi * np.arange(1, N + 1) / (N + 1))
    return (s[:, None] * s[None, :]).reshape(-1)


def jacobian_pattern(N):
    """(rows, cols) of the constraints' Jacobian: the N^2 interior rows in
    row-major order, then the sides j = 0, j = N+1, i = 0, i = N+1."""
    Ng = N + 2
    ny = Ng * Ng
    Y = np.arange(ny, dtype=np.int32).reshape(Ng, Ng)
    r_int = np.arange(N * N, dtype=np.int32)
    rows = [r_int] * 6
    cols = [Y[1:-1, 1:-1], Y[:-2, 1:-1], Y[2:, 1:-1], Y[1:-1, :-2], Y[1:-1, 2:],
            ny + r_int]
    side = [(Y[1:-1, 0], Y[1:-1, 1]), (Y[1:-1, -1], Y[1:-1, -2]),
            (Y[0, 1:-1], Y[1, 1:-1]), (Y[-1, 1:-1], Y[-2, 1:-1])]
    for k, (bnd, adj) in enumerate(side):
        r = N * N + k * N + np.arange(N, dtype=np.int32)
        rows += [r, r]
        cols += [bnd, adj]
    return (np.concatenate([np.ravel(r) for r in rows]).astype(np.int32),
            np.concatenate([np.ravel(c) for c in cols]).astype(np.int32))


def build(cfg, x0):
    """The ``NLP`` of the configuration ``cfg`` from the starting point x0."""
    N = int(cfg["N"])
    alpha, b = float(cfg["alpha"]), float(cfg["b"])
    Ng = N + 2
    h = 1.0 / (N + 1)
    hh = h * h
    ny = Ng * Ng
    _, x_L, x_U = start(cfg)
    yd = DeviceConstant(desired_state(N))

    def f(x):
        y = x[:ny].reshape(Ng, Ng)[1:-1, 1:-1].reshape(-1)
        u = x[ny:]
        return hh * (0.5 * ((y - yd.like(x)) ** 2 + alpha * u ** 2)).sum()

    def g(x):
        Y = x[:ny].reshape(Ng, Ng)
        u = x[ny:].reshape(N, N)
        yc = Y[1:-1, 1:-1]
        pde = (4.0 * yc - Y[:-2, 1:-1] - Y[2:, 1:-1] - Y[1:-1, :-2] - Y[1:-1, 2:]
               + hh * (-torch.exp(yc) - u))
        sides = [(1.0 + h * b) * Y[1:-1, 0] - Y[1:-1, 1],
                 (1.0 + h * b) * Y[1:-1, -1] - Y[1:-1, -2],
                 (1.0 + h * b) * Y[0, 1:-1] - Y[1, 1:-1],
                 (1.0 + h * b) * Y[-1, 1:-1] - Y[-2, 1:-1]]
        return torch.cat([pde.reshape(-1)] + sides)

    m = N * N + 4 * N
    diag = np.arange(ny + N * N, dtype=np.int32)
    return NLP(f=f, g=g, x0=x0, x_L=x_L, x_U=x_U, g_L=np.zeros(m), g_U=np.zeros(m),
               jac_g_sparsity=jacobian_pattern(N), lag_hess_sparsity=(diag, diag),
               name=f"neuma1_N{N}")
