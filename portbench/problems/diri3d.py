"""MittelmannBndryCntrlDiri3D (Ipopt's examples/ScalableProblems/
MittelmannBndryCntrlDiri3D.cpp) as the port's ``NLP``: the benchmark's own
frozen copy, so that a change to the program's model library never changes
the yardstick.  3-D Poisson Dirichlet boundary control on the unit cube, an
(N+2)^3 grid, h = 1 / (N + 1), the controls being the boundary values of y:

    min  h^3/2 sum_interior (y_ijk - y_d)^2 + alpha h^2/2 sum_boundary y^2
    s.t. 6 y_ijk - y_{i+-1,j,k} - y_{i,j+-1,k} - y_{i,j,k+-1}
             = -h^2 d_const                      (N^3 interior points)
         y_interior <= y_upper,  u_lower <= y_boundary <= u_upper

with y_d = 3 + 5 x1 (x1 - 1) x2 (x2 - 1) x3 (x3 - 1); x = y over the whole
grid, row-major in (i, j, k).  Edges and corners are boundary points: they
enter no PDE row, only the control term and its bounds.  The Jacobian's
pattern and the diagonal Hessian are declared, as the multifrontal backend
needs them.
"""
from __future__ import annotations

import numpy as np

from ipopt_torch import NLP
from ipopt_torch.types import DeviceConstant


def _interior(N):
    Ng = N + 2
    inside = np.zeros((Ng, Ng, Ng), bool)
    inside[1:-1, 1:-1, 1:-1] = True
    return inside.reshape(-1)


def start(cfg):
    """(x0, x_L, x_U) of the starting point, y = y_d inside and (u_lower +
    u_upper) / 2 on the boundary."""
    N = int(cfg["N"])
    inside = _interior(N)
    lo, hi = float(cfg["u_lower"]), float(cfg["u_upper"])
    x0 = np.full(inside.shape, 0.5 * (lo + hi))
    x0[inside] = desired_state(N)
    x_L = np.where(inside, -1e20, lo)
    x_U = np.where(inside, float(cfg["y_upper"]), hi)
    return x0, x_L, x_U


def desired_state(N):
    """y_d at the interior points, row-major."""
    t = np.arange(1, N + 1) / (N + 1)
    q = t * (t - 1.0)
    return (3.0 + 5.0 * q[:, None, None] * q[None, :, None] * q[None, None, :]).reshape(-1)


def jacobian_pattern(N):
    """(rows, cols) of the constraints' Jacobian: row r is the interior point
    r in row-major order, with its centre and its six neighbours."""
    Ng = N + 2
    Y = np.arange(Ng ** 3, dtype=np.int32).reshape(Ng, Ng, Ng)
    c = slice(1, -1)
    cols = [Y[c, c, c], Y[:-2, c, c], Y[2:, c, c], Y[c, :-2, c], Y[c, 2:, c],
            Y[c, c, :-2], Y[c, c, 2:]]
    rows = np.arange(N ** 3, dtype=np.int32)
    return (np.concatenate([rows] * len(cols)),
            np.concatenate([a.reshape(-1) for a in cols]).astype(np.int32))


def build(cfg, x0):
    """The ``NLP`` of the configuration ``cfg`` from the starting point x0."""
    N = int(cfg["N"])
    Ng = N + 2
    h = 1.0 / (N + 1)
    _, x_L, x_U = start(cfg)
    yd = DeviceConstant(desired_state(N))
    w_ctl = DeviceConstant(np.where(_interior(N), 0.0, float(cfg["alpha"]) * h * h / 2.0))

    def f(x):
        y = x.reshape(Ng, Ng, Ng)[1:-1, 1:-1, 1:-1].reshape(-1)
        return h ** 3 / 2.0 * ((y - yd.like(x)) ** 2).sum() + (w_ctl.like(x) * x ** 2).sum()

    def g(x):
        Y = x.reshape(Ng, Ng, Ng)
        return (6.0 * Y[1:-1, 1:-1, 1:-1]
                - Y[:-2, 1:-1, 1:-1] - Y[2:, 1:-1, 1:-1]
                - Y[1:-1, :-2, 1:-1] - Y[1:-1, 2:, 1:-1]
                - Y[1:-1, 1:-1, :-2] - Y[1:-1, 1:-1, 2:]).reshape(-1)

    m = N ** 3
    rhs = np.full(m, -h * h * float(cfg["d_const"]))
    diag = np.arange(Ng ** 3, dtype=np.int32)
    return NLP(f=f, g=g, x0=x0, x_L=x_L, x_U=x_U, g_L=rhs, g_U=rhs,
               jac_g_sparsity=jacobian_pattern(N), lag_hess_sparsity=(diag, diag),
               name=f"diri3d_N{N}")
