"""Plain PyTorch reference of MittelmannBndryCntrlDiri3D, written from the
problem's statement (see ``problems/diri3d.py`` for it) and sharing no code
with the program or with the benchmark's builder: the functions, their first
derivatives as products with vectors, the Lagrangian Hessian, and the
absolute row sums that norms of the KKT matrix need.  Float64 on the CPU;
NumPy arrays in and out.  x = y over the (N+2)^3 grid, row-major in
(i, j, k); constraint r is the 7-point Laplacian row of the r-th interior
point, row-major, minus its right-hand side -h^2 d_const.  The constraints
are linear, so the Lagrangian Hessian is the objective's, a constant
diagonal: h^3 inside, alpha h^2 on the boundary.
"""
from __future__ import annotations

import numpy as np
import torch

# the six neighbours of a point, as offsets in (i, j, k)
_NEIGHBOURS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


class Problem:
    def __init__(self, cfg):
        self.N = N = int(cfg["N"])
        self.Ng = Ng = N + 2
        self.h = h = 1.0 / (N + 1)
        self.n = Ng ** 3
        self.m = N ** 3
        self.rhs = -h * h * float(cfg["d_const"])
        inside = torch.zeros((Ng, Ng, Ng), dtype=torch.bool)
        inside[1:-1, 1:-1, 1:-1] = True
        self.inside = inside
        t = torch.arange(Ng, dtype=torch.float64) * h
        p = t * (t - 1.0)
        self.yd = 3.0 + 5.0 * p[:, None, None] * p[None, :, None] * p[None, None, :]

        def grid(a_inside, a_bnd):
            return torch.where(inside, _t(a_inside), _t(a_bnd)).reshape(-1)

        self.hdiag = grid(h ** 3, float(cfg["alpha"]) * h * h)
        self.x_L = grid(-np.inf, float(cfg["u_lower"])).numpy()
        self.x_U = grid(float(cfg["y_upper"]), float(cfg["u_upper"])).numpy()

    def _grid(self, v):
        return _t(v).reshape(self.Ng, self.Ng, self.Ng)

    def _shift(self, Y, d):
        """Y at the interior points moved by the offset d."""
        N = self.N
        return Y[1 + d[0]:1 + d[0] + N, 1 + d[1]:1 + d[1] + N, 1 + d[2]:1 + d[2] + N]

    def _lap(self, Y, centre, nbr):
        """centre * Y_ijk + nbr * (sum of the six neighbours), interior rows."""
        out = centre * Y[1:-1, 1:-1, 1:-1]
        for d in _NEIGHBOURS:
            out = out + nbr * self._shift(Y, d)
        return out.reshape(-1)

    def _lap_t(self, w, centre, nbr):
        """The transpose of ``_lap``: row r's weight w_r spread to its centre
        and its neighbours on the grid."""
        N, G = self.N, torch.zeros((self.Ng,) * 3, dtype=torch.float64)
        W = _t(w).reshape(N, N, N)
        G[1:-1, 1:-1, 1:-1] += centre * W
        for d in _NEIGHBOURS:
            self._shift(G, d).add_(nbr * W)
        return G.reshape(-1).numpy()

    def f(self, x):
        Y = self._grid(x)
        dev = (Y - self.yd)[self.inside]
        ctl = Y[~self.inside]
        wc = self.hdiag.reshape(self.Ng, self.Ng, self.Ng)[~self.inside]
        return float(self.h ** 3 / 2.0 * (dev ** 2).sum() + (wc / 2.0 * ctl ** 2).sum())

    def grad_f(self, x):
        Y = self._grid(x)
        G = torch.where(self.inside, Y - self.yd, Y).reshape(-1)
        return (self.hdiag * G).numpy()

    def c(self, x):
        return (self._lap(self._grid(x), 6.0, -1.0) - self.rhs).numpy()

    def jac_v(self, x, v):
        return self._lap(self._grid(v), 6.0, -1.0).numpy()

    def jac_t_v(self, x, w):
        return self._lap_t(w, 6.0, -1.0)

    def jac_t_v_abs(self, x, w):
        """|J|^T w."""
        return self._lap_t(w, 6.0, 1.0)

    def jac_abs_rowsum(self, x):
        return np.full(self.m, 12.0)

    def jac_row_absmax(self, x):
        return np.full(self.m, 6.0)

    def hess_diag(self, x, sf, lam):
        """Diagonal of sf * Hess f + sum_j lam_j Hess c_j; the constraints are
        linear, so lam does not enter."""
        return (sf * self.hdiag).numpy()

    def hess_offdiag_abs_rowsum(self, x, sf, lam):
        return np.zeros(self.n)

    def hess_v(self, x, sf, lam, v):
        return (sf * self.hdiag * _t(v)).numpy()
