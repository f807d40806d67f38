"""Plain NumPy reference of MittelmannDistCntrlNeumA1, written from the
problem's statement (see ``problems/neuma1.py`` for it) and sharing no code
with the program or with the benchmark's builder: the functions, their first
derivatives as products with vectors, the Lagrangian Hessian, and the
absolute row sums that norms of the KKT matrix need.  Float64 throughout;
x = [Y ((N+2)^2, row-major) | U (N^2)]; the constraints are the N^2 interior
rows, then N rows for each side j = 0, j = N+1, i = 0, i = N+1.
"""
from __future__ import annotations

import numpy as np


class Problem:
    def __init__(self, cfg):
        self.N = N = int(cfg["N"])
        self.alpha = float(cfg["alpha"])
        self.h = 1.0 / (N + 1)
        self.hh = self.h ** 2
        self.nb = 1.0 + self.h * float(cfg["b"])      # the Neumann rows' own coefficient
        self.Ng = N + 2
        self.ny = self.Ng ** 2
        self.n = self.ny + N * N
        self.m = N * N + 4 * N
        t = np.sin(2.0 * np.pi * np.arange(1, N + 1) / (N + 1))
        self.yd = np.outer(t, t)
        self.x_L = np.concatenate([np.full(self.ny, -np.inf),
                                   np.full(N * N, float(cfg["u_lower"]))])
        self.x_U = np.concatenate([np.full(self.ny, float(cfg["y_upper"])),
                                   np.full(N * N, float(cfg["u_upper"]))])

    # the sides, each as (boundary points, their inside neighbours) of the grid
    def _sides(self, Y):
        return [(Y[1:-1, 0], Y[1:-1, 1]), (Y[1:-1, -1], Y[1:-1, -2]),
                (Y[0, 1:-1], Y[1, 1:-1]), (Y[-1, 1:-1], Y[-2, 1:-1])]

    def _split(self, x):
        return x[:self.ny].reshape(self.Ng, self.Ng), x[self.ny:].reshape(self.N, self.N)

    def _jdiag(self, x):
        Y, _ = self._split(x)
        return 4.0 - self.hh * np.exp(Y[1:-1, 1:-1])

    def f(self, x):
        Y, U = self._split(x)
        return self.hh * 0.5 * float(np.sum((Y[1:-1, 1:-1] - self.yd) ** 2
                                            + self.alpha * U ** 2))

    def grad_f(self, x):
        Y, U = self._split(x)
        G = np.zeros_like(Y)
        G[1:-1, 1:-1] = self.hh * (Y[1:-1, 1:-1] - self.yd)
        return np.concatenate([G.reshape(-1), (self.hh * self.alpha * U).reshape(-1)])

    def c(self, x):
        Y, U = self._split(x)
        yc = Y[1:-1, 1:-1]
        pde = (4.0 * yc - Y[:-2, 1:-1] - Y[2:, 1:-1] - Y[1:-1, :-2] - Y[1:-1, 2:]
               + self.hh * (-np.exp(yc) - U))
        return np.concatenate([pde.reshape(-1)]
                              + [self.nb * bnd - adj for bnd, adj in self._sides(Y)])

    def jac_v(self, x, v):
        VY, VU = self._split(v)
        pde = (self._jdiag(x) * VY[1:-1, 1:-1] - VY[:-2, 1:-1] - VY[2:, 1:-1]
               - VY[1:-1, :-2] - VY[1:-1, 2:] - self.hh * VU)
        return np.concatenate([pde.reshape(-1)]
                              + [self.nb * bnd - adj for bnd, adj in self._sides(VY)])

    def _jac_t(self, d, w, nbr, nb, hh):
        """J^T w with the entries (d the interior diagonal, nbr each
        neighbour's, nb a side's boundary entry, -1 or 1 for its inside
        neighbour by the sign of nbr, hh the control's magnitude)."""
        N = self.N
        wi = w[:N * N].reshape(N, N)
        G = np.zeros((self.Ng, self.Ng))
        G[1:-1, 1:-1] += d * wi
        G[:-2, 1:-1] += nbr * wi
        G[2:, 1:-1] += nbr * wi
        G[1:-1, :-2] += nbr * wi
        G[1:-1, 2:] += nbr * wi
        ws = w[N * N:].reshape(4, N)
        G[1:-1, 0] += nb * ws[0]
        G[1:-1, 1] += nbr * ws[0]
        G[1:-1, -1] += nb * ws[1]
        G[1:-1, -2] += nbr * ws[1]
        G[0, 1:-1] += nb * ws[2]
        G[1, 1:-1] += nbr * ws[2]
        G[-1, 1:-1] += nb * ws[3]
        G[-2, 1:-1] += nbr * ws[3]
        return np.concatenate([G.reshape(-1), (hh * wi).reshape(-1)])

    def jac_t_v(self, x, w):
        return self._jac_t(self._jdiag(x), w, -1.0, self.nb, -self.hh)

    def jac_t_v_abs(self, x, w):
        """|J|^T w."""
        return self._jac_t(np.abs(self._jdiag(x)), w, 1.0, abs(self.nb), self.hh)

    def jac_abs_rowsum(self, x):
        return np.concatenate([(np.abs(self._jdiag(x)) + 4.0 + self.hh).reshape(-1),
                               np.full(4 * self.N, abs(self.nb) + 1.0)])

    def jac_row_absmax(self, x):
        inner = np.maximum(np.maximum(np.abs(self._jdiag(x)), 1.0), self.hh)
        return np.concatenate([inner.reshape(-1), np.full(4 * self.N, max(abs(self.nb), 1.0))])

    def hess_diag(self, x, sf, lam):
        """Diagonal of sf * Hess f + sum_j lam_j Hess c_j (the Hessian is
        diagonal; the boundary's y appear in no second derivative)."""
        Y, _ = self._split(x)
        N = self.N
        D = np.zeros((self.Ng, self.Ng))
        D[1:-1, 1:-1] = self.hh * (sf - np.exp(Y[1:-1, 1:-1]) * lam[:N * N].reshape(N, N))
        return np.concatenate([D.reshape(-1), np.full(N * N, sf * self.hh * self.alpha)])

    def hess_offdiag_abs_rowsum(self, x, sf, lam):
        return np.zeros(self.n)

    def hess_v(self, x, sf, lam, v):
        return self.hess_diag(x, sf, lam) * v
