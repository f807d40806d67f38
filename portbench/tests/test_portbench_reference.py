"""The plain references against automatic differentiation of the
benchmark's own builders, at test size: the same functions and derivatives."""
import numpy as np
import pytest
import torch

from portbench.problems import lv1, neuma1
from portbench.reference import lv1 as ref_lv1, neuma1 as ref_neuma1

CASES = [
    (neuma1, ref_neuma1, {"N": 3, "alpha": 0.001, "b": 1.0, "y_upper": 0.371,
                          "u_lower": -8.0, "u_upper": 9.0}),
    (lv1, ref_lv1, {"n": 9}),
]


@pytest.mark.parametrize("builder, reference, cfg", CASES, ids=["neuma1", "lv1"])
def test_reference_matches_autograd(builder, reference, cfg):
    rng = np.random.default_rng(0)
    x0, _, _ = builder.start(cfg)
    x = x0 + 0.3 * rng.uniform(-1, 1, x0.shape)
    nlp = builder.build(cfg, x0)
    R = reference.Problem(cfg)
    xt = torch.tensor(x, dtype=torch.float64)
    assert R.f(x) == pytest.approx(float(nlp.f(xt)), rel=1e-13)
    np.testing.assert_allclose(R.c(x), nlp.g(xt).numpy(), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(R.grad_f(x), torch.func.grad(nlp.f)(xt).numpy(),
                               rtol=1e-12, atol=1e-14)
    J = torch.func.jacfwd(nlp.g)(xt).numpy()
    v = rng.standard_normal(R.n)
    w = rng.standard_normal(R.m)
    np.testing.assert_allclose(R.jac_v(x, v), J @ v, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(R.jac_t_v(x, w), J.T @ w, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(R.jac_t_v_abs(x, np.abs(w)), np.abs(J).T @ np.abs(w),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(R.jac_abs_rowsum(x), np.abs(J).sum(1), rtol=1e-12)
    np.testing.assert_allclose(R.jac_row_absmax(x), np.abs(J).max(1), rtol=1e-12)
    sf, lam = 0.37, rng.standard_normal(R.m)
    lamt = torch.tensor(lam)
    H = torch.func.hessian(lambda z: sf * nlp.f(z) + (lamt * nlp.g(z)).sum())(xt).numpy()
    np.testing.assert_allclose(R.hess_v(x, sf, lam, v), H @ v, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(R.hess_diag(x, sf, lam), np.diag(H), rtol=1e-11, atol=1e-12)
    off = np.abs(H - np.diag(np.diag(H))).sum(1)
    np.testing.assert_allclose(R.hess_offdiag_abs_rowsum(x, sf, lam), off, rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_array_equal(R.x_L, np.where(np.isfinite(R.x_L), nlp.x_L, -np.inf))
    np.testing.assert_array_equal(R.x_U, np.where(np.isfinite(R.x_U), nlp.x_U, np.inf))
