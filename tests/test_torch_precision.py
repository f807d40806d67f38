"""Mixed precision and the blocked dense LDL^T of the PyTorch port against
the JAX reference, on the CPU.

- The reference's four mixed-precision solves (tests/test_mixed_precision.py:
  23-60: float32 factorizations under a float64 iterate on the dense,
  chained and banded backends, and a float32 iterate with
  ``refinement_precision="double"``), HS071 with a float32 iterate and the
  3-D control at N = 6 with float32 fronts, against the reference's recorded
  results (``tools/torch_reference_values.py``): the same status,
  iterations, factorizations and KKT solves, objectives to rtol 1e-9.
- ``btd_cast``, the float32 dense factorization and the refinement against
  the float64 K, on seeded KKT matrices against the reference's functions.
- ``ldlt_blocked`` against the reference's at n = 300 (padded to 384) and
  n = 256 with blocks of 128, float64, to 1e-12; ``dense-ldlt-blocked`` on
  the 198-wide LuksanVlcek1 against the reference's recorded solve.
- On a card (``gpu``-marked, skipped here): K1 and K2 in float32 at this
  slice's shapes against their plain versions.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ipopt_tpu.linalg import ldlt as ref_ldlt
from ipopt_tpu.linalg import block_tridiag as ref_btd
from ipopt_tpu.algorithm import step as ref_step
from ipopt_tpu.options import Options as RefOptions

import ipopt_torch
from ipopt_torch.linalg import ldlt as port_ldlt
from ipopt_torch.linalg import block_tridiag as port_btd
from ipopt_torch.linalg.block_ldlt import block_ldlt, block_ldlt_plain
from ipopt_torch.linalg.block_ldlt_inv import block_ldlt_inv, block_ldlt_inv_plain
from ipopt_torch.algorithm import step as port_step
import torch_cases
from test_torch_adaptive import assert_matches_recorded
from test_torch_kernels import kkt_like

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", torch_cases.suite_cases("precision")
                         + ["blk_lv1d100"])
def test_matches_recorded_reference(name):
    _, rec = torch_cases.solve_port(name, {})
    assert_matches_recorded(name, rec)


def test_float32_iterate_keeps_its_dtype():
    res = ipopt_torch.solve(ipopt_torch.modellib.hs071(), device="cpu",
                            print_level=0, **torch_cases.F32IT)
    assert res.x.dtype == torch.float32 and res.iterate.y_c.dtype == torch.float32


def _btd(rng, B, nb, b):
    diag = rng.standard_normal((B, nb, b, b))
    diag = diag + diag.transpose(0, 1, 3, 2) + 4 * b * np.eye(b)
    return diag, rng.standard_normal((B, nb, b, b))


@pytest.mark.parametrize("dt", ["", "float32", "float64"])
def test_btd_cast_matches_reference(dt):
    diag, sub = _btd(np.random.default_rng(1), 1, 3, 5)
    ref = ref_btd.btd_cast(ref_btd.BTDMatrix(diag=jnp.asarray(diag[0]),
                                             sub=jnp.asarray(sub[0])), dt)
    port = port_btd.btd_cast(port_btd.BTDMatrix(diag=torch.as_tensor(diag),
                                                sub=torch.as_tensor(sub)), dt)
    for r, p in zip(ref, port):
        assert str(p.dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r))


def _kkt(seed, n=6, m=3, B=1):
    return kkt_like(np.random.default_rng(seed), B, n + m)


@pytest.mark.parametrize("scaling", ["none", "mc19"])
def test_float32_factorization_and_double_refinement(scaling):
    """The dense factor in float32 (after mc19) as the reference's, to float32
    rounding (the two loops round in another order: rtol 1e-5 of the
    largest entry); the refined solution against the float64 K to 1e-12."""
    K = _kkt(3)
    rhs = np.random.default_rng(4).standard_normal(K.shape[:2])
    kw = dict(factorization_dtype="float32", linear_system_scaling=scaling,
              refinement_precision="double")
    ro, po = RefOptions(**kw), ipopt_torch.Options(**kw)
    rf = ref_step._factorize(jnp.asarray(K[0]), ro)
    pf = port_step._factorize(torch.as_tensor(K), po)
    assert pf.L.dtype == torch.float32 and str(rf.L.dtype) == "float32"
    for r, p in ((rf.L, pf.L), (rf.d, pf.d)):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(p[0].double().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    assert (int(pf.num_pos[0]), int(pf.num_neg[0])) == (int(rf.num_pos),
                                                        int(rf.num_neg))
    rs, rr = ref_step.solve_with_refinement(jnp.asarray(K[0]), rf,
                                            jnp.asarray(rhs[0]), ro)
    ps, pr = port_step.solve_with_refinement(torch.as_tensor(K), pf,
                                             torch.as_tensor(rhs), po)
    assert ps.dtype == torch.float64
    np.testing.assert_allclose(ps[0].numpy(), np.asarray(rs), rtol=1e-12, atol=1e-12)


def test_chained_refinement_in_double_against_float32_factor():
    from ipopt_tpu.algorithm.chained_kkt import chained_solve_refined as ref_csr
    from ipopt_torch.algorithm.chained_kkt import chained_solve_refined as port_csr
    diag, sub = _btd(np.random.default_rng(5), 1, 4, 6)
    rhs = np.random.default_rng(6).standard_normal((1, 24))
    kw = dict(factorization_dtype="float32", refinement_precision="double")
    Kr = ref_btd.BTDMatrix(diag=jnp.asarray(diag[0]), sub=jnp.asarray(sub[0]))
    Kp = port_btd.BTDMatrix(diag=torch.as_tensor(diag), sub=torch.as_tensor(sub))
    rf = ref_btd.bcr_factorize(ref_btd.btd_cast(Kr, "float32"))
    pf = port_btd.bcr_factorize(port_btd.btd_cast(Kp, "float32"))
    rs, _ = ref_csr(Kr, rf, jnp.asarray(rhs[0]), RefOptions(**kw))
    ps, _ = port_csr(Kp, pf, torch.as_tensor(rhs), ipopt_torch.Options(**kw))
    np.testing.assert_allclose(ps[0].numpy(), np.asarray(rs), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [300, 256])
def test_ldlt_blocked_matches_reference(n):
    """n = 300 pads to 384 with identity; both keep the panel order."""
    A = kkt_like(np.random.default_rng(n), 1, n)[0]
    A = A + np.diag(np.where(np.arange(n) < n // 2, 2.0 * n, -2.0 * n))
    ref = ref_ldlt.ldlt_blocked(jnp.asarray(A), block=128)
    port = port_ldlt.ldlt_blocked(torch.as_tensor(A[None]), block=128)
    L, d = np.asarray(ref.L), np.asarray(ref.d)
    np.testing.assert_allclose(port.L[0].numpy(), L, rtol=0, atol=1e-12 * np.abs(L).max())
    np.testing.assert_allclose(port.d[0].numpy(), d, rtol=0, atol=1e-12 * np.abs(d).max())
    assert (int(port.num_pos[0]), int(port.num_neg[0]), int(port.num_zero[0])) == (
        int(ref.num_pos), int(ref.num_neg), int(ref.num_zero))


def test_ldlt_blocked_narrow_is_ldlt():
    A = torch.as_tensor(_kkt(8))
    a, b = port_ldlt.ldlt_blocked(A, block=128), port_ldlt.ldlt(A)
    assert torch.equal(a.L, b.L) and torch.equal(a.d, b.d)


# -- on the card: K1 and K2 in float32 at this slice's shapes ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("nb,b", [(512, 7), (1, 128), (4, 128), (2, 787)])
def test_k1_float32_equals_plain_on_cuda(cuda, nb, b):
    """K1 equals its plain version bit for bit in float32 too (NaN in the
    same places), on KKT-shaped blocks with a zero pivot."""
    A = torch.as_tensor(kkt_like(np.random.default_rng(b), nb, b),
                        dtype=torch.float32, device=cuda)
    L, d = block_ldlt(A)
    Lp, dp = block_ldlt_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(L), torch.nan_to_num(Lp))
    assert torch.equal(torch.nan_to_num(d), torch.nan_to_num(dp))


@pytest.mark.gpu
@pytest.mark.parametrize("nb,b", [(6250, 16), (64, 156)])
def test_k2_float32_on_cuda(cuda, nb, b):
    """K2 in float32: b <= 32 bit for bit; above, IEEE FFMA panel products
    in another order, so the inverse to 1e-4 of max(1, max|Ainv|) and
    the pivots' signs equal, on quasi-definite blocks."""
    from test_torch_gj_panel import quasi_definite_kkt
    rng = np.random.default_rng(b)
    A = kkt_like(rng, nb, b) if b <= 32 else quasi_definite_kkt(rng, nb, b)
    A = torch.as_tensor(A, dtype=torch.float32, device=cuda)
    assert not torch.backends.cuda.matmul.allow_tf32
    d, Ainv = block_ldlt_inv(A)
    dp, Ap = block_ldlt_inv_plain(A)
    torch.cuda.synchronize()
    if b <= 32:
        assert torch.equal(torch.nan_to_num(d), torch.nan_to_num(dp))
        assert torch.equal(torch.nan_to_num(Ainv), torch.nan_to_num(Ap))
    else:
        assert torch.equal(torch.sign(d), torch.sign(dp))
        scale = torch.clamp(Ap.abs().amax(), min=1.0)
        assert float((Ainv - Ap).abs().amax() / scale) < 1e-4
