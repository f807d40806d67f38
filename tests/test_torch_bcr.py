"""K2 and the block cyclic reduction of the PyTorch port
(ipopt_torch/linalg/block_ldlt_inv.py, block_tridiag.py) against the
reference, and the port's import boundary.

Tolerances:
- K2's plain version against the Pallas kernel in interpret mode and
  ``_gj_inv_lanes``: float64 atol 1e-12 (the arithmetic is the same step for
  step; in practice they are equal bit for bit), float32 rtol 1e-5; pivot
  signs equal on live pivots.
- against the panelized ``_gj_inv_lanes_blocked`` (what the reference's BCR
  runs above b = 32): atol 1e-12 on the inverse, rtol 1e-9 on the pivots,
  the bounds tests/test_block_tridiag.py accepts between the two sweeps.
- BCR: inertia counts exactly equal, solutions rtol 1e-10 (the block
  products sum in another order).
- the kernel against its plain version on the card: exactly equal for
  b <= 32; above, 1e-11 on the inverse and 1e-10 on the pivots (the panel
  products on the tensor cores sum in another order).
"""
import ast
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ipopt_tpu.linalg.pallas_ldlt import pallas_block_ldlt_inv
from ipopt_tpu.linalg import block_tridiag as ref_bt

from ipopt_torch.linalg import block_tridiag as port_bt
from ipopt_torch.linalg.block_ldlt_inv import block_ldlt_inv, block_ldlt_inv_plain
from test_torch_kernels import kkt_like
from test_torch_gj_panel import quasi_definite_kkt
from test_block_tridiag import make_btd

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b", [1, 8, 16, 33])
def test_plain_matches_pallas_and_gj_lanes(b, dtype):
    A = kkt_like(np.random.default_rng(b), 4, b).astype(dtype)
    _, d_pl, inv_pl = pallas_block_ldlt_inv(jnp.asarray(A), interpret=True)
    inv_gj, d_gj = ref_bt._gj_inv_lanes(jnp.asarray(A.transpose(1, 2, 0)))
    d, Ainv = block_ldlt_inv_plain(torch.as_tensor(A))
    d, Ainv = d.numpy(), Ainv.numpy()
    for d_r, inv_r in ((np.asarray(d_pl), np.asarray(inv_pl)),
                       (np.asarray(d_gj).T, np.asarray(inv_gj).transpose(2, 0, 1))):
        if dtype == "float64":
            np.testing.assert_allclose(d, d_r, rtol=0, atol=1e-12)
            np.testing.assert_allclose(Ainv, inv_r, rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(d, d_r, rtol=1e-5, atol=1e-5 * np.abs(d_r).max())
            np.testing.assert_allclose(Ainv, inv_r, rtol=1e-5,
                                       atol=1e-5 * np.abs(inv_r).max())
        live = np.abs(d_r) > np.finfo(dtype).eps * np.maximum(
            np.abs(d_r).max(-1, keepdims=True), 1.0)
        np.testing.assert_array_equal(np.sign(d)[live], np.sign(d_r)[live])
    if b > 1:
        assert (~live[0]).any()  # block 0's exactly zero pivot hit the guard


def test_plain_matches_blocked_gj_at_48():
    rng = np.random.default_rng(0)
    b = 48
    A = rng.standard_normal((5, b, b))
    A = A + A.transpose(0, 2, 1) + np.eye(b) * (2 * b)
    inv_r, d_r = ref_bt._gj_inv_lanes_blocked(jnp.asarray(A.transpose(1, 2, 0)))
    d, Ainv = block_ldlt_inv_plain(torch.as_tensor(A))
    np.testing.assert_allclose(Ainv.numpy(), np.asarray(inv_r).transpose(2, 0, 1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r).T, rtol=1e-9)


def _port_btd(Ks):
    return port_bt.BTDMatrix(
        torch.as_tensor(np.stack([np.asarray(K.diag) for K in Ks])),
        torch.as_tensor(np.stack([np.asarray(K.sub) for K in Ks])))


@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("nb", [1, 2, 3, 7, 8, 13])
def test_bcr_matches_reference(nb, b, equilibrate):
    """Two lanes of random quasi-definite BTD matrices (different negative
    tails), factored in one batched call; each lane equals the reference."""
    Ks = [make_btd(nb, b, seed=nb * 10 + b + lane, neg_tail=lane + 1)
          for lane in range(2)]
    rhs = np.random.default_rng(nb + b).standard_normal((2, nb * b))
    fac = port_bt.bcr_factorize(_port_btd(Ks), equilibrate=equilibrate)
    x = port_bt.bcr_solve(fac, torch.as_tensor(rhs)).numpy()
    for lane, K in enumerate(Ks):
        fr = ref_bt.bcr_factorize(K, equilibrate=equilibrate)
        xr = np.asarray(ref_bt.bcr_solve(fr, jnp.asarray(rhs[lane])))
        for k in ("num_pos", "num_neg", "num_zero", "singular"):
            assert int(getattr(fac, k)[lane]) == int(getattr(fr, k)), k
        np.testing.assert_allclose(x[lane], xr, rtol=1e-10, atol=1e-12)
    assert int(fac.num_neg[1]) > int(fac.num_neg[0])  # the lanes differ


def test_btd_matvec_and_dense_match_reference():
    K = make_btd(5, 4, seed=3)
    Kp = _port_btd([K])
    x = np.random.default_rng(2).standard_normal(20)
    np.testing.assert_allclose(Kp.matvec(torch.as_tensor(x)[None])[0].numpy(),
                               np.asarray(K.matvec(jnp.asarray(x))), rtol=1e-13)
    np.testing.assert_array_equal(Kp.to_dense()[0].numpy(), np.asarray(K.to_dense()))


def test_inertia_counts_per_lane_with_nan_pivot():
    rng = np.random.default_rng(4)
    ds = rng.standard_normal((2, 3, 5))
    ds[0, 1, 2] = np.nan
    ds[1, 2, 0] = 0.0
    p, n, z = port_bt._block_inertia_counts(torch.as_tensor(ds), 0.0)
    for lane in range(2):
        ref = ref_bt._block_inertia_counts(jnp.asarray(ds[lane].T), 0.0, block_axis=0)
        assert (int(p[lane]), int(n[lane]), int(z[lane])) == tuple(int(r) for r in ref)
    assert int(z[0]) == 1 and int(z[1]) == 1  # NaN counts as a zero pivot
    assert int(p[0] + n[0] + z[0]) == 15


def test_bcr_nan_block_is_singular():
    K = make_btd(4, 4, seed=1)
    diag = np.stack([np.asarray(K.diag)] * 2)
    diag[0, 1, 2, 2] = np.nan
    fac = port_bt.bcr_factorize(port_bt.BTDMatrix(
        torch.as_tensor(diag), torch.as_tensor(np.stack([np.asarray(K.sub)] * 2))))
    assert fac.singular.tolist() == [True, False]


def test_wrapper_cpu_path_and_bad_inputs():
    A = torch.as_tensor(kkt_like(np.random.default_rng(2), 3, 5))
    before = block_ldlt_inv.launches
    d, Ainv = block_ldlt_inv(A)
    d_p, Ainv_p = block_ldlt_inv_plain(A)
    assert torch.equal(d, d_p) and torch.equal(Ainv, Ainv_p)
    assert block_ldlt_inv.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError):
        block_ldlt_inv(A[:, :, :4])
    with pytest.raises(ValueError):
        block_ldlt_inv(A[0])
    with pytest.raises(TypeError):
        block_ldlt_inv(A.to(torch.int64))
    with pytest.raises(ValueError):
        block_ldlt_inv(A.to("meta"))


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_module_imports_jax():
    """Every import statement of ipopt_torch/ and chip_smoke.py, wherever it
    stands (top level or inside a function), names neither JAX nor the
    reference package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ipopt_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {"ipopt_torch/sparse.py", "ipopt_torch/algorithm/banded_resto.py",
            "ipopt_torch/interfaces/transforms.py",
            "ipopt_torch/interfaces/dependency.py",
            "ipopt_torch/parallel/scenario.py", "ipopt_torch/algorithm/arrow_kkt.py",
            "ipopt_torch/algorithm/arrow_resto.py",
            "ipopt_torch/algorithm/quasi_newton.py",
            "ipopt_torch/algorithm/lowrank_kkt.py",
            "ipopt_torch/algorithm/lowrank_struct.py",
            "ipopt_torch/linalg/block_tridiag.py",
            "ipopt_torch/linalg/nested_dissection.py",
            "ipopt_torch/algorithm/matrix_free.py",
            "ipopt_torch/algorithm/inexact.py",
            "ipopt_torch/algorithm/cg_penalty.py", "ipopt_torch/sens.py",
            "ipopt_torch/deriv_check.py", "ipopt_torch/profiling.py",
            "ipopt_torch/parallel/chain_shard.py", "ipopt_torch/interfaces/ampl.py",
            "ipopt_torch/interfaces/capi.py", "ipopt_torch/native/build.py"} <= rel
    # the independent-block half of block_tridiag (the arrow backend's)
    with open(os.path.join(REPO, "ipopt_torch/linalg/block_tridiag.py")) as fh:
        src = fh.read()
    assert all(f"def {f}(" in src for f in ("batched_block_ldlt_inv",
                                             "_tri_unit_inv_logdepth"))
    bad = [(os.path.relpath(p, REPO), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "ipopt_tpu")]
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("nb,b", [(64, 156), (4, 16), (4, 280)])
def test_kernel_matches_plain_on_cuda(cuda, nb, b):
    """b <= 32: the same scalar sweep, exactly equal.  Above: the panel
    products run on the FP64 tensor cores (fused multiply-adds, another
    summation order), so Ainv to 1e-11 max(1, max|Ainv|) and d to 1e-10
    relative, on quasi-definite blocks."""
    rng = np.random.default_rng(b)
    A = kkt_like(rng, nb, b) if b <= 32 else quasi_definite_kkt(rng, nb, b)
    A = torch.as_tensor(A, device=cuda)
    before = block_ldlt_inv.launches
    d, Ainv = block_ldlt_inv(A)
    torch.cuda.synchronize()
    assert block_ldlt_inv.launches == before + 1
    d_p, Ainv_p = block_ldlt_inv_plain(A)
    if b <= 32:
        torch.testing.assert_close(d, d_p, rtol=0, atol=0)
        torch.testing.assert_close(Ainv, Ainv_p, rtol=0, atol=0)
    else:
        # block 0's guarded pivot puts 1/tiny in its inverse, equal in both
        scale = max(1.0, float(Ainv_p[1:].abs().max()))
        assert float((Ainv - Ainv_p).abs().max()) <= 1e-11 * scale
        torch.testing.assert_close(d, d_p, rtol=1e-10, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,b,dtype", [(3, 417, torch.float64), (2, 1288, torch.float64),
                                        (3, 577, torch.float32)])
def test_device_memory_variant_matches_plain_on_cuda(cuda, nb, b, dtype):
    """Above the cluster variant's widths K2 runs with the block in device
    memory: the same panel-32 sweep, the products on the FP64 tensor cores
    (IEEE FFMA in float32), so the tolerances of the cluster variant; block
    0 has a guarded (+-tiny) pivot."""
    from ipopt_torch.linalg.block_ldlt_inv import plan
    assert plan(nb, b, dtype).variant == "global"
    A = torch.as_tensor(quasi_definite_kkt(np.random.default_rng(b), nb, b),
                        device=cuda).to(dtype)
    before = block_ldlt_inv.launches
    d, Ainv = block_ldlt_inv(A)
    torch.cuda.synchronize()
    assert block_ldlt_inv.launches == before + 1
    d_p, Ainv_p = block_ldlt_inv_plain(A)
    tol_inv, tol_d = (1e-11, 1e-10) if dtype == torch.float64 else (1e-4, 1e-4)
    scale = max(1.0, float(Ainv_p[1:].abs().max()))
    assert float((Ainv - Ainv_p).abs().max()) <= tol_inv * scale
    torch.testing.assert_close(d, d_p, rtol=tol_d, atol=0)
    assert bool((d_p[0].abs() <= torch.finfo(dtype).tiny).any())
