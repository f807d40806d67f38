"""K2's panel algorithm and launch plan (ipopt_torch/linalg/block_ldlt_inv.py)
against the reference's ``_gj_inv_auto`` (ipopt_tpu/linalg/block_tridiag.py),
in float64 on the CPU.

Tolerances:
- b <= 32: bit for bit against ``_gj_inv_lanes`` and the Pallas kernel in
  interpret mode (the same expressions in the same order).
- b > 32, against ``_gj_inv_lanes_blocked``, pivot signs equal on live
  pivots (the panel products sum in another order: torch.matmul against
  XLA's dot).  On quasi-definite KKT-shaped blocks, the class the reference
  tests its panel sweep on (tests/test_block_tridiag.py:153-160): atol
  1e-12 on the inverse, rtol 1e-9 on the pivots.  On the merely indefinite
  ``kkt_like`` blocks the unpivoted panel sweep amplifies rounding, and the
  two sweeps agree only to 1e-8 of each block's max(1, max|Ainv|) and 1e-7
  relative on the pivots.
- BCR at b = 40: inertia counts exactly equal, solutions rtol 1e-10.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ipopt_tpu.linalg.pallas_ldlt import pallas_block_ldlt_inv
from ipopt_tpu.linalg import block_tridiag as ref_bt

from ipopt_torch.linalg import block_ldlt_inv as k2
from ipopt_torch.linalg import block_tridiag as port_bt
from ipopt_torch.linalg import cuda_lib
from test_torch_kernels import kkt_like
from test_block_tridiag import make_btd

torch.set_num_threads(1)


def quasi_definite_kkt(rng, nb, b, zero_pivot=True):
    """KKT-shaped quasi-definite blocks: a positive definite (x, x) block
    (random symmetric, shifted past the semicircle's edge sqrt(2n) by one),
    constraint rows J and a -1e-3 regularization; block 0 has an exactly
    zero pivot (row/column b//2 zeroed), which hits the tiny-pivot guard."""
    n = max(1, (2 * b) // 3)
    m = b - n
    A = np.zeros((nb, b, b))
    W = rng.standard_normal((nb, n, n))
    A[:, :n, :n] = 0.5 * (W + W.transpose(0, 2, 1)) + (np.sqrt(2 * n) + 1) * np.eye(n)
    if m:
        J = rng.standard_normal((nb, m, n))
        A[:, n:, :n] = J
        A[:, :n, n:] = J.transpose(0, 2, 1)
        A[:, n:, n:] = -1e-3 * np.eye(m)
    if zero_pivot and b > 1:
        A[0, b // 2, :] = 0.0
        A[0, :, b // 2] = 0.0
    return A


def _live(d):
    return np.abs(d) > np.finfo(d.dtype).eps * np.maximum(
        np.abs(d).max(-1, keepdims=True), 1.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b", [1, 8, 16, 32])
def test_plain_bit_equal_to_scalar_sweep_up_to_32(b, dtype):
    A = kkt_like(np.random.default_rng(100 + b), 3, b).astype(dtype)
    _, d_pl, inv_pl = pallas_block_ldlt_inv(jnp.asarray(A), interpret=True)
    inv_gj, d_gj = ref_bt._gj_inv_lanes(jnp.asarray(A.transpose(1, 2, 0)))
    d, Ainv = k2.block_ldlt_inv_plain(torch.as_tensor(A))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_pl))
    np.testing.assert_array_equal(Ainv.numpy(), np.asarray(inv_pl))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_gj).T)
    np.testing.assert_array_equal(Ainv.numpy(), np.asarray(inv_gj).transpose(2, 0, 1))


@pytest.mark.parametrize("b", [48, 100, 156])
def test_plain_matches_blocked_gj(b):
    """100 ends in a ragged panel of 4; block 0's zero pivot is guarded."""
    A = quasi_definite_kkt(np.random.default_rng(b), 3, b)
    inv_r, d_r = ref_bt._gj_inv_lanes_blocked(jnp.asarray(A.transpose(1, 2, 0)))
    inv_r, d_r = np.asarray(inv_r).transpose(2, 0, 1), np.asarray(d_r).T
    d, Ainv = k2.block_ldlt_inv_plain(torch.as_tensor(A))
    d, Ainv = d.numpy(), Ainv.numpy()
    np.testing.assert_allclose(Ainv, inv_r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d, d_r, rtol=1e-9)
    live = _live(d_r)
    np.testing.assert_array_equal(np.sign(d)[live], np.sign(d_r)[live])
    assert (~live[0]).sum() == 1 and live[1:].all()
    assert (d_r[1:] < 0).sum(-1).tolist() == [b - (2 * b) // 3] * 2


def _rel_to_block(X, ref):
    """max|X - ref| / max(1, max|ref|) per block, over the entries below
    1e300; the guard's 1/tiny entries must be equal."""
    big = ~(np.abs(ref) < 1e300)
    np.testing.assert_array_equal(X[big], ref[big])
    scale = np.maximum(1.0, np.where(big, 0.0, np.abs(ref)).max((1, 2)))
    return np.abs(np.where(big, 0.0, X - ref)).max((1, 2)) / scale


@pytest.mark.parametrize("b", [48, 100, 156])
def test_plain_matches_blocked_gj_on_indefinite_blocks(b):
    """The same comparison on ``kkt_like`` blocks (random symmetric (x, x)
    block + 3 I, J, -1e-3 I; block 0's zero pivot guarded).  These seeds
    differ by at most 6.2e-10 of max|Ainv| (b = 100) and 4.4e-9 in the
    pivots: the limits are 1e-8 and 1e-7."""
    A = kkt_like(np.random.default_rng(b), 3, b)
    inv_r, d_r = ref_bt._gj_inv_lanes_blocked(jnp.asarray(A.transpose(1, 2, 0)))
    inv_r, d_r = np.asarray(inv_r).transpose(2, 0, 1), np.asarray(d_r).T
    d, Ainv = k2.block_ldlt_inv_plain(torch.as_tensor(A))
    d, Ainv = d.numpy(), Ainv.numpy()
    assert _rel_to_block(Ainv, inv_r).max() <= 1e-8
    np.testing.assert_allclose(d, d_r, rtol=1e-7, atol=0)
    live = _live(d_r)
    np.testing.assert_array_equal(np.sign(d)[live], np.sign(d_r)[live])
    assert (~live[0]).sum() == 1 and live[1:].all()


@pytest.mark.parametrize("nb", [5])
def test_bcr_panelled_blocks_match_reference(nb):
    """BCR at b = 40 (a full panel and a ragged one of 8 in every K2 call)
    over an odd chain, two lanes with different negative tails."""
    Ks = [make_btd(nb, 40, seed=nb + lane, neg_tail=8 * (lane + 1)) for lane in range(2)]
    rhs = np.random.default_rng(nb).standard_normal((2, nb * 40))
    K = port_bt.BTDMatrix(torch.as_tensor(np.stack([np.asarray(k.diag) for k in Ks])),
                          torch.as_tensor(np.stack([np.asarray(k.sub) for k in Ks])))
    fac = port_bt.bcr_factorize(K)
    x = port_bt.bcr_solve(fac, torch.as_tensor(rhs)).numpy()
    for lane, Kr in enumerate(Ks):
        fr = ref_bt.bcr_factorize(Kr)
        xr = np.asarray(ref_bt.bcr_solve(fr, jnp.asarray(rhs[lane])))
        for key in ("num_pos", "num_neg", "num_zero", "singular"):
            assert int(getattr(fac, key)[lane]) == int(getattr(fr, key)), key
        np.testing.assert_allclose(x[lane], xr, rtol=1e-10, atol=1e-12)
    assert int(fac.num_neg[1]) > int(fac.num_neg[0]) > 0


@pytest.mark.parametrize("nb,b,dtype,cs", [
    (64, 156, torch.float64, 2), (32, 156, torch.float64, 3),
    (16, 156, torch.float64, 5), (8, 156, torch.float64, 5),
    (4, 156, torch.float64, 5), (2, 156, torch.float64, 5),
    (1, 156, torch.float64, 5), (1, 280, torch.float64, 5),
    (1, 408, torch.float64, 7), (64, 156, torch.float32, 2),
    (16, 8, torch.float64, 1), (4, 33, torch.float64, 2)])
def test_plan_fits_and_covers_every_row(nb, b, dtype, cs):
    pl = k2.plan(nb, b, dtype)
    assert pl.cs == cs
    assert pl.smem <= cuda_lib.SMEM_BYTES
    if b <= k2.PANEL:
        # the warp variant: one lane per row, blocks packed into warps
        assert pl.variant == "warp" and pl.rows == (b,)
        per_cta = (pl.threads // 32) * (32 // pl.lanes)
        assert pl.smem == per_cta * b * b * torch.finfo(dtype).bits // 8
        assert pl.grid * per_cta >= nb > (pl.grid - 1) * per_cta
        return
    assert len(pl.rows) == pl.cs and all(r > 0 for r in pl.rows)
    assert all(r % k2.PANEL == 0 for r in pl.rows[:-1])
    # each CTA's strip starts where the last one ended: every row once
    starts = np.cumsum((0,) + pl.rows[:-1])
    covered = np.concatenate([np.arange(s, s + r) for s, r in zip(starts, pl.rows)])
    np.testing.assert_array_equal(covered, np.arange(b))
    # widened no further than the card's SMs
    assert max(nb, 1) * pl.cs <= k2.NUM_SMS or pl.cs == 1
    assert k2._smem(b, pl.cs, torch.finfo(dtype).bits // 8) == pl.smem


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_warp_plan_up_to_32(dtype):
    """b <= 32 takes the warp variant: next_pow2(b) lanes per block, 32 //
    lanes blocks per warp, the warps spread over the SMs before a CTA takes
    more than one (at most four); above 32 the cluster variant."""
    esize = torch.finfo(dtype).bits // 8
    for b in range(1, 33):
        for nb in (1, 3, 512, 6250, 12500):
            pl = k2.plan(nb, b, dtype)
            lanes = 1 << (b - 1).bit_length()
            assert (pl.variant, pl.cs, pl.rows, pl.lanes) == ("warp", 1, (b,), lanes)
            per_warp = 32 // lanes
            warps = -(-nb // per_warp)
            per_cta = min(4, -(-warps // k2.NUM_SMS))
            assert pl.threads == 32 * per_cta
            assert pl.grid == -(-warps // per_cta)
            assert pl.grid <= k2.NUM_SMS or per_cta == 4
            assert pl.smem == per_cta * per_warp * b * b * esize <= cuda_lib.SMEM_BYTES
    assert k2.plan(6250, 16, dtype)[3:] == ("warp", 16, 782, 128)
    assert k2.plan(12500, 8, dtype)[3:] == ("warp", 8, 782, 128)
    assert k2.plan(16, 33, dtype).variant == "cluster"


def test_max_block_from_the_plan():
    """The cluster variant's widest b fits shared memory; one column more
    goes to the device-memory variant, whose plan holds the whole block."""
    assert k2.CLUSTER_MAX_B[torch.float64] >= 408
    for dtype in (torch.float64, torch.float32):
        top = k2.CLUSTER_MAX_B[dtype]
        assert k2.plan(1, top, dtype).smem <= cuda_lib.SMEM_BYTES
        assert k2.plan(1, top, dtype).variant == "cluster"
        pl = k2.plan(1, top + 1, dtype)
        assert (pl.variant, pl.cs, pl.rows) == ("global", 1, (top + 1,))
    assert k2.CLUSTER_MAX_B[torch.float32] > k2.CLUSTER_MAX_B[torch.float64]


def test_capture_k2_inputs_sees_every_launch():
    """The capture that chip_smoke.py and profile_main use to check and time
    K2 on the chained solve's own blocks: every launch, in order (16 blocks
    of 16: levels ne = 8, 4, 2, 1 and the root per factorization)."""
    from ipopt_torch import modellib, solve
    from ipopt_torch.profile_main import capture_k2_inputs
    res = []
    inputs = capture_k2_inputs(lambda: res.append(
        solve(modellib.luksan_vlcek1(64, 4), device="cpu", print_level=0)))
    shapes = [(8, 16, 16), (4, 16, 16), (2, 16, 16), (1, 16, 16), (1, 16, 16)]
    assert int(res[0].status) == 0
    assert len(inputs) == len(shapes) * res[0].batched_factorizations
    assert [tuple(A.shape) for A in inputs] == shapes * res[0].batched_factorizations
    assert port_bt.block_ldlt_inv is k2.block_ldlt_inv
