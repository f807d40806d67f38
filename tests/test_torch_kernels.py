"""K1 of the PyTorch port (ipopt_torch/linalg/block_ldlt.py) against the
reference: the Pallas kernel in interpret mode and the vmapped ldlt; its
launch plan; the dense backend at a KKT width above the kernel's old limit.

Tolerances: float64 atol 1e-12 (the arithmetic is the same step for step,
so only the order of rounding may differ); float32 rtol 1e-5; pivot signs
and inertia counts exactly equal; NaN in the same places.  On the card the
kernel equals its plain version bit for bit (torch.equal, NaN in the same
places).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ipopt_tpu.linalg.pallas_ldlt import pallas_block_ldlt
from ipopt_tpu.linalg import ldlt as ref_ldlt

import ipopt_torch
from ipopt_torch import modellib
from ipopt_torch.linalg import cuda_lib
from ipopt_torch.linalg import ldlt as port_ldlt
from ipopt_torch.linalg.block_ldlt import (BLOCKED_MAX_NB, BLOCKED_MIN_B, block_ldlt,
                                           block_ldlt_plain, k1_rule, plan)

torch.set_num_threads(1)


def kkt_like(rng, nb, b):
    """Symmetric indefinite KKT-like blocks; block 0 has an exactly zero
    pivot (row/column b//2 zeroed), which hits the tiny-pivot guard."""
    n = max(1, (2 * b) // 3)
    m = b - n
    A = np.zeros((nb, b, b))
    W = rng.standard_normal((nb, n, n))
    A[:, :n, :n] = 0.5 * (W + W.transpose(0, 2, 1)) + 3.0 * np.eye(n)
    if m:
        J = rng.standard_normal((nb, m, n))
        A[:, n:, :n] = J
        A[:, :n, n:] = J.transpose(0, 2, 1)
        A[:, n:, n:] = -1e-3 * np.eye(m)
    if b > 1:
        A[0, b // 2, :] = 0.0
        A[0, :, b // 2] = 0.0
    return A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b", [1, 7, 16, 33])
def test_plain_matches_pallas_and_ldlt(b, dtype):
    A = kkt_like(np.random.default_rng(b), 4, b).astype(dtype)
    L_pl, d_pl = pallas_block_ldlt(jnp.asarray(A), interpret=True)
    ref = jax.vmap(ref_ldlt.ldlt)(jnp.asarray(A))
    L, d = block_ldlt_plain(torch.as_tensor(A))
    L, d = L.numpy(), d.numpy()
    for L_r, d_r in ((np.asarray(L_pl), np.asarray(d_pl)),
                     (np.asarray(ref.L), np.asarray(ref.d))):
        if dtype == "float64":
            np.testing.assert_allclose(L, L_r, rtol=0, atol=1e-12)
            np.testing.assert_allclose(d, d_r, rtol=0, atol=1e-12)
        else:
            scale = max(np.abs(L_r).max(), np.abs(d_r).max())
            np.testing.assert_allclose(L, L_r, rtol=1e-5, atol=1e-5 * scale)
            np.testing.assert_allclose(d, d_r, rtol=1e-5, atol=1e-5 * scale)
    fin = port_ldlt._finish(torch.as_tensor(L), torch.as_tensor(d), 0.0)
    np.testing.assert_array_equal(fin.num_pos.numpy(), np.asarray(ref.num_pos))
    np.testing.assert_array_equal(fin.num_neg.numpy(), np.asarray(ref.num_neg))
    np.testing.assert_array_equal(fin.num_zero.numpy(), np.asarray(ref.num_zero))
    d_ref = np.asarray(ref.d)
    zero_tol = np.finfo(dtype).eps * np.maximum(
        np.abs(d_ref).max(-1, keepdims=True), 1.0)
    live = np.abs(d_ref) > zero_tol
    np.testing.assert_array_equal(np.sign(d)[live], np.sign(d_ref)[live])
    if b > 1:
        assert int(fin.num_zero[0]) >= 1  # the guarded zero pivot


def test_ldlt_solve_matches_reference():
    A = kkt_like(np.random.default_rng(5), 3, 7)[1:]  # nonsingular lanes
    rhs = np.random.default_rng(6).standard_normal((2, 7))
    x_port = port_ldlt.dense_solve(torch.as_tensor(A), torch.as_tensor(rhs))
    for i in range(2):
        x_ref = ref_ldlt.dense_solve(jnp.asarray(A[i]), jnp.asarray(rhs[i]))
        np.testing.assert_allclose(x_port[i].numpy(), np.asarray(x_ref),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x_port.numpy()), rhs,
                               atol=1e-10)


def test_wrapper_cpu_path_and_bad_inputs():
    A = torch.as_tensor(kkt_like(np.random.default_rng(2), 3, 5))
    before = block_ldlt.launches
    L, d = block_ldlt(A)
    L_p, d_p = block_ldlt_plain(A)
    assert torch.equal(L, L_p) and torch.equal(d, d_p)
    assert block_ldlt.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError):
        block_ldlt(A[:, :, :4])
    with pytest.raises(ValueError):
        block_ldlt(A.to("meta"))


def special_blocks(kind, dtype):
    """Blocks that reach the guard or non-finite arithmetic: exactly zero
    pivots (a zero block, a zero row and column, a zero leading pivot) and a
    block with an inf entry (its mirror too); or one 170-wide block."""
    rng = np.random.default_rng(17)
    if kind == "wide":
        return kkt_like(rng, 1, 170).astype(dtype)
    A = kkt_like(rng, 4, 9)
    if kind == "zero_pivots":
        A[1] = 0.0
        A[2, 0, :] = A[2, :, 0] = 0.0
        A[3, 4, :] = A[3, :, 4] = 0.0
        A[3, 7, :] = A[3, :, 7] = 0.0
    else:
        A[1, 6, 2] = A[1, 2, 6] = np.inf
        A[2, 3, 3] = -np.inf
    return A.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["zero_pivots", "inf_entry", "wide"])
def test_plain_matches_reference_on_special_blocks(kind, dtype):
    A = special_blocks(kind, dtype)
    L_pl, d_pl = pallas_block_ldlt(jnp.asarray(A), interpret=True)
    ref = jax.vmap(ref_ldlt.ldlt)(jnp.asarray(A))
    L, d = block_ldlt_plain(torch.as_tensor(A))
    L, d = L.numpy(), d.numpy()
    if kind == "inf_entry":
        assert np.isnan(L).any()
    for L_r, d_r in ((np.asarray(L_pl), np.asarray(d_pl)),
                     (np.asarray(ref.L), np.asarray(ref.d))):
        np.testing.assert_array_equal(np.isnan(L), np.isnan(L_r))
        np.testing.assert_array_equal(np.isnan(d), np.isnan(d_r))
        if dtype == "float64":
            np.testing.assert_allclose(L, L_r, rtol=0, atol=1e-12)
            np.testing.assert_allclose(d, d_r, rtol=0, atol=1e-12)
        else:
            fin = np.isfinite(L_r)
            scale = max(np.abs(L_r[fin]).max(), np.abs(d_r[np.isfinite(d_r)]).max())
            np.testing.assert_allclose(L, L_r, rtol=1e-5, atol=1e-5 * scale)
            np.testing.assert_allclose(d, d_r, rtol=1e-5, atol=1e-5 * scale)
    if kind == "zero_pivots":
        tiny = np.finfo(dtype).tiny
        assert (np.abs(d) <= tiny).sum() >= 4  # the guard fired in blocks 1-3
        fin = port_ldlt._finish(torch.as_tensor(L), torch.as_tensor(d), 0.0)
        np.testing.assert_array_equal(fin.num_zero.numpy(), np.asarray(ref.num_zero))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_plan_covers_every_width(dtype):
    esize = torch.finfo(dtype).bits // 8
    seen = set()
    for b in range(1, 4097):
        for nb in (1, 3, 512):
            pl = plan(nb, b, dtype)
            seen.add(pl.variant)
            assert 0 <= pl.smem <= cuda_lib.SMEM_BYTES
            assert 32 <= pl.threads <= 1024 and pl.threads % 32 == 0
            if pl.variant == "warp":
                assert b <= pl.rows <= 32 and pl.rows & (pl.rows - 1) == 0
                assert pl.lanes == min(32, 2 * pl.rows)
                per_cta = (pl.threads // 32) * (32 // pl.lanes)
                assert pl.grid * per_cta >= nb > (pl.grid - 1) * per_cta
                assert pl.smem == per_cta * b * b * esize
            elif pl.variant == "cta":
                assert b > 32 and pl.grid == nb and pl.kernels == 1
                assert b < BLOCKED_MIN_B or nb > BLOCKED_MAX_NB
                tri = b * (b + 1) // 2 * esize
                assert pl.smem == tri <= cuda_lib.SMEM_BYTES
            else:
                # the blocked variant: static shared memory (48 KB at most),
                # every launch's grid within one launch's limit, two launches
                # per panel of 32 (the init, a strip per panel, an update
                # per panel but the last)
                assert pl.variant == "blocked" and b > 32
                assert pl.threads == 256 and pl.rows == 16 and pl.smem <= 48 * 1024
                assert pl.kernels == 2 * -(-b // 32)
                below = b - 32
                tiles = -(-below // 64)
                assert pl.grid == max(min(1024, -(-nb * b * b // 256)),
                                      nb * -(-below // pl.rows), nb * tiles * (tiles + 1) // 2)
                assert pl.grid < 2 ** 31
    assert seen == {"warp", "cta", "blocked"}
    top = max(b for b in range(33, 4097) if plan(512, b, dtype).variant == "cta")
    assert top == (240 if dtype == torch.float64 else 340)
    # few blocks from b = 64 on: the blocked variant, whose times beat the
    # CTA variant's there (block_ldlt.py)
    assert [plan(nb, b, dtype).variant for nb, b in ((1, 63), (1, 64), (32, 198),
                                                     (33, 198), (104, 161))] == [
        "cta", "blocked", "blocked", "cta", "cta"]
    # (512, 7, 7): two lanes per row, two blocks per warp, two warps per CTA
    # on 128 SMs
    assert plan(512, 7, dtype)[:5] == ("warp", 8, 16, 128, 64)


def test_blocked_order_meets_the_chip_rule():
    """The rule chip_smoke.py holds K1's blocked variant to on the card
    (``block_ldlt.k1_rule``: the finite pattern, per-block inertia, a
    backward error within 4x the plain version's own plus b u) admits a
    blocked order: on every K1 input of the multifrontal solve of
    mittelmann_dist_control_3d(5) (the smallest N whose top front, 74 wide,
    spans more than two panels of 32; its restoration's is 148 wide), the
    reference's ``ldlt_blocked(block=32)`` (jnp, CPU) against
    ``block_ldlt_plain``."""
    from ipopt_torch.profile_main import capture_k1_inputs
    from ipopt_torch.sparse import canonicalize_sparse
    kw = dict(linear_solver="multifrontal", print_level=0)
    cnlp = canonicalize_sparse(modellib.mittelmann_dist_control_3d(5),
                               ipopt_torch.Options(**kw), device="cpu")
    inputs = capture_k1_inputs(lambda: ipopt_torch.solve(cnlp, device="cpu", **kw))
    by_shape = {}
    for A in inputs:
        by_shape.setdefault(tuple(A.shape[1:]), []).append(A)
    # the solve's top front is 74 wide, its restoration's 148
    assert {74, 148} <= {b for b, _ in by_shape}
    blocked = jax.jit(jax.vmap(lambda M: ref_ldlt.ldlt_blocked(M, block=32)[:2]))
    for shape, group in sorted(by_shape.items()):
        A = torch.cat(group)
        L_p, d_p = block_ldlt_plain(A)
        L_r, d_r = (torch.as_tensor(np.array(x)) for x in blocked(A.numpy()))
        ok, why, _ = k1_rule(A, L_r, d_r, L_p, d_p)
        assert ok, (shape, why)
    # the rule is no tautology: a wrong pivot's block fails it
    A = torch.cat(by_shape[max(by_shape)])
    L_p, d_p = block_ldlt_plain(A)
    d_bad = d_p.clone()
    d_bad[0, -1] *= 1 + 1e-6
    assert not k1_rule(A, L_p, d_bad, L_p, d_p)[0]


# ipopt_tpu.solve(tests/problems.py::luksan_vlcek1(100)) in float64 on the
# CPU, options of bench.py:74-80, at commit 3aa5258: status 0, 6 iterations.
LV1_DENSE_OBJ = 6.2324586324464475


def test_dense_kkt_wider_than_the_old_kernel_limit():
    """The dense backend factors the 198-wide augmented KKT of LuksanVlcek1
    at n = 100 and ends where the reference's float64 solve ends."""
    calls = port_ldlt.ldlt.calls
    res = ipopt_torch.solve(modellib.luksan_vlcek1_dense(100), device="cpu",
                            tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10,
                            print_level=0)
    assert port_ldlt.ldlt.calls > calls
    assert (int(res.status), int(res.iter_count)) == (0, 6)
    assert abs(float(res.obj) - LV1_DENSE_OBJ) <= 1e-9 * LV1_DENSE_OBJ


def test_capture_k1_inputs_sees_every_factorization():
    from ipopt_torch.profile_main import capture_k1_inputs
    calls = port_ldlt.ldlt.calls
    res = []
    inputs = capture_k1_inputs(lambda: res.append(ipopt_torch.solve_batched(
        [modellib.hs071_family(0.005 * i) for i in range(2)], device="cpu",
        print_level=0)))
    assert len(inputs) == port_ldlt.ldlt.calls - calls == res[0].batched_factorizations
    assert tuple(inputs[0].shape) == (2, 2, 2)  # the initial multipliers' system
    assert all(tuple(A.shape[1:]) == (7, 7) for A in inputs[1:])
    assert port_ldlt.block_ldlt is block_ldlt  # restored after the run


def same_values(x, y):
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(torch.where(nx, 0.0, x),
                                               torch.where(ny, 0.0, y))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb, b", [(512, 7), (9, 1), (7, 32), (64, 64), (5, 241),
                                   (3, 341), (1, 1024)])
def test_kernel_matches_plain_on_cuda(cuda, nb, b, dtype):
    """Every variant, with a guarded block (block 0) and a block with an inf
    entry (the last): the warp and CTA variants bit for bit, the blocked one
    (b = 241 in float64, 341 and 1024) by ``block_ldlt.k1_rule``."""
    A = kkt_like(np.random.default_rng(b), nb, b)
    if nb > 1:
        A[-1, b - 1, b // 2] = A[-1, b // 2, b - 1] = np.inf
    A = torch.as_tensor(A, dtype=dtype, device=cuda)
    before = block_ldlt.launches
    L, d = block_ldlt(A)
    torch.cuda.synchronize()
    assert block_ldlt.launches == before + 1
    L_p, d_p = block_ldlt_plain(A)
    if plan(nb, b, dtype).variant == "blocked":
        ok, why, _ = k1_rule(A, L, d, L_p, d_p)
        assert ok, why
    else:
        assert same_values(L, L_p) and same_values(d, d_p)
