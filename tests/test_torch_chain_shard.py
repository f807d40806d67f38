"""The chain axis sharded over devices (``ipopt_torch/parallel/chain_shard.py``)
against the JAX reference (``ipopt_tpu/parallel/chain_shard.py``), in
float64 on the CPU: the reference runs on the 8 virtual CPU devices of
``tests/conftest.py``, the port over 8 CPU shards (lanes of one batched BCR).

Held: the sharded factorize + solve of ``tests/test_chain_shard.py``'s
random quasi-definite BTD (x to 1e-10, the inertia exactly the reference's
and unsharded BCR's); the inertia-correction loop ``dist_factorize_retry``
with mc19 and in float32 (deltas, trials, inertia equal); the full
``luksan_vlcek1(128, 4)`` solve with ``chain_shard=True`` against the
reference's recorded sharded solve (``tools/torch_reference_values.py``)
and the port's unsharded solve; a batch of two chained lanes; and the
reference's preconditions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ipopt_tpu.linalg import block_tridiag as ref_bt
from ipopt_tpu.parallel import chain_shard as ref_cs

import ipopt_torch
from ipopt_torch import modellib
from ipopt_torch.linalg.block_tridiag import BTDMatrix, bcr_factorize, bcr_solve
from ipopt_torch.parallel import chain_shard as cs
import torch_cases
from test_chain_shard import _random_qd_btd
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)
P = torch_cases.CHAIN_SHARDS


def _mesh():
    return Mesh(np.array(jax.devices()[:P]), ("chain",))


def _port_btd(K_ref, dtype=torch.float64):
    return BTDMatrix(diag=torch.tensor(np.asarray(K_ref.diag), dtype=dtype)[None],
                     sub=torch.tensor(np.asarray(K_ref.sub), dtype=dtype)[None])


@pytest.fixture
def shards():
    cs.set_chain_mesh(["cpu"] * P)
    yield
    cs.set_chain_mesh(None)


def test_sharded_solve_matches_reference():
    K_ref = _random_qd_btd()
    rhs = np.random.RandomState(1).standard_normal(K_ref.nb * K_ref.b)
    x_r, po_r, ne_r, ze_r = jax.jit(
        lambda d, s, r: ref_cs.sharded_btd_factorize_solve(
            ref_bt.BTDMatrix(diag=d, sub=s), r, _mesh()))(
        K_ref.diag, K_ref.sub, jnp.asarray(rhs))
    K = _port_btd(K_ref)
    r = torch.tensor(rhs)[None]
    x, po, ne, ze = cs.sharded_btd_factorize_solve(K, r, ["cpu"] * P)
    f0 = bcr_factorize(K)
    assert (int(po), int(ne), int(ze)) == (int(po_r), int(ne_r), int(ze_r))
    assert (int(po), int(ne), int(ze)) == (int(f0.num_pos), int(f0.num_neg),
                                           int(f0.num_zero))
    assert float((x[0] - torch.tensor(np.asarray(x_r))).abs().max()) < 1e-10
    assert float((x - bcr_solve(f0, r)).abs().max()) < 1e-10
    assert float((K.matvec(x) - r).abs().max()) < 1e-10


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu"] * 4, ["cpu"] * 10])
def test_sharded_solve_any_shard_count(devices):
    """P = 2, 4, 10 shards (40 blocks): the counts exact, x = unsharded BCR's,
    also with several right-hand sides and with the per-chunk Ruiz scale."""
    K = _port_btd(_random_qd_btd())
    R = torch.tensor(np.random.RandomState(2).standard_normal((1, K.nb * K.b, 3)))
    f0 = bcr_factorize(K)
    X0 = bcr_solve(f0, R)
    for equilibrate in (False, True):
        f = cs.dist_factorize(K, devices, equilibrate=equilibrate)
        assert (int(f.num_pos), int(f.num_neg), int(f.num_zero)) == (
            int(f0.num_pos), int(f0.num_neg), int(f0.num_zero))
        assert float((cs.dist_solve(f, R) - X0).abs().max()) < 1e-10
        assert float((cs.dist_solve(f, R[..., 1]) - X0[..., 1]).abs().max()) < 1e-10


@pytest.mark.parametrize("name", sorted(torch_cases.SHARD_RETRY))
def test_dist_factorize_retry_matches_reference(name):
    """The retry loop on a BTD with negative curvature, with mc19 and in
    float32, against the reference's recorded loop (its shard_map program
    takes minutes to compile on the CPU): delta_x, delta_c, trials, the
    verdict and the inertia equal."""
    dtype, scaling = torch_cases.SHARD_RETRY[name]
    diag, sub, kind, exp_pos, exp_neg = torch_cases.shard_retry_problem()
    tdt = getattr(torch, dtype)
    K = BTDMatrix(diag=torch.tensor(diag, dtype=tdt)[None],
                  sub=torch.tensor(sub, dtype=tdt)[None])
    cs.set_chain_mesh(["cpu"] * P)
    try:
        fac, dx, dc, tr, ok, gu = cs.dist_factorize_retry(
            K, torch.tensor(kind), ipopt_torch.Options(linear_system_scaling=scaling),
            torch.tensor([1e-8], dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64), exp_pos, exp_neg)
    finally:
        cs.set_chain_mesh(None)
    want = torch_cases.recorded()[f"shard_retry:{name}"]
    assert want[2] > 1, "the problem must need an inertia correction"
    assert [float(dx[0]), float(dc[0]), int(tr[0]), bool(ok[0]), bool(gu[0]),
            int(fac.num_pos[0]), int(fac.num_neg[0]), int(fac.num_zero[0])] == want


@pytest.mark.parametrize("name", torch_cases.suite_cases("chain_shard"))
def test_chain_shard_solve_matches_reference(name):
    """The full solve over 8 shards = the reference's sharded solve
    (recorded) and = the port's unsharded solve: status, iterations,
    factorizations, objective to 1e-9 (tests/test_chain_shard.py:59-78)."""
    res, rec = torch_cases.solve_port(name, {})
    assert_matches_recorded(name, rec)
    opts = {k: v for k, v in torch_cases.CASES[name]["opts"].items()
            if k != "chain_shard"}
    r1 = ipopt_torch.solve(modellib.luksan_vlcek1(128, 4), device="cpu",
                           print_level=0, **opts)
    assert (int(r1.status), int(r1.iter_count)) == (rec["status"], rec["iter_count"])
    assert abs(float(r1.obj) - rec["obj"]) < 1e-9
    assert float((r1.x - res.x).abs().max()) < 1e-7


def test_chain_shard_batch_equals_lanes(shards):
    """Two chained lanes over 8 shards (16 rows of one batched BCR): each
    lane = its own sharded solve."""
    nlp = modellib.luksan_vlcek1(64, 2)
    nlp2 = dataclasses.replace(nlp, x0=nlp.x0 * 0.9)
    kw = dict(chain_shard=True, resto_phase=False, print_level=0)
    rb = ipopt_torch.solve_batched([nlp, nlp2], device="cpu", **kw)
    for i, p in enumerate((nlp, nlp2)):
        r = ipopt_torch.solve_batched([p], device="cpu", **kw)
        assert int(rb.status[i]) == int(r.status[0]) == 0
        assert int(rb.iter_count[i]) == int(r.iter_count[0])
        assert float((rb.x[i] - r.x[0]).abs().max()) < 1e-12


def test_preconditions_raise():
    K = _port_btd(_random_qd_btd())             # 40 blocks
    r = torch.zeros((1, K.nb * K.b), dtype=torch.float64)
    with pytest.raises(ValueError, match="nb % P"):
        cs.sharded_btd_factorize_solve(K, r, ["cpu"] * 3)    # 40 % 3 != 0
    with pytest.raises(ValueError, match="nb / P >= 3"):
        cs.sharded_btd_factorize_solve(K, r, ["cpu"] * 20)   # 2 blocks per shard
    cs.set_chain_mesh(None)
    with pytest.raises(ValueError, match="set_chain_mesh"):
        ipopt_torch.solve(modellib.luksan_vlcek1(128, 4), device="cpu",
                          print_level=0, chain_shard=True)
