"""The chained (block-tridiagonal) path of the PyTorch port against the JAX
reference, in float64 on the CPU: canonicalization and gradient scaling,
the structured evaluations, the BTD KKT assembly and its inertia-corrected
factorization, whole solves of LuksanVlcek1, the chained restoration phase,
and a batch of boundary-control instances (the MPC-fleet pattern).

Inputs come from numpy and go to both packages (ipopt_torch.convert).
Tolerances: rtol 1e-12 for elementwise functions (same formulas; only the
order of rounding may differ); BCR solutions rtol 1e-10; whole solves x and
objective rtol 1e-9 with equal status, iteration and factorization counts.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import modellib as ref_models
from ipopt_tpu import kkt as ref_kkt
from ipopt_tpu import chained as ref_chained
from ipopt_tpu.algorithm import chained_kkt as ref_ckkt
from ipopt_tpu.linalg import block_tridiag as ref_bt
from ipopt_tpu.types import Iterate as RefIterate

import ipopt_torch
from ipopt_torch import convert, kkt as port_kkt, modellib
from ipopt_torch import chained as port_chained
from ipopt_torch.algorithm import chained_kkt as port_ckkt
from ipopt_torch.linalg import block_tridiag as port_bt
from ipopt_torch.problem import CanonicalNLP
from test_torch_core import _random_iterate
import torch_cases

torch.set_num_threads(1)

OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10)
REF_OPTS = ipopt_tpu.Options(print_level=0, **OPTS)
F64 = dict(dtype=torch.float64)


def _close(a, b, err_msg="", rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-12, err_msg=err_msg)


def _ref_and_port(n, v=4):
    """The reference's canonical LuksanVlcek1 and the port's, built from the
    reference's arrays with the port's stage callables."""
    cref = ref_chained.canonicalize_chained(ref_models.luksan_vlcek1(n, v),
                                            ipopt_tpu.Options())
    pm = modellib.luksan_vlcek1(n, v)
    arrays = {k: np.asarray(getattr(cref, k)) for k in
              ("x_L", "x_U", "d_L", "d_U", "has_xL", "has_xU", "has_dL",
               "has_dU", "c_rhs", "x_fixed", "x0", "x_L_orig", "x_U_orig",
               "obj_scale", "c_scale", "d_scale")}
    arrays["params"] = {"theta": np.asarray(cref.params["theta"])}
    ch = cref.chain
    cp = convert.chained_from_arrays(
        dataclasses.asdict(cref.struct), arrays,
        dict(K=ch.K, v=ch.v, mk=ch.mk, eq_mask=ch.eq_mask),
        pm.f_stage, pm.g_stage, pm.f_last)
    return cref, cp


@pytest.mark.parametrize("n", [64, 60])
def test_canonicalize_chained_matches_reference(n):
    """60 = 15 groups of 4: an odd chain, padded in every BCR level."""
    cref = ref_chained.canonicalize_chained(ref_models.luksan_vlcek1(n, 4),
                                            ipopt_tpu.Options())
    cp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(n, 4))
    ch_r, ch_p = cref.chain, cp.chain
    assert (ch_r.K, ch_r.v, ch_r.mk, ch_r.bs) == (ch_p.K, ch_p.v, ch_p.mk, ch_p.bs)
    np.testing.assert_array_equal(ch_p.eq_mask, ch_r.eq_mask)
    s_r, s_p = cref.struct, cp.struct
    assert (s_r.n_full, s_r.n, s_r.m, s_r.me, s_r.mi) == \
        (s_p.n_full, s_p.n, s_p.m, s_p.me, s_p.mi)
    for k in ("eq_idx", "ineq_idx", "free_idx", "fixed_idx"):
        np.testing.assert_array_equal(getattr(s_p, k), getattr(s_r, k))
    for k in ("has_xL", "has_xU", "has_dL", "has_dU"):
        np.testing.assert_array_equal(getattr(cp, k)[0].numpy(),
                                      np.asarray(getattr(cref, k)))
    for k in ("x_L", "x_U", "d_L", "d_U", "c_rhs", "x0", "x_L_orig",
              "x_U_orig", "obj_scale", "c_scale", "d_scale"):
        _close(getattr(cp, k)[0], getattr(cref, k), k)
    assert float(cp.obj_scale[0]) < 1.0  # the gradient scaling is active
    with pytest.raises(ValueError, match="ChainInfo"):
        twin = dataclasses.replace(modellib.luksan_vlcek1(n, 4),
                                   g_stage=lambda a, b, t: modellib._lv1_g_stage(a, b, t))
        ipopt_torch.stack_problems([modellib.luksan_vlcek1(n, 4), twin])


def _seeded_point(cref, seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(cref.x0) + 0.2 * rng.standard_normal(cref.struct.n)
    return x, rng.standard_normal(cref.struct.me), rng.standard_normal(cref.struct.mi)


def test_structured_evaluations_match_reference():
    cref, cp = _ref_and_port(64)
    x, y_c, y_d = _seeded_point(cref, 3)
    xr, xp = jnp.asarray(x), torch.as_tensor(x)[None]
    ycp, ydp = torch.as_tensor(y_c)[None], torch.as_tensor(y_d)[None]
    ev_r = ref_kkt.evaluate(cref, xr)
    ev_p = port_kkt.evaluate(cp, xp)
    assert ev_p.J_c is None and ev_p.J_d is None
    for k in ("f", "grad_f", "c", "d"):
        _close(getattr(ev_p, k)[0], getattr(ev_r, k), k)
    _close(port_kkt.jac_t(cp, ev_p, ycp, ydp)[0],
           ev_r.jc_t(jnp.asarray(y_c)) + ev_r.jd_t(jnp.asarray(y_d)), "J^T y")
    for a, b in zip(port_chained.stage_jacobians(cp, xp),
                    ref_chained.stage_jacobians(cref, xr)):
        _close(a[0], b)
    for a, b in zip(port_chained.stage_hessians(cp, xp, ycp, ydp),
                    ref_chained.stage_hessians(cref, xr, jnp.asarray(y_c),
                                               jnp.asarray(y_d))):
        _close(a[0], b)


def _iterates(cref, seed):
    blocks = _random_iterate(np.random.default_rng(seed), cref)
    return RefIterate(*(jnp.asarray(b) for b in blocks)), convert.iterate_from_arrays(blocks)


@pytest.mark.parametrize("n", [64, 60])
def test_chained_kkt_matches_reference(n):
    cref, cp = _ref_and_port(n)
    it_r, it_p = _iterates(cref, 5)
    AB_r = ref_chained.stage_jacobians(cref, it_r.x)
    W_r = ref_chained.stage_hessians(cref, it_r.x, it_r.y_c, it_r.y_d)
    AB_p = port_chained.stage_jacobians(cp, it_p.x)
    W_p = port_chained.stage_hessians(cp, it_p.x, it_p.y_c, it_p.y_d)
    K_r = ref_ckkt.assemble_btd(cref, it_r, AB_r, W_r, 0.5, 0.25)
    K_p = port_ckkt.assemble_btd(cp, it_p, AB_p, W_p, torch.tensor([0.5], **F64),
                                 torch.tensor([0.25], **F64))
    _close(K_p.diag[0], K_r.diag, "diag")
    _close(K_p.sub[0], K_r.sub, "sub")
    assert port_ckkt.expected_inertia(cp) == ref_ckkt.expected_inertia(cref)

    rng = np.random.default_rng(6)
    s = cref.struct
    parts = [rng.standard_normal(k) for k in (s.n, s.mi, s.me, s.mi)]
    rhs_r = ref_ckkt.pack_rhs(cref, *(jnp.asarray(p) for p in parts))
    rhs_p = port_ckkt.pack_rhs(cp, *(torch.as_tensor(p)[None] for p in parts))
    _close(rhs_p[0], rhs_r, "pack_rhs")
    for a, b in zip(port_ckkt.unpack_sol(cp, rhs_p), ref_ckkt.unpack_sol(cref, rhs_r)):
        _close(a[0], b, "unpack_sol")
    for a, b in zip(port_ckkt.unpack_sol(cp, rhs_p), parts):
        _close(a[0], b, "round trip")

    fac_r = ref_bt.bcr_factorize(K_r)
    fac_p = port_bt.bcr_factorize(K_p)
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(fac_p, k)[0]) == int(getattr(fac_r, k)), k
    assert int(fac_p.num_pos[0] + fac_p.num_neg[0] + fac_p.num_zero[0]) == \
        (cp.chain.K + 1) * cp.chain.bs
    _close(port_bt.bcr_solve(fac_p, rhs_p)[0], ref_bt.bcr_solve(fac_r, rhs_r),
           "bcr_solve", rtol=1e-10)


def test_chained_factorize_kkt_matches_reference_per_lane():
    """Three lanes at one iterate whose Hessian blocks are shifted by 0, -3
    and -30: none, a few and many inertia corrections; each lane equals the
    reference run on that instance alone."""
    cref, cp1 = _ref_and_port(64)
    it_r, it_p1 = _iterates(cref, 8)
    AB_r = ref_chained.stage_jacobians(cref, it_r.x)
    Wd_r, Wo_r = ref_chained.stage_hessians(cref, it_r.x, it_r.y_c, it_r.y_d)
    shifts, mus, dwl = [0.0, 3.0, 30.0], [0.1, 0.01, 1e-3], [0.0, 1e-4, 0.0]
    eye = np.eye(cref.chain.v)
    out_r = [ref_ckkt.chained_factorize_kkt(
        cref, REF_OPTS, it_r, AB_r, (Wd_r - sh * eye, Wo_r), jnp.asarray(m),
        jnp.asarray(d)) for sh, m, d in zip(shifts, mus, dwl)]
    B = len(shifts)
    lanes = torch.zeros(B, dtype=torch.int64)
    cp = cp1.take(lanes)
    it_p = type(it_p1)(*(t.index_select(0, lanes) for t in it_p1))
    AB_p = port_chained.stage_jacobians(cp, it_p.x)
    Wd_p, Wo_p = port_chained.stage_hessians(cp, it_p.x, it_p.y_c, it_p.y_d)
    Wd_p = Wd_p - torch.tensor(shifts, **F64)[:, None, None, None] * torch.as_tensor(eye)
    fr = port_ckkt.chained_factorize_kkt(
        cp, ipopt_torch.Options(**OPTS), it_p, AB_p, (Wd_p, Wo_p),
        torch.tensor(mus, **F64), torch.tensor(dwl, **F64))
    trials = [int(o.num_trials) for o in out_r]
    assert len(set(trials)) > 1, trials
    for i, o in enumerate(out_r):
        assert int(fr.num_trials[i]) == int(o.num_trials)
        assert bool(fr.failed[i]) == bool(o.failed)
        for k in ("delta_x", "delta_c", "delta_w_last"):
            _close(getattr(fr, k)[i], getattr(o, k), k)
        assert int(fr.fac.num_pos[i]) == int(o.fac.num_pos)
        assert int(fr.fac.num_neg[i]) == int(o.fac.num_neg)


def _trace():
    rows = []

    def cb(iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr, **_):
        rows.append((iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr))
        return True

    return rows, cb


# reference: ipopt_tpu.solve(luksan_vlcek1(64, 4)), float64, CPU
LV1_64 = dict(status=0, iters=7, obj=6.232458632437091)


@pytest.mark.parametrize("n", [64, 60])
def test_lv1_solve_matches_reference(n):
    """The port's solve against the reference's, recorded with its
    per-iteration trace and final x (tests/torch_cases.py "lv1_<n>_trace",
    tools/torch_reference_values.py)."""
    ref = torch_cases.recorded()[f"lv1_{n}_trace"]
    rows_p, cb_p = _trace()
    res_p = ipopt_torch.solve(modellib.luksan_vlcek1(n, 4), device="cpu",
                              print_level=0, intermediate_callback=cb_p, **OPTS)
    assert int(res_p.status) == ref["status"] == 0
    assert int(res_p.iter_count) == ref["iter_count"]
    assert int(res_p.counters.n_factorizations) == ref["n_factorizations"]
    assert res_p.batched_factorizations == int(res_p.counters.n_factorizations)
    t_p, t_r = np.array(rows_p), np.array(ref["trace"])[:, :6]
    np.testing.assert_array_equal(t_p[:, 0], t_r[:, 0])
    np.testing.assert_allclose(t_p[:, 1:], t_r[:, 1:], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(res_p.x.numpy(), np.asarray(ref["x"]), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(res_p.obj), ref["obj"], rtol=1e-9)
    if n == 64:
        assert int(res_p.iter_count) == LV1_64["iters"]
        np.testing.assert_allclose(float(res_p.obj), LV1_64["obj"], rtol=1e-12)


# torch twins of tests/test_chained_resto.py (same formulas)
RESTO_CASES = {
    "infeasible_chain": dict(
        f_stage=lambda xk, xk1, th: (xk ** 2).sum(),
        g_stage=lambda xk, xk1, th: torch.stack([xk[0] + xk1[0] - 1.0,
                                                 xk[0] + xk1[0] + 1.0]),
        x0=np.zeros((4, 2)), g_L=np.zeros(2), g_U=np.zeros(2)),
    "hard_chain": dict(
        f_stage=lambda xk, xk1, th: ((xk - 2.0) ** 2).sum(),
        g_stage=lambda xk, xk1, th: torch.stack([xk1[0] - xk[0] ** 2]),
        x0=np.full((4, 2), -3.0), g_L=np.zeros(1), g_U=np.zeros(1)),
}


@pytest.mark.parametrize("case", sorted(RESTO_CASES))
def test_chained_restoration_matches_reference(case):
    import test_chained_resto
    res_r = ipopt_tpu.solve(getattr(test_chained_resto, case)(), print_level=0)
    res_p = ipopt_torch.solve(ipopt_torch.ChainedNLP(**RESTO_CASES[case]),
                              device="cpu", print_level=0)
    assert int(res_p.status) == int(res_r.status)
    assert int(res_p.iter_count) == int(res_r.iter_count)
    assert int(res_p.restoration_count) == int(res_r.restoration_count) > 0
    np.testing.assert_allclose(res_p.x.numpy(), np.asarray(res_r.x), rtol=1e-7,
                               atol=1e-9)


def test_batched_boundary_control_matches_instances():
    """Three instances of one model, canonicalized apart (equal ChainInfo),
    stacked and solved in lockstep: each lane equals its own solve, and lane
    0 the reference (tests/test_chained.py:132-147)."""
    opts = ipopt_torch.Options(print_level=0)
    insts = []
    for i in range(3):
        c = ipopt_torch.canonicalize_chained(modellib.mittelmann_bndry_control_1d(32, 4), opts)
        insts.append(c._replace(x0=c.x0 + 0.01 * i))
    res = ipopt_torch.solve_batched(ipopt_torch.stack_problems(insts, opts),
                                    device="cpu")
    assert res.status.tolist() == [0, 0, 0]
    for i, inst in enumerate(insts):
        one = ipopt_torch.solve(inst, device="cpu", print_level=0)
        assert int(one.iter_count) == int(res.iter_count[i])
        np.testing.assert_allclose(res.x[i].numpy(), one.x.numpy(), rtol=1e-12,
                                   atol=1e-14)
    ref = ipopt_tpu.solve(ref_chained.canonicalize_chained(
        ref_models.mittelmann_bndry_control_1d(32, 4), ipopt_tpu.Options(print_level=0)),
        ipopt_tpu.Options(print_level=0))
    assert int(ref.iter_count) == int(res.iter_count[0])
    np.testing.assert_allclose(float(res.obj[0]), float(ref.obj), rtol=1e-10)


@pytest.mark.parametrize("case", ["lv1", "hard_chain"])
def test_chained_path_builds_no_dense_objects(monkeypatch, case):
    def refuse(*_, **__):
        raise AssertionError("a dense Jacobian or Hessian on the chained path")

    for name in ("eval_jac_cd", "eval_lag_hess", "eval_all"):
        monkeypatch.setattr(CanonicalNLP, name, refuse)
    prob = (modellib.luksan_vlcek1(16, 2) if case == "lv1"
            else ipopt_torch.ChainedNLP(**RESTO_CASES["hard_chain"]))
    res = ipopt_torch.solve(prob, device="cpu", print_level=0)
    assert int(res.status) == 0
    assert case == "lv1" or int(res.restoration_count) > 0


def test_chained_solve_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipopt_torch.solve(modellib.luksan_vlcek1(16, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipopt_torch.solve_batched([modellib.luksan_vlcek1(16, 2)])


@pytest.mark.parametrize("b,dtype", [
    (417, torch.float64), (496, torch.float64), (568, torch.float64),
    (892, torch.float64), (1288, torch.float64), (577, torch.float32),
    (1288, torch.float32)])
def test_chained_restoration_refuses_wide_blocks_on_cuda(b, dtype):
    """Nothing is refused any more (the name is the old test's): K2's plan
    covers every block width the reference's BCR factors, so no chained
    restoration is refused on the card: LuksanVlcek1 (1000, 100) has
    496-wide KKT blocks, (4096, 64) a 568-wide restoration, Mittelmann
    N = 100's restoration analyzes to b = 1288.  Above the cluster variant's
    widths the plan names the device-memory variant, which holds the whole
    block."""
    from ipopt_torch.algorithm import chained_resto
    from ipopt_torch.linalg import block_ldlt_inv as k2
    assert not hasattr(chained_resto, "check_resto_block_width")
    assert b > k2.CLUSTER_MAX_B[dtype]
    for nb in (1, 20, 12500):
        pl = k2.plan(nb, b, dtype)
        assert (pl.variant, pl.cs, pl.rows) == ("global", 1, (b,))
        assert pl.smem == 2 * k2.PANEL * k2.PANEL * torch.finfo(dtype).bits // 8


@pytest.mark.gpu
def test_chained_solve_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ipopt_torch.linalg.block_ldlt_inv import block_ldlt_inv
    before = block_ldlt_inv.launches
    res_g = ipopt_torch.solve(modellib.luksan_vlcek1(64, 4), print_level=0, **OPTS)
    res_c = ipopt_torch.solve(modellib.luksan_vlcek1(64, 4), device="cpu",
                              print_level=0, **OPTS)
    assert int(res_g.status) == 0
    assert int(res_g.iter_count) == int(res_c.iter_count)
    np.testing.assert_allclose(float(res_g.obj), float(res_c.obj), rtol=1e-10)
    # 16 blocks: 4 levels + the root per factorization
    assert block_ldlt_inv.launches - before == 5 * res_g.batched_factorizations
