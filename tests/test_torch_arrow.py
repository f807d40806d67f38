"""The scenario (block-arrow) path of the PyTorch port against the JAX
reference, in float64 on the CPU: independent-block inverses
(``batched_block_ldlt_inv``, both of its algorithms), canonicalization and
the scenario evaluations, the arrow assembly, factorization, inertia and
solve, the inertia-corrected factorization, and whole solves (the
reference's recorded results, the arrow restoration included).

Inputs come from numpy and go to both packages (ipopt_torch.convert).
Tolerances: the block inverses and the functions of one formula rtol 1e-12
(atol 1e-12 times the largest entry); arrow solutions rtol 1e-10; whole
solves equal status, iteration, factorization and solve counts and the
objective to rtol 1e-9 (``test_torch_adaptive.assert_matches_recorded``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import kkt as ref_kkt
from ipopt_tpu.parallel import scenario as ref_scen
from ipopt_tpu.algorithm import arrow_kkt as ref_akkt
from ipopt_tpu.linalg import block_tridiag as ref_bt
from ipopt_tpu.types import Iterate as RefIterate

import ipopt_torch
from ipopt_torch import convert, kkt as port_kkt, modellib
from ipopt_torch.parallel import scenario as port_scen
from ipopt_torch.algorithm import arrow_kkt as port_akkt
from ipopt_torch.linalg import block_tridiag as port_bt
from ipopt_torch.linalg import ldlt as port_ldlt
import torch_cases
from test_torch_core import _random_iterate
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)


def _close(a, b, rtol=1e-12, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=err_msg)


def _kkt_blocks(rng, nb, b):
    """Symmetric quasi-definite KKT-like blocks [[H, J^T], [J, -D]] (H
    positive definite), the scenario blocks' shape of indefiniteness."""
    k = b // 3 if b >= 3 else 0
    A = rng.standard_normal((nb, b, b))
    A = 0.5 * (A + A.transpose(0, 2, 1))
    A[:, :b - k, :b - k] += b * np.eye(b - k)
    A[:, b - k:, b - k:] = -np.eye(k) * rng.uniform(0.5, 2.0, (nb, 1, k))
    return A


@pytest.mark.parametrize("b", [3, 8, 32, 65])
def test_batched_block_ldlt_inv_matches_reference(b):
    """The CPU branch (plain LDL^T + substitution) against the reference's
    CPU branch; the card branch's inverse step (the log-depth inverse of L
    and one Newton step) and the log-depth inverse itself against the
    reference's formula on the same factor."""
    A = _kkt_blocks(np.random.default_rng(b), 4, b)
    d_r, Ainv_r = ref_bt.batched_block_ldlt_inv(jnp.asarray(A))
    d_p, Ainv_p = port_bt.batched_block_ldlt_inv(torch.as_tensor(A))
    _close(d_p.numpy(), d_r, err_msg="d")
    _close(Ainv_p.numpy(), Ainv_r, err_msg="Ainv")
    _close(Ainv_p.numpy() @ A, np.broadcast_to(np.eye(b), A.shape), rtol=1e-10)

    L_r, dd_r = ref_bt._vfactor_jnp(jnp.asarray(A))
    Li_r = ref_bt._tri_unit_inv_logdepth(L_r)
    L_p, dd_p = port_bt.batched_block_ldlt(torch.as_tensor(A))
    _close(L_p.numpy(), L_r, err_msg="L")
    _close(port_bt._tri_unit_inv_logdepth(torch.as_tensor(np.array(L_r))).numpy(),
           Li_r, err_msg="inv(L)")
    safe = jnp.where(jnp.abs(dd_r) > jnp.finfo(dd_r.dtype).tiny, dd_r, 1.0)
    X = jnp.einsum("...ki,...kj->...ij", Li_r, Li_r / safe[..., None])
    X = jnp.einsum("...ij,...jk->...ik", X, 2.0 * jnp.eye(b) - jnp.einsum(
        "...ij,...jk->...ik", jnp.asarray(A), X))
    newton = port_bt.ldlt_inverse_newton(torch.as_tensor(A),
                                         torch.as_tensor(np.array(L_r)),
                                         torch.as_tensor(np.array(dd_r)))
    _close(newton.numpy(), X, err_msg="Newton inverse")


def _scenario(name="scen_mixed", args=()):
    """The reference's canonical scenario problem and the port's, built from
    the reference's arrays with the port's scenario callables."""
    cref = ref_scen.canonicalize_scenario(
        torch_cases.build(("scenario", name, args), "ref"), ipopt_tpu.Options())
    spec = torch_cases.SCENARIO_SPECS[name](torch, torch.stack, *args)
    arrays = {k: np.asarray(getattr(cref, k)) for k in
              ("x_L", "x_U", "d_L", "d_U", "has_xL", "has_xU", "has_dL",
               "has_dU", "c_rhs", "x_fixed", "x0", "x_L_orig", "x_U_orig",
               "obj_scale", "c_scale", "d_scale")}
    arrays["params"] = {"theta": {k: np.asarray(v) for k, v in
                                  cref.params["theta"].items()}}
    ar = cref.chain
    cp = convert.scenario_from_arrays(
        dataclasses.asdict(cref.struct), arrays,
        dict(S=ar.S, n0=ar.n0, ns=ar.ns, ms=ar.ms, eq_mask=ar.eq_mask),
        spec["f_scen"], spec["g_scen"], spec.get("f0"))
    return cref, cp


@pytest.mark.parametrize("name", ["stoch_qp", "scen_mixed"])
def test_canonicalize_scenario_matches_reference(name):
    cref = ref_scen.canonicalize_scenario(
        torch_cases.build(("scenario", name, ()), "ref"), ipopt_tpu.Options())
    cp = ipopt_torch.canonicalize_scenario(torch_cases.build(("scenario", name, ()),
                                                             "port"))
    ar_r, ar_p = cref.chain, cp.chain
    assert (ar_r.S, ar_r.n0, ar_r.ns, ar_r.ms, ar_r.bs) == \
        (ar_p.S, ar_p.n0, ar_p.ns, ar_p.ms, ar_p.bs)
    np.testing.assert_array_equal(ar_p.eq_mask, ar_r.eq_mask)
    s_r, s_p = cref.struct, cp.struct
    assert (s_r.n_full, s_r.n, s_r.m, s_r.me, s_r.mi) == \
        (s_p.n_full, s_p.n, s_p.m, s_p.me, s_p.mi)
    for k in ("eq_idx", "ineq_idx", "free_idx"):
        np.testing.assert_array_equal(getattr(s_p, k), getattr(s_r, k))
    for k in ("has_xL", "has_xU", "has_dL", "has_dU"):
        np.testing.assert_array_equal(getattr(cp, k)[0].numpy(),
                                      np.asarray(getattr(cref, k)))
    for k in ("x_L", "x_U", "d_L", "d_U", "c_rhs", "x0", "obj_scale", "c_scale",
              "d_scale"):
        _close(getattr(cp, k)[0].numpy(), np.asarray(getattr(cref, k)), err_msg=k)


def test_stochastic_qp_model_matches_reference_test():
    """``modellib.stochastic_qp`` (the problem chip_smoke.py runs at full
    size) is the reference tests' two-stage QP (tests/test_scenario.py:11)."""
    from test_scenario import stochastic_qp
    ref_sn, _, _ = stochastic_qp(S=6, ns=5, seed=3)
    cref = ref_scen.canonicalize_scenario(ref_sn, ipopt_tpu.Options())
    cp = ipopt_torch.canonicalize_scenario(modellib.stochastic_qp(6, 5, seed=3))
    for k in ("x_L", "x0", "c_rhs", "obj_scale", "c_scale"):
        _close(getattr(cp, k)[0].numpy(), np.asarray(getattr(cref, k)), err_msg=k)
    x = np.random.default_rng(0).standard_normal(cref.struct.n)
    _close(cp.eval_f(torch.as_tensor(x)[None])[0].item(), float(cref.eval_f(jnp.asarray(x))))
    _close(cp.eval_c(torch.as_tensor(x)[None])[0].numpy(), cref.eval_c(jnp.asarray(x)))


def _point(cref, seed, scale=1.0):
    blocks = _random_iterate(np.random.default_rng(seed), cref)
    blocks[2] = scale * blocks[2]
    blocks[3] = scale * blocks[3]
    return (RefIterate(*(jnp.asarray(b) for b in blocks)),
            convert.iterate_from_arrays(blocks))


def test_scenario_evaluations_match_reference():
    """Flat evaluations (the transpose products by VJP), the scenario
    Jacobians and Hessian blocks at a seeded point."""
    cref, cp = _scenario()
    it_r, it_p = _point(cref, 3)
    ev_r = ref_kkt.evaluate(cref, it_r.x)
    ev_p = port_kkt.evaluate(cp, it_p.x)
    for k in ("f", "grad_f", "c", "d"):
        _close(getattr(ev_p, k)[0], getattr(ev_r, k), err_msg=k)
    _close(port_kkt.jac_t(cp, ev_p, it_p.y_c, it_p.y_d)[0],
           ev_r.jc_t(it_r.y_c) + ev_r.jd_t(it_r.y_d), err_msg="J^T y")
    for a, b in zip(port_scen.scenario_jacobians(cp, it_p.x),
                    ref_scen.scenario_jacobians(cref, it_r.x)):
        _close(a[0], b)
    for a, b in zip(port_scen.scenario_hessians(cp, it_p.x, it_p.y_c, it_p.y_d),
                    ref_scen.scenario_hessians(cref, it_r.x, it_r.y_c, it_r.y_d)):
        _close(a[0], b)


def test_arrow_factorize_and_solve_match_reference():
    """The assembled blocks equal the reference's; the factorization has the
    same pivots, inertia and Schur root; a seeded right-hand side solves to
    1e-10, through the factorization and through the refined solve."""
    cref, cp = _scenario()
    it_r, it_p = _point(cref, 5)
    Jr = ref_scen.scenario_jacobians(cref, it_r.x)
    Wr = ref_scen.scenario_hessians(cref, it_r.x, it_r.y_c, it_r.y_d)
    Jp = tuple(torch.as_tensor(np.array(v))[None] for v in Jr)
    Wp = tuple(torch.as_tensor(np.array(v))[None] for v in Wr)
    dx, dc = 0.3, 1e-8
    Kr = ref_akkt.assemble_arrow(cref, it_r, Jr, Wr, dx, dc)
    one = torch.ones((1,), **F64)
    Kp = port_akkt.assemble_arrow(cp, it_p, Jp, Wp, dx * one, dc * one)
    for k in ("Ks", "Cs", "K0"):
        _close(getattr(Kp, k)[0], getattr(Kr, k), err_msg=k)
    fr = ref_akkt.arrow_factorize(Kr)
    calls = port_ldlt.ldlt.calls
    fp = port_akkt.arrow_factorize(Kp)
    assert port_ldlt.ldlt.calls == calls + 1          # the Schur root
    for k in ("num_pos", "num_neg", "num_zero", "singular"):
        assert int(getattr(fp, k)[0]) == int(getattr(fr, k)), k
    assert (int(fp.num_pos[0]), int(fp.num_neg[0])) == \
        port_akkt.expected_inertia_arrow(cp)
    _close(fp.ds[0][0], fr.ds, err_msg="ds")  # the one scenario group, lane 0
    _close(fp.root.d[0], fr.d0, rtol=1e-10, err_msg="Schur pivots")
    rng = np.random.default_rng(9)
    r0 = rng.standard_normal(cp.chain.n0)
    rs = rng.standard_normal((cp.chain.S, cp.chain.bs))
    w_r = ref_akkt.arrow_solve(fr, jnp.asarray(r0), jnp.asarray(rs))
    w_p = port_akkt.arrow_solve(fp, torch.as_tensor(r0)[None], torch.as_tensor(rs)[None])
    for a, b in zip(w_p, w_r):
        _close(a[0], b, rtol=1e-10)
    opts_r, opts_p = ipopt_tpu.Options(), ipopt_torch.Options()
    (w0r, wsr), rr_r = ref_akkt.arrow_solve_refined(Kr, fr, jnp.asarray(r0),
                                                    jnp.asarray(rs), opts_r)
    (w0p, wsp), rr_p = port_akkt.arrow_solve_refined(
        Kp, fp, torch.as_tensor(r0)[None], torch.as_tensor(rs)[None], opts_p)
    _close(w0p[0], w0r, rtol=1e-10)
    _close(wsp[0], wsr, rtol=1e-10)
    assert float(rr_p[0]) < 1e-12 and float(rr_r) < 1e-12


def test_arrow_factorize_kkt_matches_reference():
    """On an iterate whose multipliers make the scenario Hessians
    indefinite, the retry loop takes the same (delta_x, delta_c, trials)
    and ends at the wanted inertia."""
    cref, cp = _scenario()
    it_r, it_p = _point(cref, 11, scale=40.0)
    ropts, popts = ipopt_tpu.Options(), ipopt_torch.Options()
    Jr = ref_scen.scenario_jacobians(cref, it_r.x)
    Wr = ref_scen.scenario_hessians(cref, it_r.x, it_r.y_c, it_r.y_d)
    fr = ref_akkt.arrow_factorize_kkt(cref, ropts, it_r, Jr, Wr, jnp.asarray(0.1),
                                      jnp.asarray(0.0))
    Jp = port_scen.scenario_jacobians(cp, it_p.x)
    Wp = port_scen.scenario_hessians(cp, it_p.x, it_p.y_c, it_p.y_d)
    fp = port_akkt.arrow_factorize_kkt(cp, popts, it_p, Jp, Wp, torch.full((1,), 0.1, **F64),
                                       torch.zeros((1,), **F64))
    assert int(fp.num_trials[0]) == int(fr.num_trials) > 1
    for k in ("delta_x", "delta_c", "delta_w_last"):
        _close(float(getattr(fp, k)[0]), float(getattr(fr, k)), err_msg=k)
    assert bool(fp.failed[0]) == bool(fr.failed) is False
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(fp.fac, k)[0]) == int(getattr(fr.fac, k)), k


@pytest.mark.parametrize("name", torch_cases.suite_cases("arrow"))
def test_matches_recorded_reference(name):
    """stochastic_qp (S = 4, ns = 3) at (0, 6, 2.4251416748029166), its flat
    twin, the mixed problem, L-BFGS on the arrow backend (BFGS and SR1), and
    the arrow restoration (inconsistent scenario equalities: local
    infeasibility after one restoration)."""
    assert_matches_recorded(name, torch_cases.solve_port(name, {})[1])


def test_scenario_equals_flat():
    """The twin of tests/test_scenario.py::test_scenario_matches_flat on the
    port: the arrow solve and the dense solve of the flat problem agree."""
    res = torch_cases.solve_port("scen_qp", {})[0]
    flat = torch_cases.solve_port("scen_qp_flat", {})[0]
    assert int(res.status) == int(flat.status) == 0
    np.testing.assert_allclose(float(res.obj), float(flat.obj), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.x[:2].numpy(), flat.x[:2].numpy(), atol=1e-6)


@pytest.mark.gpu
def test_arrow_solve_on_cuda_launches_k1():
    """On the card the scenario blocks go through K1 (one launch for the
    blocks, one for the Schur root per factorization), and the solve equals
    the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ipopt_torch.linalg.block_ldlt import block_ldlt
    sn = modellib.stochastic_qp(64, 8)
    cpu = ipopt_torch.solve(sn, device="cpu", print_level=0)
    before = block_ldlt.launches
    gpu = ipopt_torch.solve(sn, device="cuda", print_level=0)
    assert block_ldlt.launches - before == 2 * int(gpu.counters.n_factorizations)
    assert (int(gpu.status), int(gpu.iter_count)) == (int(cpu.status), int(cpu.iter_count))
    np.testing.assert_allclose(float(gpu.obj), float(cpu.obj), rtol=1e-9)
