"""The nested-dissection multifrontal backend of the PyTorch port
(ipopt_torch/linalg/nested_dissection.py and its half of
ipopt_torch/sparse.py) against the JAX reference
(ipopt_tpu/linalg/nested_dissection.py), in float64 on the CPU:

- the symbolic analysis field by field, the restoration NLP's included,
  and carried over by ``convert.nd_info_from_reference``;
- the numeric phase on the reference's own inputs (its default iterate and
  its compressed derivative values): assembly, the deltas, the level-batched
  factorization (L11, d1, L21 and the inertia), the solve, the product and
  the refined solve;
- the exactness of a factorize + solve against the assembled product;
- whole solves against the reference's recorded results
  (tests/torch_cases.py, suite "nd"; tools/torch_reference_values.py);
- limited-memory Hessians on this backend: refused, as by the reference.

Tolerances: index arrays and sizes exactly equal; the assembly exactly
equal (it gathers and sums the same values); the factorization and the
solves rtol 1e-12 of the largest entry of each compared array (the Schur
products sum in another order than XLA's); the inertia exactly equal;
recorded solves as in test_torch_adaptive.py (status, iterations,
factorizations, KKT solves and restorations equal, objective rtol 1e-9).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import modellib as ref_models
from ipopt_tpu import sparse as ref_sparse
from ipopt_tpu.linalg import nested_dissection as ref_nd
from ipopt_tpu.algorithm.init import default_initialize as ref_default_init

import ipopt_torch
from ipopt_torch import convert, modellib
from ipopt_torch import sparse as port_sparse
from ipopt_torch.linalg import nested_dissection as port_nd

import torch_cases
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)

CASES = ("mitt8", "3d6", "lv1", "hs071")


def _problems(case):
    if case.startswith("mitt"):
        N = int(case[4:])
        return ref_models.mittelmann_dist_control(N), modellib.mittelmann_dist_control(N)
    if case.startswith("3d"):
        N = int(case[2:])
        return (ref_models.mittelmann_dist_control_3d(N),
                modellib.mittelmann_dist_control_3d(N))
    if case == "lv1":
        return ref_models.luksan_vlcek1_flat(64), modellib.luksan_vlcek1_flat(64)
    # the sparse HS071 of tests/test_nested_dissection.py:95-106
    return ref_models.hs071(), modellib.hs071()


def _canonical(case, **kw):
    ref_p, port_p = _problems(case)
    o = dict(linear_solver="multifrontal", print_level=0, **kw)
    return (ref_sparse.canonicalize_sparse(ref_p, ipopt_tpu.Options(**o)),
            port_sparse.canonicalize_sparse(port_p, ipopt_torch.Options(**o)))


_INTS = ("n", "mi", "me", "N", "n_colors_j", "n_colors_h", "total_slots",
         "n_pad_elim", "n_vals")
_ARRAYS = ("j_rows", "j_cols", "j_colors", "h_rows", "h_cols", "h_colors",
           "row_unknown", "asm_src", "asm_inv")
_LEVEL_ARRAYS = ("elim_gid", "bd_gid", "child_scatter", "diag_kind")


def _assert_info_equal(ip, ir):
    for k in _INTS:
        assert getattr(ip, k) == getattr(ir, k), k
    assert tuple(tuple(lv) for lv in ip.levels) == tuple(tuple(lv) for lv in ir.levels)
    for k in _ARRAYS:
        a, b = getattr(ip, k), np.asarray(getattr(ir, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in _LEVEL_ARRAYS:
        assert len(getattr(ip, k)) == len(getattr(ir, k)), k
        for li, (a, b) in enumerate(zip(getattr(ip, k), getattr(ir, k))):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{k}{li}")


@pytest.mark.parametrize("case", CASES)
def test_symbolic_analysis_matches_reference(case):
    """Every field of NDInfo equals the reference's, the restoration NLP's
    too; the reference's analysis carried over by convert equals the port's."""
    cref, cp = _canonical(case)
    ir, ip = cref.chain, cp.chain
    assert isinstance(ip, port_nd.NDInfo)
    _assert_info_equal(ip, ir)
    assert ip.resto is not None and ir._resto_info is not None
    _assert_info_equal(ip.resto, ir._resto_info)
    assert ip.resto.resto is None
    carried = convert.nd_info_from_reference(ir)
    assert carried == ip and carried.resto == ip.resto
    _assert_info_equal(carried, ir)
    if case == "3d6":
        assert len(ip.levels) == 6 and ip.N == 648


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _numeric_inputs(case, dx, dc):
    cref, cp = _canonical(case, resto_phase=False)
    o = ipopt_tpu.Options(linear_solver="multifrontal", print_level=0, resto_phase=False)
    it_r = ref_default_init(cref, o)
    it_p = convert.iterate_from_arrays([np.asarray(v) for v in it_r])
    jv = np.asarray(jax.jit(lambda x: ref_sparse.jacobian_values(cref, x))(it_r.x))
    hv = np.asarray(jax.jit(lambda it: ref_sparse.sparse_hessian_values(cref, it))(it_r))
    np.testing.assert_allclose(port_sparse.jacobian_values(cp, it_p.x)[0].numpy(), jv,
                               rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(port_sparse.sparse_hessian_values(cp, it_p)[0].numpy(), hv,
                               rtol=1e-14, atol=1e-300)
    info_r, info_p = cref.chain, cp.chain
    aux_r, aux_p = cref.aux_arrays, port_nd.nd_aux(info_p, "cpu")
    zero_r = jnp.zeros(())
    F_r = jax.jit(lambda it, j, h: ref_nd.nd_assemble(cref, aux_r, info_r, it, j, h,
                                                      zero_r, zero_r))(
        it_r, jnp.asarray(jv), jnp.asarray(hv))
    zero_p = torch.zeros((1,), dtype=torch.float64)
    F_p = port_nd.nd_assemble(cp, aux_p, info_p, it_p, torch.as_tensor(jv)[None],
                              torch.as_tensor(hv)[None], zero_p, zero_p)
    for a, b in zip(F_p, F_r):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    K_r = jax.jit(ref_nd.nd_add_diag_deltas, static_argnums=0)(
        info_r, aux_r, F_r, jnp.asarray(dx), jnp.asarray(dc))
    K_p = port_nd.nd_add_diag_deltas(info_p, aux_p, F_p, dx + zero_p, dc + zero_p)
    for a, b in zip(K_p, K_r):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    return (cref, info_r, aux_r, K_r), (cp, info_p, aux_p, K_p)


@pytest.mark.parametrize("case", ("mitt8", "3d6", "hs071"))
def test_numeric_phase_matches_reference(case):
    """nd_assemble and nd_add_diag_deltas exactly; nd_factorize's L11, d1
    and L21 to rtol 1e-12 with the same inertia; nd_solve, nd_matvec and
    nd_solve_refined to rtol 1e-12, at the reference's default iterate."""
    dx, dc = 0.37, 0.011
    (cref, info_r, aux_r, K_r), (cp, info_p, aux_p, K_p) = _numeric_inputs(case, dx, dc)
    fac_r = jax.jit(ref_nd.nd_factorize, static_argnums=0)(info_r, aux_r, K_r)
    fac_p = port_nd.nd_factorize(info_p, aux_p, K_p)
    for li in range(len(info_p.levels)):
        _close(fac_p.L11[li][0].numpy(), fac_r.L11[li])
        _close(fac_p.d1[li][0].numpy(), fac_r.d1[li])
        _close(fac_p.L21[li][0].numpy(), fac_r.L21[li])
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(fac_p, k)[0]) == int(getattr(fac_r, k)), k
    assert bool(fac_p.singular[0]) == bool(fac_r.singular)

    rhs = np.random.default_rng(7).standard_normal(info_p.N)
    _close(port_nd.nd_solve(info_p, aux_p, fac_p, torch.as_tensor(rhs)[None])[0].numpy(),
           jax.jit(ref_nd.nd_solve, static_argnums=0)(info_r, aux_r, fac_r,
                                                      jnp.asarray(rhs)))
    _close(port_nd.nd_matvec(info_p, aux_p, K_p, torch.as_tensor(rhs)[None])[0].numpy(),
           jax.jit(ref_nd.nd_matvec, static_argnums=0)(info_r, aux_r, K_r,
                                                       jnp.asarray(rhs)))
    o_r = ipopt_tpu.Options(linear_solver="multifrontal")
    sol_r, rr_r = jax.jit(ref_nd.nd_solve_refined, static_argnums=(0, 5))(
        info_r, aux_r, K_r, fac_r, jnp.asarray(rhs), o_r)
    sol_p, rr_p = port_nd.nd_solve_refined(info_p, aux_p, K_p, fac_p,
                                           torch.as_tensor(rhs)[None],
                                           ipopt_torch.Options(linear_solver="multifrontal"))
    _close(sol_p[0].numpy(), sol_r)
    assert float(rr_p[0]) <= o_r.residual_ratio_max and float(rr_r) <= o_r.residual_ratio_max


def test_nd_factorize_solve_exact():
    """tests/test_nested_dissection.py::test_nd_factorize_solve_exact on the
    port: a strongly quasi-definite regularization (delta_x = 1, delta_c =
    1e-2) gives the inertia (n + mi, me + mi) exactly, and solving K v's
    product gives v back to 1e-8."""
    from ipopt_torch.algorithm.init import default_initialize
    cp = port_sparse.canonicalize_sparse(
        modellib.mittelmann_dist_control(8),
        ipopt_torch.Options(linear_solver="multifrontal", resto_phase=False))
    info = cp.chain
    opts = ipopt_torch.Options(linear_solver="multifrontal", resto_phase=False)
    it = default_initialize(cp, opts)
    aux = port_nd.nd_aux(info, "cpu")
    jv = port_sparse.jacobian_values(cp, it.x)
    hv = port_sparse.sparse_hessian_values(cp, it)
    one = torch.ones((1,), dtype=torch.float64)
    F = port_nd.nd_assemble(cp, aux, info, it, jv, hv, 0 * one, 0 * one)
    F = port_nd.nd_add_diag_deltas(info, aux, F, one, 1e-2 * one)
    v = torch.as_tensor(np.random.RandomState(0).standard_normal(info.N))[None]
    Kv = port_nd.nd_matvec(info, aux, F, v)
    fac = port_nd.nd_factorize(info, aux, F)
    assert not bool(fac.singular[0])
    sol = port_nd.nd_solve(info, aux, fac, Kv)
    np.testing.assert_allclose(sol.numpy(), v.numpy(), atol=1e-8)
    assert int(fac.num_pos[0]) == info.n + info.mi
    assert int(fac.num_neg[0]) == info.me + info.mi


def test_extend_add_passes_never_repeat_a_slot():
    """Within one sibling pass no two children add into one parent slot, so
    the extend-add is the same on every device; each non-root child is in
    exactly one pass."""
    cp = port_sparse.canonicalize_sparse(
        modellib.mittelmann_dist_control_3d(6),
        ipopt_torch.Options(linear_solver="multifrontal", resto_phase=False))
    info = cp.chain
    aux = port_nd.nd_aux(info, "cpu")
    for li in range(len(info.levels) - 1):
        plv = info.levels[li + 1]
        dump = plv.n_nodes * plv.f * plv.f
        nodes_seen = []
        for nodes_, idx in aux[f"extend_add{li}"]:
            live = idx[idx < dump]
            assert live.unique().numel() == live.numel()
            nodes_seen += nodes_.tolist()
        assert sorted(nodes_seen) == sorted(set(nodes_seen))
        if info.levels[li].u:
            assert len(nodes_seen) == info.levels[li].n_nodes


@pytest.fixture(scope="module")
def iterates():
    return {}


@pytest.mark.parametrize("name", torch_cases.suite_cases("nd"))
def test_matches_recorded_reference(name, iterates):
    """3-D control N = 6 and 10, LV1 flat 64, the 2-D control N = 12, the
    sparse HS071, the restoration analysis case and an infeasible problem
    that runs the restoration on this backend."""
    _, rec = torch_cases.solve_port(name, iterates)
    assert_matches_recorded(name, rec)


def test_limited_memory_refused_as_by_the_reference():
    """The reference's structured SMW (lowrank_struct._base_solvers,
    _base_factor) has no multifrontal branch: a limited-memory solve on
    this backend raises ValueError there, and so it does in the port."""
    kw = dict(linear_solver="multifrontal", hessian_approximation="limited-memory",
              print_level=0)
    with pytest.raises(ValueError, match="unknown structured backend"):
        ipopt_tpu.solve(ref_models.mittelmann_dist_control_3d(3), **kw)
    with pytest.raises(ValueError, match="no structured base system for the nd"):
        ipopt_torch.solve(modellib.mittelmann_dist_control_3d(3), device="cpu", **kw)


def test_batches_refused():
    cp = port_sparse.canonicalize_sparse(
        modellib.luksan_vlcek1_flat(8), ipopt_torch.Options(linear_solver="multifrontal"))
    with pytest.raises(ValueError, match="one problem at a time"):
        ipopt_torch.stack_problems([cp, cp])
    with pytest.raises(ValueError, match="one problem at a time"):
        ipopt_torch.stack_problems([modellib.luksan_vlcek1_flat(8)] * 2,
                                   ipopt_torch.Options(linear_solver="multifrontal"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_on_the_level_stacks_matches_plain(cuda):
    """K1 on every level stack of a 3-D N = 6 factorization equals its plain
    version bit for bit (NaN in the same places), but for the float64
    blocked variant's level (the top front, 106 wide), held by
    ``block_ldlt.k1_rule``."""
    from ipopt_torch.linalg.block_ldlt import block_ldlt, block_ldlt_plain, k1_rule, plan
    from ipopt_torch.profile_main import capture_k1_inputs
    (_, _, _, _), (cp, info, aux, K) = _numeric_inputs("3d6", 0.0, 1e-8)
    seen = capture_k1_inputs(lambda: port_nd.nd_factorize(info, aux, K))
    assert len(seen) == len(info.levels)
    for A in seen:
        L, d = block_ldlt(A.to(cuda))
        Lp, dp = block_ldlt_plain(A)
        if plan(A.shape[0], A.shape[-1], A.dtype).variant == "blocked":
            ok, why, _ = k1_rule(A, L.cpu(), d.cpu(), Lp, dp)
            assert ok, why
            continue
        assert torch.equal(L.cpu().nan_to_num(7.0), Lp.nan_to_num(7.0))
        assert torch.equal(d.cpu().nan_to_num(7.0), dp.nan_to_num(7.0))
