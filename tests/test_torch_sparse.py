"""The general-sparsity banded backend of the PyTorch port
(ipopt_torch/sparse.py, algorithm/banded_resto.py) against the JAX
reference (ipopt_tpu/sparse.py), in float64 on the CPU: the symbolic
analysis field by field (restoration analysis included), the compressed
derivatives, the gather assembly (against the reference's and against the
permuted dense augmented KKT), the inertia-corrected factorization, whole
solves with their per-iteration trace, and the banded restoration.

Problems: LuksanVlcek1 flat (declared band pattern), the 2-D Mittelmann
distributed control (declared grid pattern) and HS071 (pattern detected by
dense AD probing; one inequality, so the s <-> y_d couplings).  Inputs come
from numpy and go to both packages.  Tolerances: index arrays and sizes
exactly equal; values from the same formulas rtol 1e-14 (compressed
derivatives, scalings) or exactly equal (the assembly gathers and sums the
same two values); the dense comparison rtol 1e-14, atol 1e-13 (the dense W and J come
from other AD passes); solves: equal status, iteration and factorization
counts, trace rtol 1e-7, x and objective rtol 1e-9.  The trace solves run
both packages with ``resto_phase=False``, which halves the reference's
compile time and leaves the main path as it is (neither solve enters
restoration); the restoration runs in its own test.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import modellib as ref_models
from ipopt_tpu import sparse as ref_sparse
from ipopt_tpu.types import Iterate as RefIterate, SolverReturn

import ipopt_torch
from ipopt_torch import convert, kkt as port_kkt, modellib
from ipopt_torch import sparse as port_sparse
from test_torch_core import _random_iterate
import torch_cases

torch.set_num_threads(1)

OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, linear_solver="banded-bcr")
CASES = ("lv1", "mitt", "hs071")


def _problems(case):
    if case == "lv1":
        return ref_models.luksan_vlcek1_flat(200), modellib.luksan_vlcek1_flat(200)
    if case == "mitt":
        return ref_models.mittelmann_dist_control(6), modellib.mittelmann_dist_control(6)
    return ref_models.hs071(), modellib.hs071()


def _canonical(case, **kw):
    ref_p, port_p = _problems(case)
    cref = ref_sparse.canonicalize_sparse(ref_p, ipopt_tpu.Options(**OPTS, **kw))
    cp = port_sparse.canonicalize_sparse(port_p, ipopt_torch.Options(**OPTS, **kw))
    return cref, cp


_INFO_ARRAYS = ("perm", "pos", "j_rows", "j_cols", "j_colors", "h_rows", "h_cols",
                "h_colors", "row_unknown", "asm_slot", "asm_src", "asm_inv", "diag_kind")
_INFO_INTS = ("n", "mi", "me", "N", "b", "nb", "n_pad", "n_colors_j", "n_colors_h",
              "n_vals")
_MASKS = (("h_keep", "_h_keep_mask"), ("j_mirror", "_j_mirror_mask"),
          ("s_mirror", "_s_mirror_mask"))


def _assert_info_equal(ip, ir):
    for k in _INFO_INTS:
        assert getattr(ip, k) == getattr(ir, k), k
    for k in _INFO_ARRAYS:
        np.testing.assert_array_equal(getattr(ip, k), np.asarray(getattr(ir, k)), err_msg=k)
    for k, kr in _MASKS:
        a, b = getattr(ip, k), getattr(ir, kr)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_symbolic_analysis_matches_reference(case):
    """perm, pos, b, nb, n_pad, colourings, gather indices, diagonal kinds
    and masks equal the reference's, the restoration NLP's too; the port's
    analysis equals the reference's carried over by convert; the canonical
    arrays (bounds, gradient scaling) agree."""
    cref, cp = _canonical(case)
    ir, ip = cref.chain, cp.chain
    _assert_info_equal(ip, ir)
    assert ip.resto is not None and ir._resto_info is not None
    _assert_info_equal(ip.resto, ir._resto_info)
    assert ip.resto.resto is None
    carried = convert.banded_info_from_reference(ir)
    assert carried == ip and carried.resto == ip.resto
    for k, _ in _MASKS:
        a, b = getattr(carried, k), getattr(ip, k)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), k
    if case == "lv1":
        assert (ip.b, ip.nb, ip.n_colors_j, ip.n_colors_h) == (8, 50, 3, 5)
    for k in ("x_L", "x_U", "d_L", "d_U", "c_rhs", "x0", "obj_scale", "c_scale",
              "d_scale"):
        np.testing.assert_allclose(getattr(cp, k)[0].numpy(), np.asarray(getattr(cref, k)),
                                   rtol=1e-14, atol=0, err_msg=k)
    for k in ("has_xL", "has_xU", "has_dL", "has_dU"):
        np.testing.assert_array_equal(getattr(cp, k)[0].numpy(), np.asarray(getattr(cref, k)))


def test_no_resto_analysis_without_resto_phase():
    _, cp = _canonical("hs071", resto_phase=False)
    assert cp.chain.resto is None


def _iterates(rng, cref):
    blocks = _random_iterate(rng, cref)
    it_r = RefIterate(*(jnp.asarray(b) for b in blocks))
    return it_r, convert.iterate_from_arrays(blocks)


@pytest.mark.parametrize("case", CASES)
def test_values_and_assembly_match_reference(case):
    """Compressed Jacobian and Hessian values on a seeded iterate (rtol
    1e-14); the assembled block arrays equal the reference's elementwise and,
    densified and unpermuted, the port's dense augmented KKT."""
    cref, cp = _canonical(case)
    it_r, it_p = _iterates(np.random.default_rng(3), cref)
    jv_r = np.asarray(ref_sparse.jacobian_values(cref, it_r.x))
    hv_r = np.asarray(ref_sparse.sparse_hessian_values(cref, it_r))
    jv_p = port_sparse.jacobian_values(cp, it_p.x)
    hv_p = port_sparse.sparse_hessian_values(cp, it_p)
    np.testing.assert_allclose(jv_p[0].numpy(), jv_r, rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(hv_p[0].numpy(), hv_r, rtol=1e-14, atol=1e-300)

    dx, dc = 0.37, 0.011
    Kr = ref_sparse.assemble_banded(cref, it_r, jnp.asarray(jv_r), jnp.asarray(hv_r), dx, dc)
    one = torch.ones((1,), dtype=torch.float64)
    Kp = port_sparse.assemble_banded(cp, it_p, torch.as_tensor(jv_r)[None],
                                     torch.as_tensor(hv_r)[None], dx * one, dc * one)
    np.testing.assert_array_equal(Kp.diag[0].numpy(), np.asarray(Kr.diag))
    np.testing.assert_array_equal(Kp.sub[0].numpy(), np.asarray(Kr.sub))

    info = cp.chain
    Kd = Kp.to_dense()[0].numpy()[:info.N, :info.N]
    Kun = np.empty_like(Kd)
    Kun[np.ix_(info.perm, info.perm)] = Kd
    J_c, J_d = cp.eval_jac_cd(it_p.x)
    W = cp.eval_lag_hess(it_p.x, it_p.y_c, it_p.y_d)
    sig = port_kkt.sigmas(cp, it_p)
    K_dense = port_kkt.assemble_aug_system(W, J_c, J_d, sig, dx * one, dx * one,
                                           dc * one, dc * one)[0].numpy()
    np.testing.assert_allclose(Kun, K_dense, rtol=1e-14, atol=1e-13)
    # the retry loop's diagonal re-add equals a fresh assembly up to the
    # order of the sums on the diagonal (H + (sigma + dx) against (H + sigma) + dx)
    zero = 0.0 * one
    K0 = port_sparse.assemble_banded(cp, it_p, torch.as_tensor(jv_r)[None],
                                     torch.as_tensor(hv_r)[None], zero, zero)
    K1 = port_sparse.add_diag_deltas(cp, K0, dx * one, dc * one)
    np.testing.assert_allclose(K1.diag.numpy(), Kp.diag.numpy(), rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(K1.sub.numpy(), Kp.sub.numpy())


@pytest.mark.parametrize("case,scale", [("mitt", 30.0), ("hs071", 30.0)])
def test_factorize_kkt_matches_reference(case, scale):
    """On an iterate whose multipliers make the Hessian indefinite, the
    retry loop takes the same (delta_x, delta_c, num_trials) and ends with
    the same inertia; the factorizations solve the same system."""
    cref, cp = _canonical(case)
    rng = np.random.default_rng(11)
    blocks = _random_iterate(rng, cref)
    blocks[2] = scale * blocks[2]
    blocks[3] = scale * blocks[3]
    it_r = RefIterate(*(jnp.asarray(b) for b in blocks))
    it_p = convert.iterate_from_arrays(blocks)
    ropts = ipopt_tpu.Options(**OPTS)
    popts = ipopt_torch.Options(**OPTS)
    hv_r = ref_sparse.sparse_hessian_values(cref, it_r)
    mu = 0.1
    fr = ref_sparse.banded_factorize_kkt(cref, ropts, it_r, hv_r, jnp.asarray(mu),
                                         jnp.asarray(0.0))
    hv_p = port_sparse.sparse_hessian_values(cp, it_p)
    f64 = dict(dtype=torch.float64)
    fp = port_sparse.banded_factorize_kkt(cp, popts, it_p, hv_p, torch.full((1,), mu, **f64),
                                          torch.zeros((1,), **f64))
    assert int(fp.num_trials[0]) == int(fr.num_trials) > 1
    for k in ("delta_x", "delta_c", "delta_w_last"):
        np.testing.assert_allclose(float(getattr(fp, k)[0]), float(getattr(fr, k)),
                                   rtol=1e-14, err_msg=k)
    assert bool(fp.failed[0]) == bool(fr.failed)
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(fp.fac, k)[0]) == int(getattr(fr.fac, k)), k
    exp_pos, exp_neg = port_sparse.expected_inertia_banded(cp)
    assert (int(fp.fac.num_pos[0]), int(fp.fac.num_neg[0])) == (exp_pos, exp_neg)
    # one solve through both factorizations, packed and unpacked
    parts = [rng.standard_normal(k) for k in (cp.n, cp.mi, cp.me, cp.mi)]
    from ipopt_tpu.algorithm.step import solve_any as ref_solve_any
    from ipopt_torch.algorithm.step import solve_any as port_solve_any
    sol_r, _ = ref_solve_any(cref, ropts, fr.fac, fr.K, tuple(jnp.asarray(p) for p in parts))
    sol_p, _ = port_solve_any(cp, popts, fp.fac, fp.K,
                              tuple(torch.as_tensor(p)[None] for p in parts))
    for a, b in zip(sol_p, sol_r):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)


def _trace():
    rows = []

    def cb(iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr, alpha_du, **_):
        rows.append((iter_count, obj_value, inf_pr, inf_du, mu, alpha_pr, alpha_du))
        return True

    return rows, cb


@pytest.fixture(scope="module")
def ref_solves():
    """The reference's solves, each with its per-iteration trace, made once
    per module and problem."""
    done = {}

    def get(case):
        if case not in done:
            rows, cb = _trace()
            res = ipopt_tpu.solve(_problems(case)[0], print_level=0, resto_phase=False,
                                  intermediate_callback=cb, **OPTS)
            done[case] = (res, rows)
        return done[case]

    return get


# the reference's values of these solves (ipopt_tpu.solve on the CPU,
# float64, the options above): (status, iterations, factorizations)
REF_COUNTS = {"lv1": (0, 6, 6), "mitt": (0, 15, 39)}


@pytest.mark.parametrize("case", ["lv1", "mitt"])
def test_banded_solve_matches_reference(case, ref_solves):
    res_r, rows_r = ref_solves(case)
    rows_p, cb_p = _trace()
    res_p = ipopt_torch.solve(_problems(case)[1], device="cpu", print_level=0,
                              resto_phase=False, intermediate_callback=cb_p, **OPTS)
    got = (int(res_p.status), int(res_p.iter_count), int(res_p.counters.n_factorizations))
    assert got == (int(res_r.status), int(res_r.iter_count),
                   int(res_r.counters.n_factorizations)) == REF_COUNTS[case]
    assert res_p.batched_factorizations == got[2]
    t_p, t_r = np.array(rows_p), np.array(rows_r)
    np.testing.assert_array_equal(t_p[:, 0], t_r[:, 0])
    np.testing.assert_allclose(t_p[:, 1:], t_r[:, 1:], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(res_p.x.numpy(), np.asarray(res_r.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(res_p.obj), float(res_r.obj), rtol=1e-9)


def test_banded_solve_with_mc19_matches_reference():
    """Mittelmann's distributed control at N = 12 with the symmetric
    equilibration of every BCR level (linear_system_scaling="mc19"): the
    same status, iterations and factorizations as the reference (0, 16, 39),
    the trace to rtol 1e-7 and the objective to 1e-9; the reference's solve
    is the one recorded by tools/torch_reference_values.py
    ("mitt12_mc19_trace")."""
    kw = dict(OPTS, resto_phase=False, linear_system_scaling="mc19")
    ref = torch_cases.recorded()["mitt12_mc19_trace"]
    rows_p, cb_p = _trace()
    res_p = ipopt_torch.solve(modellib.mittelmann_dist_control(12), device="cpu",
                              print_level=0, intermediate_callback=cb_p, **kw)
    got = [(int(res_p.status), int(res_p.iter_count),
            int(res_p.counters.n_factorizations)),
           (ref["status"], ref["iter_count"], ref["n_factorizations"])]
    assert got[0] == got[1] == (0, 16, 39)
    t_p, t_r = np.array(rows_p), np.array(ref["trace"])
    np.testing.assert_allclose(t_p[:, 1:], t_r[:, 1:], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res_p.obj), ref["obj"], rtol=1e-9)


def _infeasible(pkg):
    """tests/test_sparse_backend.py:146-163: a consistent chain plus the
    rows x0 = 1 and x0 = -1 (n = 12)."""
    n = 12
    if pkg == "ref":
        def g(x):
            chain = x[:-2] + x[1:-1] - 2.0 * x[2:]
            return jnp.concatenate([chain, jnp.array([x[0] - 1.0, x[0] + 1.0])])
        return ipopt_tpu.NLP(f=lambda x: jnp.sum((x - 0.5) ** 2), g=g, g_L=np.zeros(n),
                             g_U=np.zeros(n), x0=np.full(n, 0.5), x_L=-3.0, x_U=3.0)

    def g(x):
        chain = x[:-2] + x[1:-1] - 2.0 * x[2:]
        return torch.cat([chain, torch.stack([x[0] - 1.0, x[0] + 1.0])])
    return ipopt_torch.NLP(f=lambda x: ((x - 0.5) ** 2).sum(), g=g, g_L=np.zeros(n),
                           g_U=np.zeros(n), x0=np.full(n, 0.5), x_L=-3.0, x_U=3.0)


def test_banded_restoration_detects_infeasibility():
    """The banded restoration (the restoration NLP keeps the sparse
    structure) ends in LOCAL_INFEASIBILITY with the reference's iteration
    and restoration counts; the restoration's own analysis was used."""
    res_r = ipopt_tpu.solve(_infeasible("ref"), print_level=0, tol=1e-8,
                            linear_solver="banded-bcr")
    calls = []
    from ipopt_torch.algorithm import banded_resto
    inner = banded_resto.build_resto_banded

    def spy(orig, opts):
        r = inner(orig, opts)
        calls.append(r.chain)
        return r

    banded_resto.build_resto_banded = spy
    try:
        res_p = ipopt_torch.solve(_infeasible("port"), device="cpu", print_level=0,
                                  tol=1e-8, linear_solver="banded-bcr")
    finally:
        banded_resto.build_resto_banded = inner
    assert int(res_r.status) == int(res_p.status) == int(SolverReturn.LOCAL_INFEASIBILITY)
    assert int(res_p.restoration_count) == int(res_r.restoration_count) > 0
    assert int(res_p.iter_count) == int(res_r.iter_count)
    assert calls and all(isinstance(c, port_sparse.BandedInfo) and c.resto is None
                         for c in calls)


def test_banded_options_and_batches():
    """banded-bcr and multifrontal are admitted, also with chain_shard=True
    (which, as in the reference, only the chained backend reads); stacking
    banded problems is refused with a clear error; the entry point defaults
    to the card."""
    from ipopt_torch.algorithm.solver import check_supported
    check_supported(ipopt_torch.Options(linear_solver="banded-bcr"))
    check_supported(ipopt_torch.Options(linear_solver="multifrontal"))
    check_supported(ipopt_torch.Options(linear_solver="banded-bcr", chain_shard=True))
    with pytest.raises(ValueError, match="one problem at a time"):
        ipopt_torch.stack_problems([modellib.luksan_vlcek1_flat(8)] * 2,
                                   ipopt_torch.Options(linear_solver="banded-bcr"))
    cp = port_sparse.canonicalize_sparse(modellib.luksan_vlcek1_flat(8))
    with pytest.raises(ValueError, match="one problem at a time"):
        ipopt_torch.stack_problems([cp, cp])


def test_banded_solve_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipopt_torch.solve(modellib.luksan_vlcek1_flat(8), linear_solver="banded-bcr")


def test_capture_k2_inputs_on_the_banded_path():
    """Every K2 input of a banded solve, in order: luksan_vlcek1_flat(200)
    has 50 blocks of 8, so levels ne = 25, 13, 7 and 4 (the last three
    chains padded), 2, 1 and the root per factorization."""
    from ipopt_torch.profile_main import capture_k2_inputs
    res = []
    inputs = capture_k2_inputs(lambda: res.append(ipopt_torch.solve(
        modellib.luksan_vlcek1_flat(200), device="cpu", print_level=0, **OPTS)))
    shapes = [(ne, 8, 8) for ne in (25, 13, 7, 4, 2, 1, 1)]
    assert int(res[0].status) == 0
    assert [tuple(A.shape) for A in inputs] == shapes * res[0].batched_factorizations


def _backward_error(A, X):
    """Normwise backward error of an inverse per block:
    ||A X - I|| / (||A|| ||X||) in the infinity norm."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype)
    ninf = lambda M: torch.linalg.matrix_norm(M, ord=float("inf"))
    return ninf(A @ X - eye) / (ninf(A) * ninf(X)).clamp(min=1e-300)


def test_unpivoted_sweep_on_mittelmann_blocks_is_the_reference_s():
    """Mittelmann's KKT blocks are where the unpivoted sweep every BCR level
    runs (the reference's ``_gj_inv_auto``) stops being backward stable:
    at N = 12 (56-wide blocks) its normwise backward error reaches ~1e-9,
    five orders above b eps, and two equally valid orders of the same sweep
    (the port's plain version on A, and on A^T transposed back) differ by
    ~6% in the inverse.  The port's plain version is held to the reference's
    sweep the only way that means anything there: the same pivot signs, and
    per block a backward error within 10x of the larger of the reference's
    and the A^T order's (the same rule chip_smoke.py holds K2 to on the
    card at N = 100)."""
    from ipopt_torch.linalg import block_ldlt_inv as k2
    from ipopt_torch.profile_main import capture_k2_inputs
    from ipopt_tpu.linalg import block_tridiag as ref_bt
    inputs = capture_k2_inputs(lambda: ipopt_torch.solve(
        modellib.mittelmann_dist_control(12), device="cpu", print_level=0, max_iter=6,
        **OPTS))
    A = torch.cat([X for X in inputs if X.shape[0] > 1])
    b = A.shape[-1]
    assert b == 56
    d_p, X_p = k2.block_ldlt_inv_plain(A)
    d_t, X_t = k2.block_ldlt_inv_plain(A.transpose(1, 2).contiguous())
    X_r, d_r = ref_bt._gj_inv_auto(jnp.asarray(A.numpy().transpose(1, 2, 0)))
    X_r = torch.as_tensor(np.array(X_r).transpose(2, 0, 1))
    d_r = torch.as_tensor(np.array(d_r).T)
    be_p, be_t, be_r = (_backward_error(A, X) for X in (X_p, X_t.transpose(1, 2), X_r))
    floor = b * torch.finfo(torch.float64).eps
    # the finding: far from backward stable, and the orders disagree
    assert float(be_r.max()) > 1e4 * floor and float(be_p.max()) > 1e4 * floor
    spread = ((X_t.transpose(1, 2) - X_p).abs().amax((1, 2)) / X_p.abs().amax((1, 2)))
    assert float(spread.max()) > 1e-3
    # the port's plain version against the reference's sweep
    torch.testing.assert_close(torch.sign(d_p), torch.sign(d_r), rtol=0, atol=0)
    assert bool((be_p <= 10 * torch.clamp(torch.maximum(be_r, be_t), min=floor)).all())
    assert bool((be_r <= 10 * torch.clamp(torch.maximum(be_p, be_t), min=floor)).all())


def test_band_sparsity_matches_reference():
    for args in ((198, 200, 0, 2), (200, 200, -2, 2), (5, 3, -1, 1)):
        for a, b in zip(modellib.band_sparsity(*args), ref_models.band_sparsity(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_banded_solve_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = modellib.luksan_vlcek1_flat(2000)
    r_card = ipopt_torch.solve(prob, device="cuda", print_level=0, **OPTS)
    r_cpu = ipopt_torch.solve(prob, device="cpu", print_level=0, **OPTS)
    assert (int(r_card.status), int(r_card.iter_count)) == (int(r_cpu.status),
                                                            int(r_cpu.iter_count))
    np.testing.assert_allclose(float(r_card.obj), float(r_cpu.obj), rtol=1e-10)


def reference_mittelmann(N=100):
    """The reference's float64 solve of ``mittelmann_dist_control(N)`` at
    OPTS (restoration on) on JAX's default device; prints one JSON line with
    its status, counts, objective and per-iteration trace."""
    import json
    import time
    import jax
    jax.config.update("jax_enable_x64", True)
    rows, cb = _trace()
    t0 = time.perf_counter()
    res = ipopt_tpu.solve(ref_models.mittelmann_dist_control(N), print_level=0,
                          intermediate_callback=cb, **OPTS)
    obj = float(res.obj)
    wall = time.perf_counter() - t0
    print(json.dumps(dict(
        N=N, device=str(jax.devices()[0]), jax=jax.__version__, options=OPTS,
        status=int(res.status), iterations=int(res.iter_count),
        factorizations=int(res.counters.n_factorizations),
        restorations=int(res.restoration_count), objective=obj, wall_s=wall,
        trace=[[float(v) for v in r] for r in rows])), flush=True)


if __name__ == "__main__":
    # python3 tests/test_torch_sparse.py [N]: the reference's Mittelmann solve
    import sys
    reference_mittelmann(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
