"""Limited-memory Hessians of the PyTorch port against the JAX reference, in
float64 on the CPU: the quasi-Newton updater (BFGS and SR1, the five
initializations, the skip and reset rule), the compact and dense forms, the
dense Sherman-Morrison-Woodbury (SMW) solver, the SMW solvers over the
chained, arrow and banded backends, and whole solves (the reference's
recorded results, ``tests/torch_cases.py``, suite "lbfgs").

Inputs come from numpy and go to both packages (ipopt_torch.convert).
Tolerances: updater states, compact and dense forms rtol 1e-12 (atol 1e-12
times the largest entry); SMW solves against the reference's 1e-10, against
the dense augmented solve 1e-8 (as the reference's own test); whole solves
equal status, iteration, factorization and solve counts, objective rtol
1e-9; the 8-lane batch equal to each lane's solve bit for bit.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu.algorithm import quasi_newton as ref_qn
from ipopt_tpu.algorithm import lowrank_kkt as ref_lr
from ipopt_tpu.algorithm import lowrank_struct as ref_ls
from ipopt_tpu.problem import canonicalize as ref_canonicalize
from ipopt_tpu import sparse as ref_sparse
from ipopt_tpu.types import Iterate as RefIterate

import ipopt_torch
from ipopt_torch import convert, kkt as port_kkt, modellib
from ipopt_torch import sparse as port_sparse
from ipopt_torch.algorithm import quasi_newton as port_qn
from ipopt_torch.algorithm import lowrank_kkt as port_lr
from ipopt_torch.algorithm import lowrank_struct as port_ls
from ipopt_torch.linalg.ldlt import ldlt, ldlt_solve
import torch_cases
from test_torch_core import _random_iterate
from test_torch_adaptive import assert_matches_recorded
from test_torch_arrow import _scenario
from test_torch_chained import _ref_and_port

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
STRATEGIES = ("scalar1", "scalar2", "scalar3", "scalar4", "constant")


def _close(a, b, rtol=1e-12, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=err_msg)


def _pairs(seed, n, count):
    """Seeded (s, y) pairs: y = A s + noise with A indefinite, so BFGS meets
    negative curvature (skips) and SR1 does not skip; two pairs with
    s^T y < 0 in a row force the BFGS reset."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + np.diag(np.linspace(-2.0, 3.0, n))
    out = []
    for k in range(count):
        s = rng.standard_normal(n)
        y = A @ s + 0.01 * rng.standard_normal(n)
        if k in (4, 5):
            y = -y if s @ y > 0 else y      # two skips in a row -> reset (BFGS)
        out.append((s, y))
    return out


def _state_close(sp, sr, msg):
    for k in ("S", "Y", "sigma"):
        _close(getattr(sp, k)[0].numpy(), getattr(sr, k), err_msg=f"{msg} {k}")
    for k in ("count", "head", "skips"):
        assert int(getattr(sp, k)[0]) == int(getattr(sr, k)), (msg, k)


@pytest.mark.parametrize("update_type", ["bfgs", "sr1"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_lbfgs_update_and_forms_match_reference(update_type, strategy):
    """Eight updates of a history of 3 (the ring wraps), with a skip and,
    for BFGS, a reset: every state field, the compact form (sigma, U, M)
    and the dense W after each update."""
    n, hist = 5, 3
    kw = dict(limited_memory_update_type=update_type,
              limited_memory_initialization=strategy, limited_memory_init_val=2.5)
    ropts, popts = ipopt_tpu.Options(**kw), ipopt_torch.Options(**kw)
    sr = ref_qn.lbfgs_init(n, hist, jnp.float64, 2.5)
    sp = port_qn.lbfgs_init(1, n, hist, torch.float64, "cpu", 2.5)
    skipped = 0
    for k, (s, y) in enumerate(_pairs(7, n, 8)):
        sr = ref_qn.lbfgs_update(sr, jnp.asarray(s), jnp.asarray(y), ropts)
        sp = port_qn.lbfgs_update(sp, torch.as_tensor(s)[None], torch.as_tensor(y)[None],
                                  popts)
        _state_close(sp, sr, f"update {k}")
        skipped += int(sp.skips[0] > 0)
        lr_r, lr_p = ref_qn.lbfgs_compact(sr, ropts), port_qn.lbfgs_compact(sp, popts)
        for f in ("sigma", "U", "M"):
            _close(getattr(lr_p, f)[0].numpy(), getattr(lr_r, f), err_msg=f"{k} {f}")
        # the dense W from the same compact form; from the port's own form
        # only for BFGS: SR1's M is the cancellation D + L + L' - sigma S'S
        # (~1e-16) plus sqrt(eps) ~ 1.5e-8, and M^{-1} magnifies the former
        W_r = ref_qn.lbfgs_dense_W(sr, ropts)
        W_from_r = port_qn.dense_from_compact(port_qn.LowRankW(
            *(torch.as_tensor(np.array(v))[None] for v in lr_r)))
        _close(W_from_r[0].numpy(), W_r, err_msg=f"{k} W")
        if update_type == "bfgs":
            _close(port_qn.lbfgs_dense_W(sp, popts)[0].numpy(), W_r, rtol=1e-10,
                   err_msg=f"{k} W")
    assert skipped > 0 if update_type == "bfgs" else skipped == 0


def test_lbfgs_state_carried_from_reference():
    """``convert.lbfgs_from_arrays`` takes a reference state as it is: the
    port's update from it equals the reference's."""
    opts = ipopt_tpu.Options()
    sr = ref_qn.lbfgs_init(4, 3, jnp.float64)
    for s, y in _pairs(1, 4, 4):
        sr = ref_qn.lbfgs_update(sr, jnp.asarray(s), jnp.asarray(y), opts)
    sp = convert.lbfgs_from_arrays(*(np.asarray(v) for v in sr))
    _state_close(sp, sr, "carried")
    s, y = _pairs(2, 4, 1)[0]
    _state_close(port_qn.lbfgs_update(sp, torch.as_tensor(s)[None],
                                      torch.as_tensor(y)[None], ipopt_torch.Options()),
                 ref_qn.lbfgs_update(sr, jnp.asarray(s), jnp.asarray(y), opts), "next")


def test_lanes_keep_their_own_history():
    """Three lanes updated together equal each lane updated alone, bit for
    bit, with a partly filled history in one lane (masked per lane)."""
    opts = ipopt_torch.Options()
    pairs = [_pairs(seed, 4, 5) for seed in (1, 2, 3)]
    st = port_qn.lbfgs_init(3, 4, 3, torch.float64, "cpu")
    alone = [port_qn.lbfgs_init(1, 4, 3, torch.float64, "cpu") for _ in range(3)]
    for k in range(5):
        s = torch.as_tensor(np.stack([p[k][0] for p in pairs]))
        y = torch.as_tensor(np.stack([p[k][1] for p in pairs]))
        if k >= 2:      # lane 2 stops updating: a partly filled history
            s[2], y[2] = 0.0, 0.0
        st = port_qn.lbfgs_update(st, s, y, opts)
        for b in range(3):
            alone[b] = port_qn.lbfgs_update(alone[b], s[b:b + 1], y[b:b + 1], opts)
    W = port_qn.lbfgs_dense_W(st, opts)
    for b in range(3):
        for f, a in zip(st, alone[b]):
            assert torch.equal(f[b:b + 1], a), (b, f)
        assert torch.equal(W[b:b + 1], port_qn.lbfgs_dense_W(alone[b], opts))


def test_sr1_dense_reconstruction():
    """The twin of test_wired_options.py::test_sr1_dense_reconstruction: n
    independent pairs of a quadratic give its Hessian."""
    n = 5
    rng = np.random.RandomState(3)
    A = rng.standard_normal((n, n))
    B_true = A @ A.T + np.diag([3.0, -1.0, 2.0, 5.0, 0.5])
    opts = ipopt_torch.Options(limited_memory_update_type="sr1",
                               limited_memory_max_history=n)
    st = port_qn.lbfgs_init(1, n, n, torch.float64, "cpu")
    for _ in range(n):
        s = rng.standard_normal(n)
        st = port_qn.lbfgs_update(st, torch.as_tensor(s)[None],
                                  torch.as_tensor(B_true @ s)[None], opts)
    np.testing.assert_allclose(port_qn.lbfgs_dense_W(st, opts)[0].numpy(), B_true,
                               rtol=1e-5, atol=1e-5)


def _hs071_state():
    """The reference's own SMW test set-up (tests/test_lbfgs.py:35-86)."""
    import problems
    nlp = ref_canonicalize(problems.hs071())
    opts = ipopt_tpu.Options(hessian_approximation="limited-memory")
    rng = np.random.default_rng(0)
    n, mi = nlp.n, nlp.mi
    st = ref_qn.lbfgs_init(n, 6, jnp.float64)
    x = jnp.asarray([1.5, 4.0, 3.5, 1.5])
    for _ in range(4):
        s = jnp.asarray(rng.normal(size=n) * 0.1)
        st = ref_qn.lbfgs_update(st, s, nlp.eval_grad_f(x + s) - nlp.eval_grad_f(x), opts)
    blocks = [np.asarray(x), np.array([26.0]), np.array([1.0]), np.array([0.5]),
              np.ones(n), np.ones(n), np.ones(mi), np.zeros(mi)]
    return nlp, opts, st, blocks, rng


def test_sherman_morrison_matches_reference_and_dense_solve():
    """The twin of tests/test_lbfgs.py::test_sherman_morrison_matches_dense_
    aug_solve: the port's SMW factorization has the reference's deltas and
    inertia, its solve equals the reference's lowrank_solve_once (1e-10)
    and the dense augmented solve with the materialized W (1e-8)."""
    nlp, ropts, st_r, blocks, rng = _hs071_state()
    n, mi, me = nlp.n, nlp.mi, nlp.me
    it_r = RefIterate(*(jnp.asarray(b) for b in blocks))
    ev_r = ref_kkt_evaluate(nlp, it_r.x)
    fr = ref_lr.lowrank_factorize_kkt(nlp, ropts, it_r, ev_r, ref_qn.lbfgs_compact(st_r),
                                      jnp.asarray(0.1), jnp.zeros((), jnp.float64))
    cp = ipopt_torch.canonicalize(torch_cases.build("hs071_d0", "port"))
    popts = ipopt_torch.Options(hessian_approximation="limited-memory")
    st_p = convert.lbfgs_from_arrays(*(np.asarray(v) for v in st_r))
    it_p = convert.iterate_from_arrays(blocks)
    ev_p = port_kkt.evaluate(cp, it_p.x)
    fp = port_lr.lowrank_factorize_kkt(cp, popts, it_p, ev_p, port_qn.lbfgs_compact(st_p),
                                       torch.full((1,), 0.1, **F64), torch.zeros((1,), **F64))
    assert not bool(fp.failed[0]) and not bool(fr.failed)
    assert int(fp.num_trials[0]) == int(fr.num_trials)
    _close(float(fp.delta_x[0]), float(fr.delta_x))
    _close(fp.fac.Cw[0].numpy(), fr.fac.Cw, rtol=1e-10)

    rhs = rng.normal(size=n + mi + me + mi)
    cuts = np.cumsum([n, mi, me])
    parts = np.split(rhs, cuts)
    sol_r = np.concatenate([np.asarray(v) for v in ref_lr.lowrank_solve_once(
        fr.fac, *(jnp.asarray(p) for p in parts))])
    sol_p = torch.cat(port_lr.lowrank_solve_once(
        fp.fac, *(torch.as_tensor(p)[None] for p in parts)), -1)[0].numpy()
    _close(sol_p, sol_r, rtol=1e-10)
    sig = port_kkt.sigmas(cp, it_p)
    K = port_kkt.assemble_aug_system(port_qn.lbfgs_dense_W(st_p), ev_p.J_c, ev_p.J_d, sig,
                                     fp.delta_x, fp.delta_x, fp.delta_c, fp.delta_c)
    sol_dense = ldlt_solve(ldlt(K), torch.as_tensor(rhs)[None])[0].numpy()
    np.testing.assert_allclose(sol_p, sol_dense, rtol=1e-8, atol=1e-10)
    (dxp, *_), rr_p = port_lr.lowrank_solve_refined(
        fp.fac, tuple(torch.as_tensor(p)[None] for p in parts), popts)
    (dxr, *_), rr_r = ref_lr.lowrank_solve_refined(
        fr.fac, tuple(jnp.asarray(p) for p in parts), ropts)
    _close(dxp[0].numpy(), dxr, rtol=1e-10)


def ref_kkt_evaluate(nlp, x):
    from ipopt_tpu.kkt import evaluate
    return evaluate(nlp, x)


def _struct_case(backend):
    """(reference canonical, port canonical, reference iterate, port
    iterate) of a small problem on ``backend``, fed the same data."""
    if backend == "btd":
        cref, cp = _ref_and_port(16)
    elif backend == "arrow":
        cref, cp = _scenario()
    else:
        o = dict(linear_solver="banded-bcr")
        cref = ref_sparse.canonicalize_sparse(ipopt_tpu.modellib.luksan_vlcek5(16),
                                              ipopt_tpu.Options(**o))
        cp = port_sparse.canonicalize_sparse(modellib.luksan_vlcek5(16),
                                             ipopt_torch.Options(**o))
    blocks = _random_iterate(np.random.default_rng(4), cref)
    return (cref, cp, RefIterate(*(jnp.asarray(b) for b in blocks)),
            convert.iterate_from_arrays(blocks))


@pytest.mark.parametrize("backend", ["btd", "arrow", "banded"])
def test_lowrank_struct_matches_reference(backend):
    """The SMW factorization over a structured base system: the same retry
    (delta_x, delta_c, trials), base inertia and SMW eigenvalues as the
    reference's; the refined solve of a seeded right-hand side to 1e-10."""
    cref, cp, it_r, it_p = _struct_case(backend)
    n = cref.struct.n
    ropts = ipopt_tpu.Options(hessian_approximation="limited-memory")
    popts = ipopt_torch.Options(hessian_approximation="limited-memory")
    st_r = ref_qn.lbfgs_init(n, 6, jnp.float64)
    rng = np.random.default_rng(5)
    for _ in range(4):
        s = 0.1 * rng.standard_normal(n)
        st_r = ref_qn.lbfgs_update(st_r, jnp.asarray(s),
                                   jnp.asarray(s * rng.uniform(0.5, 2.0, n)), ropts)
    st_p = convert.lbfgs_from_arrays(*(np.asarray(v) for v in st_r))
    fr = ref_ls.lowrank_struct_factorize(cref, ropts, it_r, ref_qn.lbfgs_compact(st_r),
                                         jnp.asarray(0.1), jnp.zeros((), jnp.float64))
    fp = port_ls.lowrank_struct_factorize(cp, popts, it_p, port_qn.lbfgs_compact(st_p),
                                          torch.full((1,), 0.1, **F64),
                                          torch.zeros((1,), **F64))
    assert int(fp.num_trials[0]) == int(fr.num_trials)
    assert bool(fp.failed[0]) == bool(fr.failed) is False
    for k in ("delta_x", "delta_c"):
        _close(float(getattr(fp, k)[0]), float(getattr(fr, k)), err_msg=k)
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(fp.fac.base_fac, k)[0]) == int(getattr(fr.fac.base_fac, k)), k
    _close(fp.fac.Cw[0].numpy(), fr.fac.Cw, rtol=1e-10)
    me, mi = cref.struct.me, cref.struct.mi
    parts = [rng.standard_normal(k) for k in (n, mi, me, mi)]
    sol_r, _ = ref_ls.lowrank_struct_solve_refined(
        cref, ropts, fr.fac, tuple(jnp.asarray(p) for p in parts))
    sol_p, _ = port_ls.lowrank_struct_solve_refined(
        cp, popts, fp.fac, tuple(torch.as_tensor(p)[None] for p in parts))
    for a, b in zip(sol_p, sol_r):
        _close(a[0].numpy(), b, rtol=1e-10)


def test_masked_quasi_newton_needs_extended_aug_solver():
    """num_linear_variables with the nonlinear-variables space is refused
    on the SMW path by both packages (solver.py:378-382), and the dense W
    has zero rows and columns at the linear variables."""
    kw = dict(hessian_approximation="limited-memory", num_linear_variables=1,
              tol=1e-6, print_level=0)
    with pytest.raises(NotImplementedError, match="extended"):
        ipopt_tpu.solve(torch_cases.build("linear_x0", "ref"), **kw)
    with pytest.raises(NotImplementedError, match="extended"):
        ipopt_torch.solve(torch_cases.build("linear_x0", "port"), device="cpu", **kw)
    st = port_qn.lbfgs_init(1, 3, 4, torch.float64, "cpu")
    mask = torch.tensor([0.0, 1.0, 1.0], **F64)
    st = port_qn.lbfgs_update(st, torch.tensor([[1.0, 2.0, 3.0]], **F64) * mask,
                              torch.tensor([[0.5, 1.0, 2.0]], **F64) * mask,
                              ipopt_torch.Options())
    W = port_qn.lbfgs_dense_W(st, nl_mask=mask)[0]
    assert float(W[0].abs().max()) == 0.0 and float(W[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("name", torch_cases.suite_cases("lbfgs"))
def test_matches_recorded_reference(name):
    """hs071 (0, 10, 17.01401714521598), hs038, hs035, both
    limited_memory_aug_solver modes, the initializations, SR1, the masked
    quasi-Newton, restorations with L-BFGS, and LuksanVlcek chained (64, 4)
    (0, 18, 6.232458632255037) and banded."""
    assert_matches_recorded(name, torch_cases.solve_port(name, {})[1])


@pytest.mark.parametrize("name", torch_cases.suite_cases("lbfgs_f4"))
def test_f4_cpu_sizes_match_recorded_reference(name):
    """L-BFGS at chip_smoke.py F4's CPU sizes (tol 1e-6, max_iter 300):
    luksan_vlcek1(256, 32) chained, (0, 16, 6.232458632726281), and
    luksan_vlcek1_flat(2000) on banded-bcr, (0, 19, 6.232458632438792), as
    the reference records them: status, iterations, factorizations and
    objective."""
    assert_matches_recorded(name, torch_cases.solve_port(name, {})[1])


def test_sr1_rosenbrock_is_chaotic():
    """The twin of test_wired_options.py::test_sr1_solves_and_differs_from_
    bfgs, and why it is not held to the reference's iteration count: SR1
    with a history longer than n = 2 makes the SMW matrix nearly singular,
    and a relative change of 1e-15 in x0 changes the port's own count."""
    kw = dict(device="cpu", print_level=0, tol=1e-6,
              hessian_approximation="limited-memory")
    counts = []
    for eps in (0.0, 1e-15):
        prob = torch_cases.build("rosenbrock", "port")
        prob.x0 = np.asarray(prob.x0) * (1.0 + eps)
        sr1 = ipopt_torch.solve(prob, limited_memory_update_type="sr1", **kw)
        assert int(sr1.status) == 0
        np.testing.assert_allclose(sr1.x.numpy(), [1.0, 1.0], atol=1e-4)
        counts.append(int(sr1.iter_count))
    assert counts[0] != counts[1], counts
    bfgs = ipopt_torch.solve(torch_cases.build("rosenbrock", "port"), **kw)
    assert counts[0] != int(bfgs.iter_count)


def test_family_batch_equals_single_solves():
    """Eight HS071 family lanes with L-BFGS in one batch: each lane's
    history is its own, so every lane equals its single solve bit for
    bit."""
    opts = dict(hessian_approximation="limited-memory", print_level=0, tol=1e-8)
    fam = [modellib.hs071_family(0.005 * i) for i in (0, 1, 2, 3, 100, 200, 300, 400)]
    rb = ipopt_torch.solve_batched(fam, device="cpu", **opts)
    for b, p in enumerate(fam):
        r = ipopt_torch.solve(p, device="cpu", **opts)
        assert int(rb.status[b]) == int(r.status) == 0
        assert int(rb.iter_count[b]) == int(r.iter_count)
        assert torch.equal(rb.x[b], r.x) and torch.equal(rb.obj[b], r.obj), b


def test_family_lanes_are_rounding_sensitive():
    """Why chip_smoke.py lets the card's L-BFGS family end one iteration
    apart from the CPU's on the lanes of FAMILY_LBFGS_SENSITIVE (286, 287
    and 294) and on no other: a symmetric perturbation of the SMW matrix C
    of 3e-15 relative (a few ulps, the order of the card's and the CPU's
    different rounding) moves each of them by one iteration, with the same
    status and objective to 1e-9.  Over generator seeds 0-3 it moves lane
    294 in all four, 286 in two and 287 in one (seed 2 moves all three).
    The inertia tests are not what moves: C's eigenvalues stay 1e13 times
    their zero threshold or more on this family.  What moves is the end:
    at iteration 10 the CPU's lane 286 goes on with a dual infeasibility of
    2.761e-8 and lane 287 stops with 2.734e-8, one percent apart."""
    from ipopt_torch.algorithm import lowrank_kkt as lk
    kw = dict(hessian_approximation="limited-memory", max_iter=300, print_level=0)
    fam = [modellib.hs071_family(0.005 * i) for i in torch_cases.FAMILY_LBFGS_SENSITIVE]
    r0 = ipopt_torch.solve_batched(fam, device="cpu", **kw)
    gen = torch.Generator().manual_seed(2)
    exact = lk.smw_inertia

    def perturbed(C, M):
        E = torch.randn(C.shape, generator=gen, dtype=C.dtype) * 3e-15
        E = E * C.abs().amax((-1, -2), keepdim=True)
        return exact(C + E + E.transpose(-1, -2), M)

    lk.smw_inertia = perturbed
    try:
        r1 = ipopt_torch.solve_batched(fam, device="cpu", **kw)
    finally:
        lk.smw_inertia = exact
    assert r0.status.tolist() == r1.status.tolist() == [0, 0, 0]
    assert (r0.iter_count - r1.iter_count).abs().tolist() == [1, 1, 1]
    np.testing.assert_allclose(r1.obj.numpy(), r0.obj.numpy(), rtol=1e-9)


@pytest.mark.parametrize("name", torch_cases.suite_cases("lbfgs_sensitive"))
def test_sensitive_lanes_against_reference(name):
    """The rounding-sensitive family lanes against the reference's recorded
    solves: the same status, the objective to 1e-9 and the iteration count
    within the one iteration that a few ulps move (the CPU's lane 286 ends
    at 12 iterations, the reference's at 11)."""
    rec = torch_cases.solve_port(name, {})[1]
    want = torch_cases.recorded()[name]
    assert rec["status"] == want["status"] == 0, name
    assert abs(rec["iter_count"] - want["iter_count"]) <= 1, name
    np.testing.assert_allclose(rec["obj"], want["obj"], rtol=1e-9, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hs071_lbfgs", "lv1_64_lbfgs", "scen_qp_lbfgs"])
def test_lbfgs_solve_on_cuda_equals_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = torch_cases.CASES[name]
    cpu = ipopt_torch.solve(torch_cases.build(case["problem"], "port"), device="cpu",
                            print_level=0, **case["opts"])
    gpu = ipopt_torch.solve(torch_cases.build(case["problem"], "port"), device="cuda",
                            print_level=0, **case["opts"])
    assert (int(gpu.status), int(gpu.iter_count)) == (int(cpu.status), int(cpu.iter_count))
    np.testing.assert_allclose(float(gpu.obj), float(cpu.obj), rtol=1e-9)
