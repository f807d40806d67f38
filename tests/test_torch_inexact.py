"""The matrix-free, inexact and penalty step paths of the PyTorch port
(ipopt_torch/algorithm/matrix_free.py, inexact.py, cg_penalty.py and the
l1-penalty acceptor of linesearch.py) against the JAX reference, in float64
on the CPU:

- MINRES on an indefinite saddle-point system (tests/test_matrix_free.py:
  12-23), against the reference's MINRES on the same system;
- the piecewise-penalty list (tests/test_cg_penalty.py:42-74), against the
  reference's container on the same entries;
- the inexact step-decomposition bit under its three policies
  (tests/test_wired_options.py:467-497);
- solves against the reference's recorded results (tests/torch_cases.py,
  suite "inexact"): HS071, HS035, HS006 and HS038 under
  ``linear_solver="minres"``, ``inexact_algorithm``, ``cg-penalty`` and
  ``penalty``, the three decomposition policies, ``line_search_method=
  "none"``, the 1-D control of tests/test_inexact.py:43-71 and cg-penalty
  on the chained ``luksan_vlcek1(64, 4)`` (K2 through the BCR);
- the option combinations the reference refuses.

Tolerances: MINRES solutions rtol 1e-10 of the largest entry (the two
sweeps sum in other orders) and the residual 1e-8, as the reference's test;
the penalty list exactly; recorded solves as in test_torch_adaptive.py,
and the cases whose outcome a 1e-15 change of the start moves (``chaotic``
in tests/torch_cases.py) to status and objective rtol 1e-7, with the test
below that shows it.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu.algorithm import matrix_free as ref_mf
from ipopt_tpu.algorithm import cg_penalty as ref_cg
from ipopt_tpu.algorithm import inexact as ref_inx

import ipopt_torch
from ipopt_torch import modellib
from ipopt_torch.algorithm import matrix_free as port_mf
from ipopt_torch.algorithm import cg_penalty as port_cg
from ipopt_torch.algorithm import inexact as port_inx

import torch_cases
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)


def test_minres_solves_indefinite_as_the_reference():
    rng = np.random.default_rng(0)
    n, m = 12, 4
    H = rng.standard_normal((n, n))
    H = H @ H.T + np.eye(n)
    J = rng.standard_normal((m, n))
    K = np.block([[H, J.T], [J, -1e-8 * np.eye(m)]])
    b = rng.standard_normal(n + m)
    x_r, rr_r = ref_mf.minres(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), maxiter=200,
                              rtol=1e-12)
    Kt = torch.as_tensor(K)
    x_p, rr_p = port_mf.minres(lambda v: v @ Kt.T, torch.as_tensor(b)[None], maxiter=200,
                               rtol=1e-12)
    np.testing.assert_allclose(K @ x_p[0].numpy(), b, rtol=1e-8, atol=1e-8)
    scale = float(np.abs(np.asarray(x_r)).max())
    np.testing.assert_allclose(x_p[0].numpy(), np.asarray(x_r), rtol=1e-10,
                               atol=1e-10 * scale)
    assert float(rr_p[0]) <= 1e-12 and float(rr_r) <= 1e-12


def test_minres_lanes_are_independent():
    """Two lanes with different systems stop at their own iteration counts
    and equal their one-lane solves bit for bit."""
    rng = np.random.default_rng(1)
    Ks, bs = [], []
    for k in (6, 10):
        A = rng.standard_normal((k, k))
        Ks.append(np.pad(A + A.T, (0, 10 - k)) + np.diag([0.0] * k + [1.0] * (10 - k)))
        bs.append(np.concatenate([rng.standard_normal(k), np.zeros(10 - k)]))
    K = torch.as_tensor(np.stack(Ks))
    b = torch.as_tensor(np.stack(bs))

    def product(Kb):
        return lambda v: torch.matmul(Kb, v[..., None])[..., 0]

    both, _ = port_mf.minres(product(K), b, 50, 1e-13)
    for lane in (0, 1):
        one, _ = port_mf.minres(product(K[lane:lane + 1]), b[lane:lane + 1], 50, 1e-13)
        assert torch.equal(one[0], both[lane])


def test_piecewise_penalty_container():
    """tests/test_cg_penalty.py:42-74 on the port (one lane), and every
    list state equal to the reference's."""
    opts_p = ipopt_torch.Options(line_search_method="cg-penalty")
    opts_r = ipopt_tpu.Options(line_search_method="cg-penalty")
    cg_p = port_cg.cg_init(opts_p, 1, torch.float64, "cpu")
    cg_r = ref_cg.cg_init(opts_r, jnp.float64)
    cg_p = cg_p._replace(pp_pen_r=cg_p.pp_pen_r.index_fill(1, torch.tensor([0]), 0.0),
                         pp_barr=cg_p.pp_barr.index_fill(1, torch.tensor([0]), 1.0),
                         pp_inf=cg_p.pp_inf.index_fill(1, torch.tensor([0]), 2.0),
                         pp_size=torch.ones((1,), dtype=torch.int64))
    cg_r = cg_r._replace(pp_pen_r=cg_r.pp_pen_r.at[0].set(0.0),
                         pp_barr=cg_r.pp_barr.at[0].set(1.0),
                         pp_inf=cg_r.pp_inf.at[0].set(2.0),
                         pp_size=jnp.asarray(1, jnp.int32))

    def t(v):
        return torch.tensor([v], dtype=torch.float64)

    for const, lin, want in ((0.5, 2.0, True), (1.5, 2.5, False), (5.0, 1.0, True)):
        got = bool(port_cg.pp_acceptable(cg_p, t(const), t(lin))[0])
        assert got == want == bool(ref_cg.pp_acceptable(cg_r, jnp.asarray(const),
                                                        jnp.asarray(lin)))

    def same(p, r):
        for k in ("pp_pen_r", "pp_barr", "pp_inf"):
            np.testing.assert_array_equal(getattr(p, k)[0].numpy(), np.asarray(getattr(r, k)))
        assert int(p.pp_size[0]) == int(r.pp_size)

    cg2_p = port_cg.pp_update(cg_p, t(1.5), t(1.0))
    cg2_r = ref_cg.pp_update(cg_r, jnp.asarray(1.5), jnp.asarray(1.0))
    same(cg2_p, cg2_r)
    assert int(cg2_p.pp_size[0]) == 2
    np.testing.assert_allclose(cg2_p.pp_pen_r[0, 1].item(), 0.5)
    # a dominating insertion collapses the list onto the new point
    cg3_p = port_cg.pp_update(cg2_p, t(0.5), t(0.5))
    same(cg3_p, ref_cg.pp_update(cg2_r, jnp.asarray(0.5), jnp.asarray(0.5)))
    assert int(cg3_p.pp_size[0]) == 1
    # a full list: the reference's last-slot replacement
    full_p, full_r = cg_p, cg_r
    rng = np.random.default_rng(5)
    for _ in range(2 * opts_p.max_piece_number):
        b_, i_ = rng.uniform(0, 3), rng.uniform(0, 3)
        full_p = port_cg.pp_update(full_p, t(b_), t(i_))
        full_r = ref_cg.pp_update(full_r, jnp.asarray(b_), jnp.asarray(i_))
        same(full_p, full_r)
    assert float(port_cg.pp_biggest_barr(full_p)[0]) == float(ref_cg.pp_biggest_barr(full_r))


def test_decomposition_policies():
    """tests/test_wired_options.py:467-497: "always" carries no bit; the
    adaptive policies start undecomposed; a small accepted step activates
    the decomposition, a full one deactivates it under "adaptive" only."""
    assert port_inx.decomposition_initial_cn(
        ipopt_torch.Options(inexact_step_decomposition="always")) is None
    cn0 = port_inx.decomposition_initial_cn(
        ipopt_torch.Options(inexact_step_decomposition="adaptive"), 2)
    assert cn0.shape == (2,) and not bool(cn0.any())
    kw = dict(inexact_decomposition_activate_tol=1e-3,
              inexact_decomposition_inactivate_tol=1e-3)
    for policy in ("adaptive", "switch-once"):
        o_p = ipopt_torch.Options(inexact_step_decomposition=policy, **kw)
        o_r = ipopt_tpu.Options(inexact_step_decomposition=policy, **kw)
        for cn in (False, True):
            for alpha in (1e-4, 1.0):
                got = port_inx.decomposition_next_cn(
                    o_p, torch.tensor([cn]), torch.tensor([alpha], dtype=torch.float64))
                want = ref_inx.decomposition_next_cn(o_r, jnp.asarray(cn), jnp.asarray(alpha))
                assert bool(got[0]) == bool(want), (policy, cn, alpha)
    o = ipopt_torch.Options(inexact_step_decomposition="adaptive", **kw)
    assert bool(port_inx.decomposition_next_cn(o, torch.tensor([False]),
                                               torch.tensor([1e-4]))[0])
    assert not bool(port_inx.decomposition_next_cn(o, torch.tensor([True]),
                                                   torch.tensor([1.0]))[0])


@pytest.fixture(scope="module")
def iterates():
    return {}


@pytest.mark.parametrize("name", torch_cases.suite_cases("inexact"))
def test_matches_recorded_reference(name, iterates):
    _, rec = torch_cases.solve_port(name, iterates)
    assert_matches_recorded(name, rec)


def test_penalty_hs035_is_chaotic():
    """hs035 under the l1-penalty acceptor: nu reaches ~4e15 while the
    violation of its linear constraint is ~1e-16, so the acceptance depends
    on the last bits of g(x).  The reference's recorded nominal solve ends
    in status 6 and its solves from starts changed by 1e-15 in status 0,
    at other iteration counts; the port's counts move under the same
    changes.  So these cases hold status and objective only (the perturbed
    starts, in the recorded suite above)."""
    rec = torch_cases.recorded()
    nominal = rec["hs035_penalty"]
    perturbed = [rec[f"hs035_penalty_p{k}"] for k in (1, 2, 3)]
    assert nominal["status"] != 0 and all(r["status"] == 0 for r in perturbed)
    assert len({r["iter_count"] for r in perturbed}) > 1
    counts = set()
    for name in ("hs035_penalty", "hs035_penalty_p1", "hs035_penalty_p2",
                 "hs035_penalty_p3"):
        _, mine = torch_cases.solve_port(name, {})
        counts.add(mine["iter_count"])
    assert len(counts) > 1


@pytest.mark.parametrize("opts, msg", [
    (dict(linear_solver="minres", mu_strategy="adaptive"), "adaptive mu"),
    (dict(line_search_method="cg-penalty", mehrotra_algorithm=True), "cg-penalty"),
    (dict(line_search_method="cg-penalty", linear_solver="minres"), "cg-penalty"),
    (dict(inexact_algorithm=True, mu_strategy="adaptive"), "monotone mu")])
def test_refused_combinations(opts, msg):
    """The combinations the reference refuses (solver.py:404-420), with its
    errors."""
    with pytest.raises(NotImplementedError, match=msg):
        ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, **opts)


def test_inexact_removes_bounds_and_minres_drops_soc():
    """The inexact algorithm solves the bound-free reformulation (its bounds
    become inequality rows), and neither matrix-free path keeps second-order
    corrections (no factorization to reuse): the reference's solve()."""
    seen = {}
    from ipopt_torch.algorithm import solver as port_solver
    inner = port_solver.solve_canonical

    def spy(nlp, opts, **kw):
        seen["mi"], seen["max_soc"] = nlp.struct.mi, opts.max_soc
        return inner(nlp, opts, **kw)

    port_solver.solve_canonical = spy
    try:
        ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                          inexact_algorithm=True, max_iter=1)
        assert seen == dict(mi=1 + 4, max_soc=0)
        ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                          linear_solver="minres", max_iter=1)
        assert seen == dict(mi=1, max_soc=0)
    finally:
        port_solver.solve_canonical = inner
