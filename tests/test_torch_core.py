"""Core modules of the PyTorch port against the JAX reference, in float64 on
the CPU: options, canonicalization with scaling, the KKT functions, the
inertia-corrected factorization, and the restoration phase's statuses.

Inputs come from numpy and are handed to both packages (ipopt_torch.convert).
Tolerance: rtol 1e-12 for elementwise functions (same formulas; only the
order of rounding in sums and products may differ).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import kkt as ref_kkt
from ipopt_tpu.algorithm import step as ref_step
from ipopt_tpu.types import Iterate as RefIterate
import problems

import ipopt_torch
from ipopt_torch import convert, kkt as port_kkt
from ipopt_torch.algorithm import step as port_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch twins of tests/problems.py (same formulas; torch.stack for g)
TORCH_FG = {
    "hs001": (lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2, None),
    "hs006": (lambda x: (1.0 - x[0]) ** 2,
              lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2)])),
    "hs035": (lambda x: (9.0 - 8 * x[0] - 6 * x[1] - 4 * x[2]
                         + 2 * x[0] ** 2 + 2 * x[1] ** 2 + x[2] ** 2
                         + 2 * x[0] * x[1] + 2 * x[0] * x[2]),
              lambda x: torch.stack([3.0 - x[0] - x[1] - 2 * x[2]])),
    "hs038": (lambda x: (100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
                         + 90 * (x[3] - x[2] ** 2) ** 2 + (1 - x[2]) ** 2
                         + 10.1 * ((x[1] - 1) ** 2 + (x[3] - 1) ** 2)
                         + 19.8 * (x[1] - 1) * (x[3] - 1)), None),
    "hs051": (lambda x: ((x[0] - x[1]) ** 2 + (x[1] + x[2] - 2) ** 2
                         + (x[3] - 1) ** 2 + (x[4] - 1) ** 2),
              lambda x: torch.stack([x[0] + 3 * x[1], x[2] + x[3] - 2 * x[4],
                                     x[1] - x[4]])),
    "hs071": (lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
              lambda x: torch.stack([x[0] * x[1] * x[2] * x[3],
                                     x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2])),
    "hs016": (lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
              lambda x: torch.stack([x[0] + x[1] ** 2, x[0] ** 2 + x[1]])),
    "hs076": (lambda x: (x[0] ** 2 + 0.5 * x[1] ** 2 + x[2] ** 2
                         + 0.5 * x[3] ** 2 - x[0] * x[2] + x[2] * x[3]
                         - x[0] - 3 * x[1] + x[2] - x[3]),
              lambda x: torch.stack([x[0] + 2 * x[1] + x[2] + x[3],
                                     3 * x[0] + x[1] + 2 * x[2] - x[3],
                                     x[1] + 4 * x[2]])),
    "hs100": (lambda x: ((x[0] - 10) ** 2 + 5 * (x[1] - 12) ** 2 + x[2] ** 4
                         + 3 * (x[3] - 11) ** 2 + 10 * x[4] ** 6 + 7 * x[5] ** 2
                         + x[6] ** 4 - 4 * x[5] * x[6] - 10 * x[5] - 8 * x[6]),
              lambda x: torch.stack([
                  127 - 2 * x[0] ** 2 - 3 * x[1] ** 4 - x[2] - 4 * x[3] ** 2 - 5 * x[4],
                  282 - 7 * x[0] - 3 * x[1] - 10 * x[2] ** 2 - x[3] + x[4],
                  196 - 23 * x[0] - x[1] ** 2 - 6 * x[5] ** 2 + 8 * x[6],
                  -4 * x[0] ** 2 - x[1] ** 2 + 3 * x[0] * x[1] - 2 * x[2] ** 2
                  - 5 * x[5] + 11 * x[6]])),
}


def torch_twin(ref_nlp):
    f, g = TORCH_FG[ref_nlp.name]

    def arr(v):
        return None if v is None else np.asarray(v, dtype=np.float64)

    return ipopt_torch.NLP(f=f, g=g, x0=arr(ref_nlp.x0), x_L=arr(ref_nlp.x_L),
                           x_U=arr(ref_nlp.x_U), g_L=arr(ref_nlp.g_L),
                           g_U=arr(ref_nlp.g_U), name=ref_nlp.name)


def port_from_ref(cref, name):
    """The port's CanonicalNLP built from the reference's arrays."""
    f, g = TORCH_FG[name]
    arrays = {k: np.asarray(getattr(cref, k)) for k in
              ("x_L", "x_U", "d_L", "d_U", "has_xL", "has_xU", "has_dL",
               "has_dU", "c_rhs", "x_fixed", "x0", "x_L_orig", "x_U_orig",
               "obj_scale", "c_scale", "d_scale")}
    return convert.canonical_from_arrays(
        dataclasses.asdict(cref.struct), arrays,
        lambda x, p: f(x), lambda x, p: g(x))


def test_options_match_reference():
    ref, port = ipopt_tpu.Options(), ipopt_torch.Options()
    ref_f = {f.name: f.default for f in dataclasses.fields(ref)}
    port_f = {f.name: f.default for f in dataclasses.fields(port)}
    assert ref_f.keys() == port_f.keys()
    assert ref_f == port_f
    assert convert.options_from_dict(dataclasses.asdict(ref)) == port


SLICE_F_MODULES = ("ipopt_torch.parallel.scenario", "ipopt_torch.algorithm.arrow_kkt",
                   "ipopt_torch.algorithm.arrow_resto", "ipopt_torch.algorithm.quasi_newton",
                   "ipopt_torch.algorithm.lowrank_kkt",
                   "ipopt_torch.algorithm.lowrank_struct",
                   # slice G
                   "ipopt_torch.linalg.nested_dissection",
                   "ipopt_torch.algorithm.matrix_free", "ipopt_torch.algorithm.inexact",
                   "ipopt_torch.algorithm.cg_penalty",
                   # slice H
                   "ipopt_torch.sens", "ipopt_torch.deriv_check",
                   "ipopt_torch.profiling",
                   # slice I
                   "ipopt_torch.parallel.chain_shard", "ipopt_torch.interfaces.ampl",
                   "ipopt_torch.interfaces.capi", "ipopt_torch.native.build")


def test_port_imports_no_jax():
    code = ("import sys, ipopt_torch, ipopt_torch.convert, ipopt_torch.batch, "
            "ipopt_torch.algorithm.restoration, ipopt_torch.interfaces.transforms, "
            "ipopt_torch.interfaces.dependency, chip_smoke, "
            + ", ".join(SLICE_F_MODULES) + "\n"
            f"assert all(m in sys.modules for m in {SLICE_F_MODULES!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ipopt_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ["hs071", "hs016", "hs076", "hs100"])
def test_canonicalize_matches_reference(name):
    ref_nlp = getattr(problems, name)()
    cref = ipopt_tpu.canonicalize(ref_nlp)
    cp = ipopt_torch.canonicalize(torch_twin(ref_nlp))
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
        np.testing.assert_allclose(getattr(cp, k)[0].numpy(),
                                   np.asarray(getattr(cref, k)),
                                   rtol=1e-12, atol=0, err_msg=k)


def _random_iterate(rng, cref):
    n, me, mi = cref.struct.n, cref.struct.me, cref.struct.mi
    x_L, x_U = np.asarray(cref.x_L), np.asarray(cref.x_U)
    has_L, has_U = np.asarray(cref.has_xL), np.asarray(cref.has_xU)
    lo = np.where(has_L, x_L, -3.0)
    hi = np.where(has_U, x_U, 3.0)
    x = lo + (hi - lo) * rng.uniform(0.1, 0.9, n)
    d_L, d_U = np.asarray(cref.d_L), np.asarray(cref.d_U)
    s = np.where(np.asarray(cref.has_dL), d_L + rng.uniform(0.5, 1.5, mi),
                 np.where(np.asarray(cref.has_dU), d_U - rng.uniform(0.5, 1.5, mi),
                          rng.standard_normal(mi)))
    return [x, s, rng.standard_normal(me), rng.standard_normal(mi),
            np.where(has_L, rng.uniform(0.1, 2, n), 0.0),
            np.where(has_U, rng.uniform(0.1, 2, n), 0.0),
            np.where(np.asarray(cref.has_dL), rng.uniform(0.1, 2, mi), 0.0),
            np.where(np.asarray(cref.has_dU), rng.uniform(0.1, 2, mi), 0.0)]


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=1e-12, err_msg=err_msg)


@pytest.mark.parametrize("name", ["hs071", "hs076"])
def test_kkt_functions_match_reference(name):
    rng = np.random.default_rng(7)
    cref = ipopt_tpu.canonicalize(getattr(problems, name)())
    cp = port_from_ref(cref, name)
    blocks = _random_iterate(rng, cref)
    step_blocks = [rng.standard_normal(np.shape(b)) for b in blocks]
    it_r = RefIterate(*(jnp.asarray(b) for b in blocks))
    st_r = RefIterate(*(jnp.asarray(b) for b in step_blocks))
    it_p = convert.iterate_from_arrays(blocks)
    st_p = convert.iterate_from_arrays(step_blocks)
    mu, tau = 0.1, 0.99
    mu_p = torch.tensor([mu], dtype=torch.float64)

    ev_r = ref_kkt.evaluate(cref, it_r.x)
    ev_p = port_kkt.evaluate(cp, it_p.x)
    for k in ("f", "grad_f", "c", "d", "J_c", "J_d"):
        _close(getattr(ev_p, k)[0], getattr(ev_r, k), k)
    for a, b in zip(port_kkt.slacks(cp, it_p), ref_kkt.slacks(cref, it_r)):
        _close(a[0], b)
    _close(port_kkt.barrier_obj(cp, it_p, ev_p.f, mu_p)[0],
           ref_kkt.barrier_obj(cref, it_r, ev_r.f, mu))
    res_p = port_kkt.kkt_residuals(cp, it_p, ev_p, mu_p)
    res_r = ref_kkt.kkt_residuals(cref, it_r, ev_r, mu)
    for a, b, k in zip(res_p, res_r, res_r._fields):
        _close(a[0], b, k)
    for a, b in zip(port_kkt.optimality_error(cp, it_p, res_p),
                    ref_kkt.optimality_error(cref, it_r, res_r)):
        _close(a[0], b)
    sig_p, sig_r = port_kkt.sigmas(cp, it_p), ref_kkt.sigmas(cref, it_r)
    W = rng.standard_normal((cref.struct.n,) * 2)
    W = W + W.T
    deltas = (1e-3, 2e-3, 3e-4, 4e-4)
    K_p = port_kkt.assemble_aug_system(
        torch.as_tensor(W)[None], ev_p.J_c, ev_p.J_d, sig_p,
        *(torch.tensor([v], dtype=torch.float64) for v in deltas))
    K_r = ref_kkt.assemble_aug_system(jnp.asarray(W), ev_r.J_c, ev_r.J_d, sig_r,
                                      *deltas)
    _close(K_p[0], K_r, "K")
    for a, b in zip(port_kkt.condensed_rhs_parts(cp, it_p, ev_p, mu_p),
                    ref_kkt.condensed_rhs_parts(cref, it_r, ev_r, mu)):
        _close(a[0], b)
    for a, b in zip(port_kkt.recover_bound_mult_steps(cp, it_p, st_p.x, st_p.s, mu_p),
                    ref_kkt.recover_bound_mult_steps(cref, it_r, st_r.x, st_r.s, mu)):
        _close(a[0], b)
    for a, b in zip(port_kkt.fraction_to_boundary(
                        cp, it_p, st_p, torch.tensor([tau], dtype=torch.float64)),
                    ref_kkt.fraction_to_boundary(cref, it_r, st_r, tau)):
        _close(a[0], b)


def test_factorize_kkt_matches_reference_per_lane():
    """Three lanes of hs071 at one random iterate, with Hessians that need
    0, a few and many inertia corrections; each lane equals the reference
    run on that instance alone."""
    rng = np.random.default_rng(11)
    cref = ipopt_tpu.canonicalize(problems.hs071())
    opts_r = ipopt_tpu.Options()
    opts_p = ipopt_torch.Options()
    blocks = _random_iterate(rng, cref)
    it_r = RefIterate(*(jnp.asarray(b) for b in blocks))
    ev_r = ref_kkt.evaluate(cref, it_r.x)
    n = cref.struct.n
    R = rng.standard_normal((n, n))
    Ws = [R @ R.T + 5 * np.eye(n), -0.5 * (R + R.T), -40.0 * np.eye(n) + 0.1 * (R + R.T)]
    mus = [0.1, 0.01, 1e-3]
    dwl = [0.0, 1e-4, 0.0]
    out_r = [ref_step.factorize_kkt(cref, opts_r, it_r, ev_r, jnp.asarray(W),
                                    jnp.asarray(m), jnp.asarray(d))
             for W, m, d in zip(Ws, mus, dwl)]
    B = len(Ws)
    cp = port_from_ref(cref, "hs071").take(torch.zeros(B, dtype=torch.int64))
    it_p = convert.iterate_from_arrays([np.stack([b] * B) for b in blocks])
    ev_p = port_kkt.evaluate(cp, it_p.x)
    f64 = dict(dtype=torch.float64)
    fr = port_step.factorize_kkt(cp, opts_p, it_p, ev_p,
                                 torch.as_tensor(np.stack(Ws)),
                                 torch.tensor(mus, **f64), torch.tensor(dwl, **f64))
    trials = [int(o.num_trials) for o in out_r]
    assert len(set(trials)) > 1, trials  # the lanes really differ
    for i, o in enumerate(out_r):
        assert int(fr.num_trials[i]) == int(o.num_trials)
        assert bool(fr.failed[i]) == bool(o.failed)
        _close(fr.delta_x[i], o.delta_x)
        _close(fr.delta_c[i], o.delta_c)
        _close(fr.delta_w_last[i], o.delta_w_last)
        assert int(fr.fac.num_neg[i]) == int(o.fac.num_neg)


def test_solve_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipopt_torch.solve(ipopt_torch.modellib.hs071())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipopt_torch.solve_batched([ipopt_torch.modellib.hs071()])


@pytest.mark.parametrize("opt", [
    dict(), dict(derivative_test="first-order"),
    dict(jacobian_approximation="finite-difference-values"),
    dict(linear_solver="dense-ldlt-blocked"), dict(refinement_precision="double"),
    dict(gradient_approximation="finite-difference-values")])
def test_unported_option_rejected(opt):
    """Since the chain axis over devices was ported, the port refuses no
    option value: chain_shard=True is accepted whatever the other options,
    and on the dense backend (which has no chain) the solve is the plain
    one."""
    res = ipopt_torch.solve(ipopt_torch.modellib.hs071(), device="cpu",
                            print_level=0, chain_shard=True, **opt)
    assert int(res.status) == 0
    assert abs(float(res.obj) - 17.0140171451792) < 1e-6


RESTO_CASES = {
    # tests/test_restoration.py:10-32
    "inconsistent_equalities": (
        dict(f=lambda x: x[0] ** 2, g=lambda x: jnp.array([x[0] + 1.0, x[0] - 1.0]),
             g_L=np.zeros(2), g_U=np.zeros(2), x0=np.array([0.5])),
        dict(f=lambda x: x[0] ** 2, g=lambda x: torch.stack([x[0] + 1.0, x[0] - 1.0]))),
    "bounds_vs_constraint": (
        dict(f=lambda x: x[0], g=lambda x: jnp.array([x[0]]),
             g_L=np.array([2.0]), g_U=np.array([np.inf]),
             x_L=np.array([0.0]), x_U=np.array([1.0]), x0=np.array([0.5])),
        dict(f=lambda x: x[0], g=lambda x: torch.stack([x[0]]))),
}


@pytest.mark.parametrize("case", sorted(RESTO_CASES))
def test_restoration_statuses_match_reference(case):
    spec, torch_fg = RESTO_CASES[case]
    res_r = ipopt_tpu.solve(ipopt_tpu.NLP(**spec), print_level=0)
    res_p = ipopt_torch.solve(ipopt_torch.NLP(**{**spec, **torch_fg}),
                              device="cpu", print_level=0)
    assert int(res_p.status) == int(res_r.status) == \
        int(ipopt_torch.SolverReturn.LOCAL_INFEASIBILITY)
    assert int(res_p.restoration_count) >= 1
