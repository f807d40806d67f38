"""The hooks of the PyTorch port against the JAX reference, in float64 on the
CPU: the custom KKT solver (``solve(..., custom_kkt_solver=)``, the
reference test's ``EighKKT``), finite-difference gradients and Jacobians,
``linear_solver="condensed-cholesky"`` (which the reference routes to
``dense-ldlt``), the derivative checker (``deriv_check.py``, and the
``derivative_test`` report of ``solve``), the profiling helpers
(``profiling.py``) and ``check_supported``, which refuses no option
value since ``chain_shard=True`` was ported.  Solves are held to the
reference's recorded results (``tools/torch_reference_values.py``): the same status,
iterations, factorizations and KKT solves, objectives to rtol 1e-9.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu import deriv_check as ref_dc
from ipopt_tpu import profiling as ref_prof

import ipopt_torch
from ipopt_torch import NLP, Options, modellib, profiling
from ipopt_torch import deriv_check as port_dc
from ipopt_torch.algorithm.solver import check_supported
import torch_cases
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)


@pytest.mark.parametrize("name", torch_cases.suite_cases("hooks"))
def test_matches_recorded_reference(name):
    _, rec = torch_cases.solve_port(name, {})
    assert_matches_recorded(name, rec)


def test_custom_solver_owns_both_halves():
    calls = {"factorize": 0, "solve": 0}
    inner = torch_cases.eigh_kkt("port")

    class Counting:
        def factorize(self, *a):
            calls["factorize"] += 1
            return inner.factorize(*a)

        def solve(self, *a):
            calls["solve"] += 1
            return inner.solve(*a)

    res = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                            custom_kkt_solver=Counting())
    assert int(res.status) == 0
    assert calls["factorize"] == int(res.counters.n_factorizations)
    assert calls["solve"] >= calls["factorize"]


def test_custom_without_a_solver_is_an_error():
    with pytest.raises(ValueError, match="custom_kkt_solver"):
        ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0,
                          linear_solver="custom")


def test_finite_differences_refused_on_structured_backends():
    """The reference's refusal (kkt.py:53-60): the chained backend never
    forms a Jacobian."""
    opts = dict(jacobian_approximation="finite-difference-values", print_level=0)
    with pytest.raises(NotImplementedError, match="dense backend"):
        ipopt_torch.solve(modellib.luksan_vlcek1(16, 4), device="cpu", **opts)
    ref = ipopt_tpu.chained.canonicalize_chained(
        ipopt_tpu.modellib.luksan_vlcek1(16, 4), ipopt_tpu.Options(**opts))
    with pytest.raises(NotImplementedError, match="dense backend"):
        ipopt_tpu.kkt.evaluate(ref, ref.x0)


def test_finite_difference_values_match_reference():
    """The forward-difference gradient and Jacobian at x0, to 1e-12."""
    FD = "finite-difference-values"
    kw = dict(gradient_approximation=FD, jacobian_approximation=FD)
    ref = ipopt_tpu.canonicalize(ipopt_tpu.modellib.hs071(), ipopt_tpu.Options(**kw))
    port = ipopt_torch.canonicalize(modellib.hs071(), Options(**kw))
    rv = [np.asarray(v) for v in ref.eval_all(ref.x0)]
    pv = [v[0].numpy() for v in port.eval_all(port.x0)]
    for r, p in zip(rv, pv):
        np.testing.assert_allclose(p, r, rtol=1e-12, atol=1e-12)


DERIV_CASES = {
    # tests/test_warmstart_derivcheck.py:37-60
    "smooth": (lambda m, arr: None, dict(derivative_test="second-order")),
    "nonsmooth": (lambda m, arr: dict(
        f=lambda x: m.sum(m.where(x > 0, x, 0.1 * x)), x0=np.array([0.0, 0.0])),
        dict(derivative_test="first-order", derivative_test_perturbation=1e-2,
             bound_relax_factor=0.0, nlp_scaling_method="none",
             point_perturbation_radius=0.0)),
}


@pytest.mark.parametrize("name", sorted(DERIV_CASES))
def test_check_derivatives_matches_reference(name):
    spec, kw = DERIV_CASES[name]
    ro, po = ipopt_tpu.Options(**kw), Options(**kw)
    if name == "smooth":
        rn = ipopt_tpu.canonicalize(ipopt_tpu.modellib.hs071(), ro)
        pn = ipopt_torch.canonicalize(modellib.hs071(), po)
    else:
        rn = ipopt_tpu.canonicalize(ipopt_tpu.NLP(**spec(jnp, jnp.array)), ro)
        pn = ipopt_torch.canonicalize(NLP(**spec(torch, torch.stack)), po)
    r = ref_dc.check_derivatives(rn, ro)
    p = port_dc.check_derivatives(pn, po, device="cpu")
    assert p.ok == r.ok == (name == "smooth")
    for f in ("max_rel_err_grad", "max_rel_err_jac", "max_rel_err_hess"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=1e-6,
                                   atol=1e-12, err_msg=f)
    assert p.failures == r.failures


def test_derivative_test_report(tmp_path):
    out = tmp_path / "out.txt"
    ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, max_iter=0,
                      derivative_test="second-order", output_file=str(out),
                      file_print_level=5)
    assert "Derivative checker passed" in out.read_text()


def test_timing_report_prints_as_the_reference():
    reports = []
    for mod in (ref_prof, profiling):
        rep = mod.TimingReport()
        rep.overall, rep.lin_factorization, rep.iters = 1.25, 0.5, 5
        lines = []
        rep.print(out=lines.append)
        reports.append(lines)
    assert reports[0] == reports[1]


def test_solve_timed_equals_solve():
    res, rep = profiling.solve_timed(modellib.hs071(), Options(print_level=0),
                                     print_report=False, device="cpu")
    plain = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0)
    assert int(res.status) == int(plain.status) == 0
    assert rep.iters == int(res.iter_count) == int(plain.iter_count)
    assert torch.equal(res.x, plain.x)
    assert rep.overall > 0 and rep.lin_factorization > 0
    lines = []
    rep.print(out=lines.append)
    assert any("KKT factorizations" in l for l in lines)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("hs071"):
            ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0, max_iter=1)
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "hs071" for e in events)


@pytest.mark.parametrize("kw", [dict(), dict(linear_solver="dense-ldlt-blocked"),
                                dict(factorization_dtype="float32"),
                                dict(hessian_approximation="limited-memory")])
def test_chain_shard_is_refused(kw):
    """chain_shard (the sharded chained factorization over devices) was the
    last option value the port refused; now it is ported, check_supported
    refuses nothing (tests/test_torch_chain_shard.py solves with it)."""
    from ipopt_torch.algorithm.solver import _SUPPORTED
    assert _SUPPORTED == ()
    check_supported(Options(chain_shard=True, **kw))
    check_supported(Options(**kw))
