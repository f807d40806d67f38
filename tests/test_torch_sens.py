"""NLP sensitivity of the PyTorch port (``ipopt_torch/sens.py``) against the
JAX reference's ``ipopt_tpu/sens.py``, in float64 on the CPU.

Each computation of ``torch_cases.SENS`` (the five cases of
tests/test_sens.py, the right-hand-side variants, and the chained 1-D
boundary control at (64, 4): a step in its penalty parameter alpha and the
reduced Hessian on its two boundary controls) runs at the reference's own
final iterate, converted, and is held to the reference's recorded result
(``tools/torch_reference_values.py``): every block to 1e-10.  The port's
solves of those problems match the reference's records; a batch of lanes
gives each lane's own result.
"""
import numpy as np
import pytest
import torch

import ipopt_torch
from ipopt_torch import Options, sens
from ipopt_torch.chained import ChainedNLP, canonicalize_chained
from ipopt_torch.convert import (iterate_from_arrays, params_from_arrays,
                                 sensitivity_from_arrays)
import torch_cases
from test_torch_adaptive import RECORDED, assert_matches_recorded

torch.set_num_threads(1)


def _canonical(case_name):
    case = torch_cases.CASES[case_name]
    opts = Options(**case["opts"])
    problem = torch_cases.build(case["problem"], "port")
    if isinstance(problem, ChainedNLP):
        return canonicalize_chained(problem, opts), opts
    return ipopt_torch.canonicalize(problem, opts), opts


def _flat(out):
    """The leaves of a result, in the order of the reference's
    ``jax.tree.leaves``."""
    if isinstance(out, tuple):
        return [a for v in out for a in _flat(v)]
    return [out.numpy()]


@pytest.mark.parametrize("name", sorted(torch_cases.SENS))
def test_matches_reference_at_its_iterate(name):
    case_name, fn, arg, kw = torch_cases.SENS[name]
    nlp, opts = _canonical(case_name)
    it = [np.asarray(v) for v in RECORDED[case_name]["iterate"]]
    out = getattr(sens, fn)(nlp, opts, it, arg, device="cpu", **kw)
    got = _flat(out)
    want = [np.asarray(v, dtype=np.float64) for v in RECORDED[f"sens:{name}"]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64).reshape(w.shape),
                                   w, rtol=1e-10, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("name", torch_cases.suite_cases("sens"))
def test_solves_match_recorded(name):
    _, rec = torch_cases.solve_port(name, {})
    assert_matches_recorded(name, rec)


def test_batch_equals_each_lane():
    """Three parametric QPs solved as one batch: the batched sensitivity
    step is each lane's own, bit for bit."""
    opts = Options(print_level=0, **torch_cases.SENS_OPTS)
    ps = [np.array([1.0, 2.0]), np.array([0.5, -1.0]), np.array([2.0, 0.0])]

    def nlp(p):
        return ipopt_torch.NLP(**dict(torch_cases.HS_SPECS["sens_pqp"](
            torch, torch.stack), params=p))

    res = ipopt_torch.solve_batched([nlp(p) for p in ps], opts, device="cpu")
    batch = ipopt_torch.batch.stack_problems([nlp(p) for p in ps], opts)
    dp = np.array([0.1, -0.05])
    sb = sens.sensitivity_step(batch, opts, res.iterate, dp, device="cpu")
    for i, p in enumerate(ps):
        one = ipopt_torch.canonicalize(nlp(p), opts)
        it = [v[i:i + 1] for v in res.iterate]
        s1 = sens.sensitivity_step(one, opts, it, dp, device="cpu")
        for a, b in zip(sb, s1):
            assert torch.equal(a[i], b[0])


def test_runs_on_the_card_by_default(monkeypatch):
    nlp, opts = _canonical("sens_pqp")
    it = [np.asarray(v) for v in RECORDED["sens_pqp"]["iterate"]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sens.sensitivity_step(nlp, opts, it, np.array([0.1, 0.0]))


def test_converters_carry_the_reference_state():
    """The reference's iterate, parameters and sensitivity result carried
    into the port (ipopt_torch.convert): a step from the converted state
    equals the converted reference step."""
    nlp, opts = _canonical("sens_pqp")
    it = iterate_from_arrays([np.asarray(v) for v in RECORDED["sens_pqp"]["iterate"]])
    assert it.x.shape == (1, 2) and it.y_c.shape == (1, 1)
    nlp = nlp._replace(params=params_from_arrays(np.array([1.0, 2.0])))
    assert nlp.params.shape == (1, 2)
    got = sens.sensitivity_step(nlp, opts, it, np.array([0.1, -0.05]), device="cpu")
    want = sensitivity_from_arrays([np.asarray(v) for v in RECORDED["sens:step"]])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)
