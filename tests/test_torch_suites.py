"""The port's problem library and the reference's problem suites, in float64
on the CPU: the robustness set (tests/problems.py:289), LuksanVlcek 2-7 in
equality and inequality form at the reference tests' sizes
(tests/test_robustness_suite.py:43-63, tests/test_scalable_suite.py:22-40)
and the 2-D Mittelmann boundary control at N = 10, examples 1 and 3, through
the chained backend (test_scalable_suite.py:43-66).  Each solve gives the
reference's recorded status, iterations, factorizations and restorations
(``tests/torch_reference_values.json``), and its objective to rtol 1e-9.
The models themselves are held against the reference's at seeded points.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu.chained import canonicalize_chained as ref_canon_chained

import ipopt_torch
import torch_cases
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)


@pytest.mark.parametrize("name", torch_cases.suite_cases("suites"))
def test_matches_recorded_reference(name):
    assert_matches_recorded(name, torch_cases.solve_port(name, {})[1])


def test_mittelmann_example_1_is_chaotic():
    """Why the example-1 cases hold status and objective only: a relative
    change of 1e-15 in x0 changes the port's own iteration count, so no two
    implementations that round differently can be held to one count."""
    counts, objs = [], []
    for eps in (0.0, 1e-15):
        prob = ipopt_torch.modellib.mittelmann_bndry_control(10, 1)
        prob.x0 = np.asarray(prob.x0) * (1.0 + eps)
        res = ipopt_torch.solve(prob, device="cpu", print_level=0)
        assert int(res.status) == 0
        counts.append(int(res.iter_count))
        objs.append(float(res.obj))
    assert counts[0] != counts[1], counts
    np.testing.assert_allclose(objs[0], objs[1], rtol=1e-7)


LV_MODELS = [(k, n, eq) for k, n in ((2, 20), (3, 20), (4, 16), (5, 16), (6, 17),
                                     (7, 16)) for eq in (True, False)]


@pytest.mark.parametrize("k,n,eq", LV_MODELS)
def test_luksan_vlcek_model_matches_reference(k, n, eq):
    """f, g and the bounds at seeded points; the declared sparsity of LV4
    and LV5 as the reference's."""
    ref = getattr(ipopt_tpu.modellib, f"luksan_vlcek{k}")(n, eq)
    port = getattr(ipopt_torch.modellib, f"luksan_vlcek{k}")(n, eq)
    rng = np.random.default_rng(k)
    for _ in range(3):
        x = np.asarray(ref.x0) + 0.3 * rng.standard_normal(n)
        np.testing.assert_allclose(float(port.f(torch.as_tensor(x))),
                                   float(ref.f(jnp.asarray(x))), rtol=1e-13)
        np.testing.assert_allclose(port.g(torch.as_tensor(x)).numpy(),
                                   np.asarray(ref.g(jnp.asarray(x))), rtol=1e-13,
                                   atol=1e-13)
    for a in ("x0", "g_L", "g_U"):
        np.testing.assert_array_equal(np.asarray(getattr(port, a)),
                                      np.asarray(getattr(ref, a)))
    for a in ("jac_g_sparsity", "lag_hess_sparsity"):
        if getattr(ref, a) is None:
            assert getattr(port, a) is None
        else:
            for u, v in zip(getattr(port, a), getattr(ref, a)):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("example", [1, 2, 3, 4])
def test_mittelmann_bndry_control_matches_reference(example):
    """The chained model's canonical arrays, and f and g at a seeded point."""
    ref = ref_canon_chained(ipopt_tpu.modellib.mittelmann_bndry_control(8, example),
                            ipopt_tpu.Options())
    port = ipopt_torch.canonicalize_chained(
        ipopt_torch.modellib.mittelmann_bndry_control(8, example))
    assert (port.chain.K, port.chain.v, port.chain.mk) == \
        (ref.chain.K, ref.chain.v, ref.chain.mk)
    for k in ("x_L", "x_U", "d_L", "d_U", "c_rhs", "x0", "has_xL", "has_xU",
              "obj_scale", "c_scale"):
        np.testing.assert_allclose(getattr(port, k)[0].numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-13, err_msg=k)
    x = np.asarray(ref.x0) + 0.1 * np.random.default_rng(example).standard_normal(
        ref.struct.n)
    np.testing.assert_allclose(port.eval_f(torch.as_tensor(x)[None])[0].item(),
                               float(ref.eval_f(jnp.asarray(x))), rtol=1e-13)
    np.testing.assert_allclose(port.eval_c(torch.as_tensor(x)[None])[0].numpy(),
                               np.asarray(ref.eval_c(jnp.asarray(x))), rtol=1e-13,
                               atol=1e-13)
