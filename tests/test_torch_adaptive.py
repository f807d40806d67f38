"""The adaptive barrier strategy of the PyTorch port against the JAX
reference, in float64 on the CPU.

- The oracles and the update without a solve: one seeded HS071 iterate and
  one seeded chained LuksanVlcek1 (64, 4) iterate, with affine and
  centering steps drawn from the same seed, go through the reference's
  ``loqo_mu``, ``probing_mu``, ``quality_function_mu`` and
  ``adaptive_mu_update`` (eager) and through the port's; rtol 1e-12.
- Whole solves, live against the reference: HS071 adaptive (the default
  quality-function oracle and obj-constr-filter globalization), Mehrotra's
  mode with the affine corrector, LuksanVlcek1 chained (64, 4) and flat
  (n = 200, banded backend) adaptive, and an 8-lane HS071 family batch.
- Whole solves against the reference's recorded results
  (``tests/torch_reference_values.json``, written by
  ``tools/torch_reference_values.py``): the other oracles, globalizations,
  quality-function variants, safeguards, Mehrotra's mode, the correctors and
  more problems.
Solves: the same status, iterations and factorizations; objectives rtol
1e-9.  A batched adaptive solve equals each lane's own solve bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ipopt_tpu
from ipopt_tpu.algorithm import mu as ref_mu
from ipopt_tpu.algorithm.solver import _compl_max_fn as ref_compl_fn
from ipopt_tpu.batch import solve_batched as ref_solve_batched
from ipopt_tpu.types import Iterate as RefIterate

import ipopt_torch
from ipopt_torch import convert, modellib
from ipopt_torch.algorithm import mu as port_mu
from ipopt_torch.algorithm.solver import _compl_max_fn as port_compl_fn
from test_torch_core import port_from_ref, _random_iterate
from test_torch_chained import _ref_and_port
import problems
import torch_cases

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "torch_reference_values.json")) as _fh:
    RECORDED = json.load(_fh)


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=0, err_msg=err_msg)


@pytest.fixture(scope="module", params=["hs071", "lv1_chained"])
def point(request):
    """(reference canonical, port canonical, reference iterate, affine and
    centering steps, port iterate and steps) from one seed."""
    if request.param == "hs071":
        cref = ipopt_tpu.canonicalize(problems.hs071())
        cp = port_from_ref(cref, "hs071")
    else:
        cref, cp = _ref_and_port(64)
    rng = np.random.default_rng(11)
    blocks = _random_iterate(rng, cref)
    aff = [rng.standard_normal(np.shape(b)) for b in blocks]
    cent = [0.1 * rng.standard_normal(np.shape(b)) for b in blocks]
    ref = tuple(RefIterate(*(jnp.asarray(b) for b in bl)) for bl in (blocks, aff, cent))
    port = tuple(convert.iterate_from_arrays(bl) for bl in (blocks, aff, cent))
    return cref, cp, ref, port


QF_VARIANTS = [dict(), dict(quality_function_norm_type="1-norm"),
               dict(quality_function_norm_type="max-norm",
                    quality_function_centrality="log"),
               dict(quality_function_norm_type="2-norm",
                    quality_function_centrality="reciprocal",
                    quality_function_balancing_term="cubic"),
               dict(quality_function_centrality="cubed-reciprocal",
                    quality_function_max_section_steps=20,
                    quality_function_section_qf_tol=1e-3)]


def test_loqo_and_probing_match_reference(point):
    cref, cp, (it_r, aff_r, _), (it_p, aff_p, _) = point
    opts_r, opts_p = ipopt_tpu.Options(), ipopt_torch.Options()
    avg_p, n_p = port_mu.avg_complementarity(cp, it_p)
    avg_r, n_r = ref_mu.avg_complementarity(cref, it_r)
    _close(avg_p[0], avg_r)
    assert int(n_p[0]) == int(n_r)
    _close(port_mu.min_complementarity(cp, it_p)[0],
           ref_mu.min_complementarity(cref, it_r))
    _close(port_mu.loqo_mu(cp, it_p, opts_p)[0], ref_mu.loqo_mu(cref, it_r, opts_r))
    _close(port_mu.probing_mu(cp, it_p, opts_p, aff_p)[0],
           ref_mu.probing_mu(cref, it_r, opts_r, aff_r))


@pytest.mark.parametrize("variant", range(len(QF_VARIANTS)))
def test_quality_function_matches_reference(point, variant):
    cref, cp, (it_r, aff_r, cent_r), (it_p, aff_p, cent_p) = point
    kw = QF_VARIANTS[variant]
    dual_inf, primal_inf, tau = 0.37, 1.3, 0.99
    got = port_mu.quality_function_mu(
        cp, it_p, ipopt_torch.Options(**kw), aff_p, cent_p,
        torch.tensor([dual_inf], dtype=torch.float64),
        torch.tensor([primal_inf], dtype=torch.float64),
        torch.tensor([tau], dtype=torch.float64))
    want = ref_mu.quality_function_mu(cref, it_r, ipopt_tpu.Options(**kw), aff_r,
                                      cent_r, dual_inf, primal_inf, tau)
    _close(got[0], want)


def _ams_pair(rng, free_mode, n_filter):
    """A seeded AdaptiveMuState in both packages."""
    cap = ref_mu._OBJ_FILTER_CAP
    th = np.full(cap, np.inf)
    ff = np.full(cap, np.inf)
    th[:n_filter] = rng.uniform(0.0, 3.0, n_filter)
    ff[:n_filter] = rng.uniform(-50.0, 50.0, n_filter)
    fields = dict(free_mode=free_mode, ref_kkt_error=float(rng.uniform(0.5, 2.0)),
                  no_progress_count=2, filt_theta=th, filt_f=ff, filt_size=n_filter,
                  mu_max_dyn=-1.0, init_dual_inf=-1.0, init_primal_inf=-1.0,
                  just_switched=False)
    ref = ref_mu.AdaptiveMuState(**{k: jnp.asarray(v) for k, v in fields.items()})
    port = port_mu.AdaptiveMuState(**{k: torch.as_tensor(np.asarray(v))[None]
                                      for k, v in fields.items()})
    return ref, port


@pytest.mark.parametrize("kw,free_mode,n_filter", [
    (dict(), True, 3), (dict(), True, 0), (dict(), False, 3),
    (dict(adaptive_mu_globalization="kkt-error", adaptive_mu_safeguard_factor=0.01,
          adaptive_mu_kkt_norm_type="1-norm"), True, 0),
    (dict(adaptive_mu_globalization="kkt-error", adaptive_mu_kkt_norm_type="max-norm",
          adaptive_mu_kkterror_red_iters=2), True, 0),
    (dict(adaptive_mu_globalization="never-monotone-mode", mu_max=10.0,
          adaptive_mu_kkt_norm_type="2-norm"), True, 0)])
def test_adaptive_mu_update_matches_reference(point, kw, free_mode, n_filter):
    cref, cp, (it_r, aff_r, cent_r), (it_p, aff_p, cent_p) = point
    rng = np.random.default_rng(5)
    ams_r, ams_p = _ams_pair(rng, free_mode, n_filter)
    opts_r, opts_p = ipopt_tpu.Options(**kw), ipopt_torch.Options(**kw)
    s_c, dual_s, primal, mu, tau = 1.7, 0.3, 0.02, 0.05, 0.95
    theta, f = float(rng.uniform(0.0, 3.0)), float(rng.uniform(-50.0, 50.0))
    avg_r, _ = ref_mu.avg_complementarity(cref, it_r)
    args_r = dict(theta_curr=theta, f_curr=f, avg_compl_val=avg_r,
                  dual1_avg=0.8, primal1_avg=0.6,
                  fix_mu_val=ref_mu.loqo_mu(cref, it_r, opts_r))
    oracle_r = ref_mu.probing_mu(cref, it_r, opts_r, aff_r)
    new_r, ms_r = ref_mu.adaptive_mu_update(
        opts_r, ams_r, ref_mu.MuState(jnp.asarray(mu), jnp.asarray(tau)), oracle_r,
        dual_s, primal, ref_compl_fn(cref, it_r, s_c), **args_r)

    def t(v):
        return torch.tensor([v], dtype=torch.float64)

    new_p, ms_p = port_mu.adaptive_mu_update(
        opts_p, ams_p, port_mu.MuState(t(mu), t(tau)),
        port_mu.probing_mu(cp, it_p, opts_p, aff_p), t(dual_s), t(primal),
        port_compl_fn(cp, it_p, t(s_c)), t(theta), t(f),
        port_mu.avg_complementarity(cp, it_p)[0], t(0.8), t(0.6),
        port_mu.loqo_mu(cp, it_p, opts_p))
    _close(ms_p.mu[0], ms_r.mu, "mu")
    _close(ms_p.tau[0], ms_r.tau, "tau")
    for name in new_r._fields:
        a, b = getattr(new_p, name)[0].numpy(), np.asarray(getattr(new_r, name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            _close(a, b, name)


# -- whole solves, live against the reference --------------------------------

LIVE = {
    # resto_phase=False: none of these solves enters restoration, and it
    # halves the reference's compile time
    "hs071": (lambda P: torch_cases.build("hs071_d0", P),
              dict(mu_strategy="adaptive", resto_phase=False)),
    "hs071_mehrotra_affine": (lambda P: torch_cases.build("hs071_d0", P),
                              dict(mehrotra_algorithm=True, corrector_type="affine",
                                   resto_phase=False)),
    "lv1_chained": (lambda P: torch_cases.build(("luksan_vlcek1", (64, 4)), P),
                    dict(torch_cases.BENCH, mu_strategy="adaptive", resto_phase=False)),
    "lv1_banded": (lambda P: torch_cases.build(("luksan_vlcek1_flat", (200,)), P),
                   dict(torch_cases.BENCH, mu_strategy="adaptive", resto_phase=False,
                        linear_solver="banded-bcr")),
}


@pytest.mark.parametrize("name", sorted(LIVE))
def test_solve_matches_reference(name):
    build, opts = LIVE[name]
    res_r = ipopt_tpu.solve(build("ref"), print_level=0, **opts)
    res_p = ipopt_torch.solve(build("port"), device="cpu", print_level=0, **opts)
    assert int(res_p.status) == int(res_r.status) == 0
    assert int(res_p.iter_count) == int(res_r.iter_count)
    for k in ("n_factorizations", "n_kkt_solves", "n_obj_evals", "n_grad_evals"):
        assert int(getattr(res_p.counters, k)) == int(getattr(res_r.counters, k)), k
    np.testing.assert_allclose(float(res_p.obj), float(res_r.obj), rtol=1e-9)
    np.testing.assert_allclose(res_p.x.numpy(), np.asarray(res_r.x), rtol=1e-7,
                               atol=1e-9)
    if name == "hs071":
        # the reference's adaptive HS071: 8 iterations, 17.014017140224112
        assert int(res_p.iter_count) == 8
        np.testing.assert_allclose(float(res_p.obj), 17.014017140224112, rtol=1e-12)


# -- whole solves against the recorded reference ------------------------------

def assert_matches_recorded(name, rec):
    """The port's result ``rec`` of case ``name`` against the reference's.
    A case marked chaotic (tests/torch_cases.py) holds status and objective
    (rtol 1e-7) only; a case with ``obj_atol`` (an objective at the solve's
    tolerance from zero) holds the objective to that absolute tolerance."""
    want = RECORDED[name]
    assert rec["status"] == want["status"], (name, rec["status"], want["status"])
    if torch_cases.CASES[name].get("chaotic"):
        np.testing.assert_allclose(rec["obj"], want["obj"], rtol=1e-7, err_msg=name)
        return
    assert rec["iter_count"] == want["iter_count"], name
    assert rec["n_factorizations"] == want["n_factorizations"], name
    assert rec["n_kkt_solves"] == want["n_kkt_solves"], name
    assert rec["restoration_count"] == want["restoration_count"], name
    if want["status"] in (0, 1):
        atol = torch_cases.CASES[name].get("obj_atol", 1e-14)
        np.testing.assert_allclose(rec["obj"], want["obj"], rtol=1e-9, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def iterates():
    return {}


@pytest.mark.parametrize("name", torch_cases.suite_cases("adaptive"))
def test_matches_recorded_reference(name, iterates):
    _, rec = torch_cases.solve_port(name, iterates)
    assert_matches_recorded(name, rec)


# -- batches -----------------------------------------------------------------

DELTAS = [0.005 * i for i in range(6)] + [0.5, -0.5]


def test_adaptive_batch_equals_lanes_and_reference():
    opts = dict(torch_cases.BENCH, mu_strategy="adaptive", resto_phase=False)
    batch = ipopt_torch.solve_batched([modellib.hs071_family(d) for d in DELTAS],
                                      device="cpu", **opts)
    for i, d in enumerate(DELTAS):
        one = ipopt_torch.solve_batched([modellib.hs071_family(d)], device="cpu",
                                        **opts)
        assert int(one.status[0]) == int(batch.status[i])
        assert int(one.iter_count[0]) == int(batch.iter_count[i])
        assert torch.equal(one.x[0], batch.x[i]), i
        assert torch.equal(one.obj[0], batch.obj[i]), i
        assert torch.equal(one.mu[0], batch.mu[i]), i
    fam = [ipopt_tpu.NLP(**{**torch_cases._hs071_spec(jnp, jnp.array, d),
                            "name": "hs071"}) for d in DELTAS]
    res_r = ref_solve_batched(fam, ipopt_tpu.Options(print_level=0, **opts))
    np.testing.assert_array_equal(batch.status.numpy(), np.asarray(res_r.status))
    np.testing.assert_array_equal(batch.iter_count.numpy(),
                                  np.asarray(res_r.iter_count))
    np.testing.assert_allclose(batch.obj.numpy(), np.asarray(res_r.obj), rtol=1e-9)
