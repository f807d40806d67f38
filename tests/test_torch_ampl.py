"""The AMPL interface of the PyTorch port (``ipopt_torch/interfaces/ampl.py``)
against the reference's (``ipopt_tpu/interfaces/ampl.py``), in float64 on
the CPU, on the fixtures of ``tests/test_ampl.py`` (imported, not copied):
evaluations and derivatives against the reference's reader (which evaluates
the expression tree node by node) in ASCII and binary, the binary
transcoding byte for byte, defined variables, the CLI and its .sol, the
suffix warm start, the sIPOPT suffixes, and the generated LuksanVlcek1 .nl
(tape against the reference's node-by-node evaluation; declared patterns and
the banded solve against ``modellib.luksan_vlcek1_flat``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacrev

from ipopt_tpu.interfaces import ampl as ref_ampl

import ipopt_torch
from ipopt_torch import modellib
from ipopt_torch.interfaces import ampl
from test_ampl import DEFVAR_NL, HS071_NL, PARAMETRIC_NL

torch.set_num_threads(1)
F_STAR = 17.0140171451792
X_STAR = np.array([1.0, 4.74299963, 3.82114998, 1.37940829])
FIXTURES = {"hs071": HS071_NL, "defvar": DEFVAR_NL, "parametric": PARAMETRIC_NL}


def _write(tmp_path, name, text):
    p = tmp_path / f"{name}.nl"
    p.write_text(text)
    return str(p)


def _values(nlp, x, pkg):
    """f, g, grad f, J at x, as numpy."""
    if pkg == "ref":
        xj = jnp.asarray(x)
        out = [nlp.f(xj), jax.grad(nlp.f)(xj)]
        if nlp.g is not None:
            out += [nlp.g(xj), jax.jacfwd(nlp.g)(xj)]
    else:
        xt = torch.tensor(x)
        out = [nlp.f(xt), grad(nlp.f)(xt)]
        if nlp.g is not None:
            out += [nlp.g(xt), jacrev(nlp.g)(xt)]
    return [np.asarray(v, np.float64) for v in out]


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_evaluations_match_reference(tmp_path, name, fmt):
    """f, g, grad f and J at seeded points = the reference's, to 1e-12."""
    path = _write(tmp_path, name, FIXTURES[name])
    if fmt == "binary":
        ampl.ascii_nl_to_binary(path, path + ".b")
        path += ".b"
    ref, port = ref_ampl.read_nl(path), ampl.read_nl(path)
    for fld in ("x0", "x_L", "x_U", "g_L", "g_U"):
        np.testing.assert_array_equal(np.asarray(getattr(port, fld)),
                                      np.asarray(getattr(ref, fld)), err_msg=fld)
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.uniform(0.5, 2.0, len(port.x0))
        for a, b in zip(_values(port, x, "port"), _values(ref, x, "ref")):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_binary_transcoding_is_the_references(tmp_path):
    path = _write(tmp_path, "parametric", PARAMETRIC_NL)
    ampl.ascii_nl_to_binary(path, path + ".port")
    ref_ampl.ascii_nl_to_binary(path, path + ".ref")
    with open(path + ".port", "rb") as a, open(path + ".ref", "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data[:1] == b"b"


def test_solve_nl_matches_hs071(tmp_path):
    """The .nl HS071 = modellib.hs071 (the reference's values): status,
    iterations, objective to 1e-9, x* to 1e-6."""
    res = ipopt_torch.solve(ampl.read_nl(_write(tmp_path, "hs071", HS071_NL)),
                            device="cpu", print_level=0)
    one = ipopt_torch.solve(modellib.hs071(), device="cpu", print_level=0)
    assert (int(res.status), int(res.iter_count)) == (0, int(one.iter_count))
    assert abs(float(res.obj) - F_STAR) < 1e-9
    np.testing.assert_allclose(res.x.numpy(), X_STAR, atol=1e-6)


def test_ampl_cli_writes_sol(tmp_path, capsys):
    path = _write(tmp_path, "hs071", HS071_NL)
    assert ampl.main([path, "-AMPL", "print_level=0", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "EXIT: Optimal Solution Found." in out
    with open(path[:-3] + ".sol") as fh:
        txt = fh.read()
    assert "objno 0 0" in txt and "ipopt_zL_out" in txt
    x, y, status, suf = ampl.read_sol(path[:-3] + ".sol")
    assert status == 0
    np.testing.assert_allclose(x, X_STAR, atol=1e-6)
    # the reference's reader reads the port's .sol the same way
    xr, yr, sr, sufr = ref_ampl.read_sol(path[:-3] + ".sol")
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_array_equal(y, yr)
    assert suf == sufr


def test_defined_variables(tmp_path):
    nlp = ampl.read_nl(_write(tmp_path, "defvar", DEFVAR_NL))
    t = 0.5 + 2 * 0.5 + np.sin(0.1)
    x = torch.tensor([0.5, 0.5, 0.1], dtype=torch.float64)
    assert abs(float(nlp.f(x)) - (t - 2.0) ** 2) < 1e-12
    res = ipopt_torch.solve(nlp, device="cpu", print_level=0)
    assert int(res.status) == 0
    xs = res.x.numpy()
    assert abs(xs[0] + 2 * xs[1] + np.sin(xs[2]) - 2.0) < 1e-6


def test_suffix_warm_start_roundtrip(tmp_path):
    """Solve, write the .sol with dual suffixes, read them back into a d
    segment and ipopt_zL_in/ipopt_zU_in suffixes, warm-start: at most 3
    iterations (ampl_ipopt.cpp:77-83; tests/test_ampl.py:189-238)."""
    path = _write(tmp_path, "hs071", HS071_NL)
    res = ipopt_torch.solve(ampl.read_nl(path), device="cpu", print_level=0, tol=1e-8)
    sol = str(tmp_path / "hs071.sol")
    ampl.write_sol(sol, res, "ok")
    x_s, y_s, st, sufs = ampl.read_sol(sol)
    assert st == 0 and len(sufs["ipopt_zL_out"]) > 0
    lines = [HS071_NL.rstrip("\n"), f"d{len(y_s)}"]
    lines += [f"{i} {v:.17g}" for i, v in enumerate(y_s)]
    for name, suf in (("ipopt_zL_in", sufs["ipopt_zL_out"]),
                      ("ipopt_zU_in", sufs.get("ipopt_zU_out", {}))):
        if suf:
            lines.append(f"S4 {len(suf)} {name}")
            lines += [f"{i} {v:.17g}" for i, v in suf.items()]
    model = ampl.read_nl_model(_write(tmp_path, "warm", "\n".join(lines) + "\n"))
    assert model.nlp.y0 is not None and model.nlp.z_L0 is not None
    res_w = ipopt_torch.solve(dataclasses.replace(model.nlp, x0=x_s), device="cpu",
                              print_level=0, tol=1e-8, warm_start_init_point=True,
                              mu_init=1e-6, warm_start_bound_push=1e-9,
                              warm_start_bound_frac=1e-9,
                              warm_start_mult_bound_push=1e-9)
    assert int(res_w.status) == 0
    assert int(res_w.iter_count) <= 3
    assert abs(float(res_w.obj) - F_STAR) < 1e-7 * F_STAR


def test_sens_suffixes(tmp_path):
    """run_sens with the sIPOPT suffixes: sens_sol_state_1 = the re-solve of
    the perturbed QP (exact to first order; tests/test_ampl.py:319-354)."""
    path = _write(tmp_path, "parametric", PARAMETRIC_NL)
    assert ampl.main([path, "run_sens=1", "print_level=0", "tol=1e-10",
                      "device=cpu"]) == 0
    _, _, status, suf = ampl.read_sol(str(tmp_path / "parametric.sol"))
    pred = np.zeros(5)
    for i, v in suf["sens_sol_state_1"].items():
        pred[i] = v
    exact = ipopt_torch.solve(ipopt_torch.NLP(
        f=lambda z: z[0] ** 2 + z[1] ** 2 + z[2] ** 2,
        g=lambda z: torch.stack([6 * z[0] + 3 * z[1] + 2 * z[2] - z[3],
                                 z[0] + z[1] - z[2] - z[4], z[3], z[4]]),
        g_L=np.array([0.0, -1.0, 4.5, 1.0]), g_U=np.array([0.0, -1.0, 4.5, 1.0]),
        x_L=np.array([0.0, 0.0, 0.0, -1e20, -1e20]),
        x0=np.array([0.15, 0.15, 0.0, 5.0, 1.0])), device="cpu", print_level=0,
        tol=1e-10)
    assert int(exact.status) == 0
    np.testing.assert_allclose(pred, exact.x.numpy(), atol=2e-4)


def test_red_hessian_suffix(tmp_path, capsys):
    """compute_red_hessian prints the reduced Hessian over the red_hessian
    variables (SensApplication.cpp:73): a symmetric 2 x 2 matrix equal to
    ``sens.reduced_hessian`` at the solution."""
    nl = PARAMETRIC_NL.replace(
        "S4 2 sens_state_value_1\n3 4.5\n4 1.0\n",
        "S4 2 sens_state_value_1\n3 4.5\n4 1.0\nS0 2 red_hessian\n3 1\n4 2\n")
    path = _write(tmp_path, "parametric_rh", nl)
    assert ampl.main([path, "compute_red_hessian=1", "print_level=0", "tol=1e-10",
                      "device=cpu"]) == 0
    out = capsys.readouterr().out
    rows = out.split("Reduced Hessian (red_hessian suffix order):\n")[1].splitlines()[:2]
    H = np.array([[float(v) for v in r.split()] for r in rows])
    np.testing.assert_allclose(H, H.T, rtol=1e-9)
    model = ampl.read_nl_model(path)
    opts = ipopt_torch.Options(compute_red_hessian=True, tol=1e-10, print_level=0)
    res = ipopt_torch.solve(model.nlp, opts, device="cpu")
    want = ampl.compute_red_hessian_from_suffixes(model, opts, res, device="cpu")
    np.testing.assert_allclose(H, want, rtol=1e-8)


def test_tape_against_node_by_node(tmp_path):
    """The generated LuksanVlcek1 .nl at n = 50: the tape (a few tensor ops
    per level) against the reference's node-by-node evaluation, values and
    derivatives to 1e-12; against modellib.luksan_vlcek1_flat to 1e-12 and
    the same declared patterns."""
    path = str(tmp_path / "lv1.nl")
    ampl.write_luksan_vlcek1_nl(path, 50)
    model = ampl.read_nl_model(path)
    assert model.f_tape.n_groups <= 10 and model.g_tape.n_groups <= 12
    ref = ref_ampl.read_nl(path)
    py = modellib.luksan_vlcek1_flat(50)
    rng = np.random.RandomState(1)
    for _ in range(2):
        x = rng.standard_normal(50)
        mine = _values(model.nlp, x, "port")
        for a, b in zip(mine, _values(ref, x, "ref")):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-10)
        for a, b in zip(mine, _values(py, x, "port")):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-10)
    for pat in ("jac_g_sparsity", "lag_hess_sparsity"):
        got = sorted(zip(*(v.tolist() for v in getattr(model.nlp, pat))))
        want = sorted(zip(*(v.tolist() for v in getattr(py, pat))))
        assert got == want, pat


def test_generated_nl_banded_solve(tmp_path):
    """LuksanVlcek1 at n = 200 through ASCII -> binary .nl, solved with
    linear_solver="banded-bcr": status and iterations of
    luksan_vlcek1_flat(200), objective to 1e-9."""
    path = str(tmp_path / "lv1.nl")
    ampl.write_luksan_vlcek1_nl(path, 200)
    ampl.ascii_nl_to_binary(path, path + ".b")
    kw = dict(device="cpu", print_level=0, linear_solver="banded-bcr")
    r1 = ipopt_torch.solve(ampl.read_nl(path + ".b"), **kw)
    r2 = ipopt_torch.solve(modellib.luksan_vlcek1_flat(200), **kw)
    assert (int(r1.status), int(r1.iter_count)) == (int(r2.status), int(r2.iter_count))
    assert abs(float(r1.obj) - float(r2.obj)) < 1e-9


@pytest.mark.parametrize("edit,what", [
    (("0 0 0 0 0\n8 3", "1 0 0 0 0\n8 3"), "discrete"),
    (("r\n2 25", "F0 0 -1 f\nr\n2 25"), "imported functions"),
    (("r\n2 25", "L0 1\nr\n2 25"), "logical constraints"),
    (("x4\n", "S0 1 sosno\n0 1\nx4\n"), "SOS"),
    (("b\n0 1 5", "b\n5 1 5"), "complementarity")])
def test_rejects_what_the_reference_rejects(tmp_path, edit, what):
    path = _write(tmp_path, "bad", HS071_NL.replace(*edit, 1))
    for reader in (ampl.read_nl, ref_ampl.read_nl):
        with pytest.raises(NotImplementedError, match=what):
            reader(path)
