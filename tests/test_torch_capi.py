"""The C API of the PyTorch port, on the CPU (``IPOPT_TORCH_C_DEVICE=cpu``):
``ipopt_torch.interfaces.capi.solve_from_c`` with ctypes callbacks against
the reference's ``solve_from_c`` (status, x to 1e-8; its results recorded
in ``tests/torch_reference_values.json``), with and without the user's
derivatives; the port's C library (``ipopt_torch/native/``) built into
a temporary directory, with the reference's unchanged ``hs071_c`` example
and Fortran entry points (``native/``) linked against it, as
``tests/test_c_api.py`` runs them on the reference's library."""
import ctypes as ct
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.mark.parametrize("derivatives", [True, False], ids=["user", "fd"])
def test_solve_from_c_matches_reference(monkeypatch, derivatives):
    """The port's solve_from_c against the reference's, recorded by
    ``tools/torch_reference_values.py capi`` (status, x to 1e-8)."""
    monkeypatch.setenv("IPOPT_TORCH_C_DEVICE", "cpu")
    from ipopt_torch.interfaces import capi as port
    name = "user" if derivatives else "fd"
    rec = torch_cases.recorded()[f"capi:{name}"]
    r_port = torch_cases.capi_solve(port, name)
    assert r_port[0] == rec["status"] == 0
    np.testing.assert_allclose(r_port[1], rec["x"], atol=1e-8)
    assert abs(r_port[2] - 17.0140171451792) < 1e-6


def test_solve_from_c_refuses_no_device_silently(monkeypatch):
    """Without IPOPT_TORCH_C_DEVICE the solve runs on the card, and without
    one it raises rather than falling back to the CPU."""
    monkeypatch.delenv("IPOPT_TORCH_C_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ipopt_torch.interfaces import capi as port
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_cases.capi_solve(port, "user")


def _env():
    return dict(os.environ, IPOPT_TORCH_C_DEVICE="cpu",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _run_hs071(exe):
    out = subprocess.run([exe], env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "EXIT: Optimal Solution Found." in out.stdout


@pytest.fixture(scope="module")
def cmake_build(tmp_path_factory):
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("cmake/ninja not available")
    build = str(tmp_path_factory.mktemp("ipopt_torch_c"))
    subprocess.run(["cmake", "-G", "Ninja", "-S", os.path.join(REPO, "ipopt_torch", "native"),
                    "-B", build, f"-DPython3_EXECUTABLE={sys.executable}"],
                   check=True, capture_output=True)
    subprocess.run(["ninja", "-C", build], check=True, capture_output=True)
    return build


def test_hs071_c_against_port_library(cmake_build):
    _run_hs071(os.path.join(cmake_build, "hs071_c"))


def test_python_builder(tmp_path):
    """ipopt_torch.native.build (gcc/g++ and sysconfig, no cmake) builds the
    same library and example."""
    if shutil.which("gcc") is None or shutil.which("g++") is None:
        pytest.skip("gcc/g++ not available")
    from ipopt_torch.native.build import build
    out = build(str(tmp_path))
    _run_hs071(out["hs071_c"])


def test_fortran_entry_points_against_port_library(cmake_build, monkeypatch):
    """The reference's Fortran shim (IPCREATE/IPSOLVE/..., all arguments by
    reference, column-major Jacobian, blank-padded option strings) inside
    the port's library, loaded into this process
    (tests/test_c_api.py:33-127)."""
    monkeypatch.setenv("IPOPT_TORCH_C_DEVICE", "cpu")
    lib = ct.CDLL(os.path.join(cmake_build, "libipopt_torch_c.so"))
    ipindex, ipnumber = ct.c_int, ct.c_double
    P = ct.POINTER
    F_CB = ct.CFUNCTYPE(None, P(ipindex), P(ipnumber), P(ipnumber),
                        P(ipindex), P(ipnumber), P(ipindex))
    G_CB = ct.CFUNCTYPE(None, P(ipindex), P(ipnumber), P(ipindex),
                        P(ipnumber), P(ipindex), P(ipnumber), P(ipindex))
    JG_CB = ct.CFUNCTYPE(None, P(ipindex), P(ipnumber), P(ipindex),
                         P(ipnumber), P(ipindex), P(ipnumber), P(ipindex))

    @F_CB
    def eval_f(N, X, OBJ, IDAT, DDAT, IERR):
        OBJ[0] = X[0] * X[3] * (X[0] + X[1] + X[2]) + X[2]
        IERR[0] = 0

    @G_CB
    def eval_g(N, X, M, G, IDAT, DDAT, IERR):
        G[0] = X[0] * X[1] * X[2] * X[3]
        G[1] = X[0] ** 2 + X[1] ** 2 + X[2] ** 2 + X[3] ** 2
        IERR[0] = 0

    @F_CB
    def eval_grad_f(N, X, GRAD, IDAT, DDAT, IERR):
        GRAD[0] = X[3] * (2 * X[0] + X[1] + X[2])
        GRAD[1] = X[0] * X[3]
        GRAD[2] = X[0] * X[3] + 1.0
        GRAD[3] = X[0] * (X[0] + X[1] + X[2])
        IERR[0] = 0

    @JG_CB
    def eval_jac_g(N, X, M, JAC, IDAT, DDAT, IERR):
        dg = [[X[1] * X[2] * X[3], X[0] * X[2] * X[3], X[0] * X[1] * X[3],
               X[0] * X[1] * X[2]], [2 * X[0], 2 * X[1], 2 * X[2], 2 * X[3]]]
        for i in range(2):
            for j in range(4):
                JAC[i + j * 2] = dg[i][j]
        IERR[0] = 0

    lib.ipcreate_.restype = ct.c_void_p
    n, m = ipindex(4), ipindex(2)
    prob = lib.ipcreate_(ct.byref(n), (ipnumber * 4)(1, 1, 1, 1),
                         (ipnumber * 4)(5, 5, 5, 5), ct.byref(m),
                         (ipnumber * 2)(25.0, 40.0), (ipnumber * 2)(2e19, 40.0),
                         eval_f, eval_g, eval_grad_f, eval_jac_g)
    assert prob
    fp = ct.c_void_p(prob)
    tol, pl = ipnumber(1e-8), ipindex(0)
    assert lib.ipaddnumoption_(ct.byref(fp), b"tol   ", ct.byref(tol), ct.c_int(6)) == 0
    assert lib.ipaddintoption_(ct.byref(fp), b"print_level", ct.byref(pl),
                               ct.c_int(11)) == 0
    assert lib.ipaddstroption_(ct.byref(fp), b"mu_strategy ", b"monotone  ",
                               ct.c_int(12), ct.c_int(10)) == 0
    x = (ipnumber * 4)(1.0, 5.0, 5.0, 1.0)
    obj = ipnumber(0.0)
    status = lib.ipsolve_(ct.byref(fp), x, (ipnumber * 2)(), ct.byref(obj),
                          (ipnumber * 2)(), (ipnumber * 4)(), (ipnumber * 4)(), None, None)
    assert status in (0, 1), status
    assert abs(obj.value - 17.0140171451792) < 1e-6
    assert abs(x[0] - 1.0) < 1e-5
    lib.ipfree_(ct.byref(fp))
