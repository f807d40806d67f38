"""Python side of the C API (port of ``ipopt_tpu/interfaces/capi.py``; the
reference Ipopt's StdInterfaceTNLP, ``src/Interfaces/IpStdInterfaceTNLP.cpp``).

``solve_from_c`` receives the C callback pointers as integers from the C
library (``ipopt_torch/native/ipopt_torch_c.cpp``), rebuilds them with
ctypes, and wraps f and g as ``torch.autograd.Function``s whose forward
calls the callback on the host and whose derivatives come from the user's
``eval_grad_f`` / ``eval_jac_g`` or, without them, from forward differences
with h = 1e-7 (``jacobian_approximation`` semantics, IpTNLPAdapter.hpp:258).
The solver differentiates with ``torch.func`` (``jvp``/``vjp`` under
``vmap``), so each Function defines ``setup_context``, ``jvp``, ``backward``
and a ``vmap`` rule that calls the callbacks lane by lane.  The Hessian is
approximated (``hessian_approximation="limited-memory"``), as the reference
does for a C problem without ``eval_h``.

The solve runs on the device named by ``IPOPT_TORCH_C_DEVICE`` (the
reference's ``IPOPT_TPU_C_PLATFORM``), by default the CUDA device.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..problem import NLP
from ..options import Options
from ..types import SolverReturn, ApplicationReturnStatus, SOLVER_TO_APP_STATUS
from ..algorithm.solver import solve

_DBL = ctypes.POINTER(ctypes.c_double)
_EVAL_F = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, _DBL, _DBL, ctypes.c_void_p)
_EVAL_G = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, _DBL, ctypes.c_int, _DBL,
                           ctypes.c_void_p)
_EVAL_GRAD_F = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, _DBL, _DBL,
                                ctypes.c_void_p)
_EVAL_JAC_G = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, _DBL, ctypes.c_int, _DBL,
                               ctypes.c_void_p)
FD_H = 1e-7


def _as_ptr(arr):
    return arr.ctypes.data_as(_DBL)


def _lanes(fn, info, in_dims, x):
    """A vmap rule: ``fn`` on every lane of x, stacked on dim 0."""
    x = (x.movedim(in_dims[0], 0) if in_dims[0] is not None
         else x.expand(info.batch_size, *x.shape))
    return torch.stack([fn(xi) for xi in x]), 0


def _host_function(value, derivative):
    """A differentiable tensor function from two host functions on float64
    numpy vectors: ``value(x)`` -> () or (m,), ``derivative(x)`` -> (n,) or
    (m, n).  The value's derivatives are ``derivative``; the derivative
    itself has none (no second derivatives)."""

    def on_host(fn, x):
        out = fn(np.ascontiguousarray(x.detach().cpu().numpy(), np.float64))
        return torch.as_tensor(np.asarray(out, np.float64), dtype=x.dtype,
                               device=x.device)

    class Derivative(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return on_host(derivative, x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def vmap(info, in_dims, x):
            return _lanes(Derivative.apply, info, in_dims, x)

    class Value(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return on_host(value, x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0])
            ctx.save_for_forward(inputs[0])

        @staticmethod
        def backward(ctx, g_out):
            (x,) = ctx.saved_tensors
            D = Derivative.apply(x)
            return g_out * D if D.dim() == 1 else g_out @ D

        @staticmethod
        def jvp(ctx, x_t):
            (x,) = ctx.saved_tensors
            return Derivative.apply(x) @ x_t

        @staticmethod
        def vmap(info, in_dims, x):
            return _lanes(Value.apply, info, in_dims, x)

    return Value.apply


def solve_from_c(n, m, x0, x_L, x_U, g_L, g_U, f_ptr, g_ptr, grad_ptr,
                 jac_ptr, user_data, options_repr):
    """Solve the C problem; returns (status, x, obj, g, mult_g, z_L + z_U,
    iterations), the tuple ``ipopt_torch_c.cpp`` unpacks."""
    f_cb = _EVAL_F(f_ptr)
    g_cb = _EVAL_G(g_ptr) if (g_ptr and m > 0) else None
    grad_cb = _EVAL_GRAD_F(grad_ptr) if grad_ptr else None
    jac_cb = _EVAL_JAC_G(jac_ptr) if (jac_ptr and m > 0) else None
    ud = ctypes.c_void_p(user_data)

    def f_host(xa):
        out = np.zeros(1)
        f_cb(n, _as_ptr(xa), _as_ptr(out), ud)
        return out[0]

    def g_host(xa):
        out = np.zeros(m)
        g_cb(n, _as_ptr(xa), m, _as_ptr(out), ud)
        return out

    def grad_host(xa):
        if grad_cb is not None:
            out = np.zeros(n)
            grad_cb(n, _as_ptr(xa), _as_ptr(out), ud)
            return out
        f0 = f_host(xa)
        out = np.zeros(n)
        for i in range(n):
            xp = xa.copy()
            xp[i] += FD_H
            out[i] = (f_host(xp) - f0) / FD_H
        return out

    def jac_host(xa):
        if jac_cb is not None:
            out = np.zeros(m * n)
            jac_cb(n, _as_ptr(xa), m, _as_ptr(out), ud)
            return out.reshape(m, n)
        g0 = g_host(xa)
        out = np.zeros((m, n))
        for i in range(n):
            xp = xa.copy()
            xp[i] += FD_H
            out[:, i] = (g_host(xp) - g0) / FD_H
        return out

    opts_dict = eval(options_repr, {"__builtins__": {}}, {})
    opts = Options().replace(hessian_approximation="limited-memory", **opts_dict)
    nlp = NLP(f=_host_function(f_host, grad_host),
              g=_host_function(g_host, jac_host) if m > 0 else None,
              x0=np.asarray(x0, np.float64),
              x_L=np.asarray(x_L, np.float64), x_U=np.asarray(x_U, np.float64),
              g_L=np.asarray(g_L, np.float64) if m else None,
              g_U=np.asarray(g_U, np.float64) if m else None, name="c_api")
    res = solve(nlp, opts, device=os.environ.get("IPOPT_TORCH_C_DEVICE", "cuda"))

    status = SOLVER_TO_APP_STATUS.get(
        SolverReturn(int(res.status)), ApplicationReturnStatus.INTERNAL_ERROR)

    def floats(v):
        return [float(u) for u in v.detach().cpu().reshape(-1)]
    return (int(status), floats(res.x), float(res.obj), floats(res.g), floats(res.y),
            floats(res.z_L) + floats(res.z_U), int(res.iter_count))
