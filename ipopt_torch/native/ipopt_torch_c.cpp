/*
 * The C API of ipopt_torch: embeds CPython and drives the PyTorch solver
 * through ipopt_torch.interfaces.capi, which wraps the C callbacks as
 * differentiable tensor functions.  One interpreter per process, started
 * on the first solve (or the caller's, when the library is loaded into a
 * running Python).  The exported symbols are those of native/ipopt_tpu_c.h,
 * so the Fortran shim (native/ipopt_tpu_f.c), the JNI bridge
 * (native/ipopt_tpu_jni.c) and the C examples build against this library
 * unchanged.
 *
 * IPOPT_TORCH_SYS_PATH (a compile-time string, os.pathsep-separated) is put
 * in front of the embedded interpreter's sys.path: the builder passes the
 * repository root and the building interpreter's path, so the library
 * finds ipopt_torch and torch wherever it is run from.
 *
 * Reference parity: src/Interfaces/IpStdCInterface.cpp.
 */
#include "ipopt_tpu_c.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

struct IpoptTpuProblemInfo {
    ipindex n = 0;
    ipindex m = 0;
    std::vector<ipnumber> x_L, x_U, g_L, g_U;
    IpoptTpu_Eval_F eval_f = nullptr;
    IpoptTpu_Eval_G eval_g = nullptr;
    IpoptTpu_Eval_Grad_F eval_grad_f = nullptr;
    IpoptTpu_Eval_Jac_G eval_jac_g = nullptr;
    // option key -> python literal repr ("1e-6", "'adaptive'", "3")
    std::vector<std::pair<std::string, std::string>> options;
    void* user_data = nullptr;
    ipindex iter_count = 0;
};

#ifndef IPOPT_TORCH_SYS_PATH
#define IPOPT_TORCH_SYS_PATH ""
#endif

static bool ensure_python() {
    if (Py_IsInitialized()) return true;
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) return false;
    // the builder's path first (the embedded interpreter starts from the
    // base installation's sys.path)
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* extra = PyUnicode_FromString(IPOPT_TORCH_SYS_PATH);
    PyObject* sep = PyUnicode_FromString(":");
    PyObject* parts = (extra && sep) ? PyUnicode_Split(extra, sep, -1) : nullptr;
    if (sys_path && parts) {
        Py_ssize_t k = PyList_Size(parts);
        for (Py_ssize_t i = k - 1; i >= 0; --i) {
            PyObject* p = PyList_GetItem(parts, i);  // borrowed
            if (PyUnicode_GetLength(p) > 0) PyList_Insert(sys_path, 0, p);
        }
    }
    Py_XDECREF(parts);
    Py_XDECREF(sep);
    Py_XDECREF(extra);
    if (PyErr_Occurred()) PyErr_Print();
    // the GIL is taken per call (PyGILState_Ensure) from here on
    PyEval_SaveThread();
    return true;
}

extern "C" {

IpoptTpuProblem CreateIpoptTpuProblem(
    ipindex n, const ipnumber* x_L, const ipnumber* x_U,
    ipindex m, const ipnumber* g_L, const ipnumber* g_U,
    IpoptTpu_Eval_F eval_f, IpoptTpu_Eval_G eval_g,
    IpoptTpu_Eval_Grad_F eval_grad_f, IpoptTpu_Eval_Jac_G eval_jac_g) {
    if (n <= 0 || !eval_f) return nullptr;
    auto* p = new IpoptTpuProblemInfo();
    p->n = n;
    p->m = m;
    p->x_L.assign(x_L, x_L + n);
    p->x_U.assign(x_U, x_U + n);
    if (m > 0) {
        p->g_L.assign(g_L, g_L + m);
        p->g_U.assign(g_U, g_U + m);
    }
    p->eval_f = eval_f;
    p->eval_g = eval_g;
    p->eval_grad_f = eval_grad_f;
    p->eval_jac_g = eval_jac_g;
    return p;
}

void FreeIpoptTpuProblem(IpoptTpuProblem p) { delete p; }

int AddIpoptTpuNumOption(IpoptTpuProblem p, const char* k, ipnumber v) {
    if (!p || !k) return 0;
    char buf[64];
    snprintf(buf, sizeof buf, "%.17g", v);
    p->options.emplace_back(k, buf);
    return 1;
}

int AddIpoptTpuStrOption(IpoptTpuProblem p, const char* k, const char* v) {
    if (!p || !k || !v) return 0;
    p->options.emplace_back(k, std::string("'") + v + "'");
    return 1;
}

int AddIpoptTpuIntOption(IpoptTpuProblem p, const char* k, ipindex v) {
    if (!p || !k) return 0;
    p->options.emplace_back(k, std::to_string(v));
    return 1;
}

int IpoptTpuSolve(IpoptTpuProblem p, ipnumber* x, ipnumber* obj_val,
                  ipnumber* g_out, ipnumber* mult_g, ipnumber* mult_x_L,
                  ipnumber* mult_x_U, void* user_data) {
    if (!p || !x) return IPOPTTPU_INTERNAL_ERROR;
    if (!ensure_python()) return IPOPTTPU_INTERNAL_ERROR;
    p->user_data = user_data;

    PyGILState_STATE gil = PyGILState_Ensure();
    int status = IPOPTTPU_INTERNAL_ERROR;

    PyObject* mod = PyImport_ImportModule("ipopt_torch.interfaces.capi");
    if (!mod) {
        PyErr_Print();
        PyGILState_Release(gil);
        return IPOPTTPU_INTERNAL_ERROR;
    }
    PyObject* fn = PyObject_GetAttrString(mod, "solve_from_c");
    Py_DECREF(mod);
    if (!fn) {
        PyErr_Print();
        PyGILState_Release(gil);
        return IPOPTTPU_INTERNAL_ERROR;
    }

    // Pack everything as plain Python objects; callback pointers travel as
    // integers and are re-entered through ctypes on the Python side.
    std::string opts = "{";
    for (auto& kv : p->options)
        opts += "'" + kv.first + "': " + kv.second + ", ";
    opts += "}";

    PyObject* x_list = PyList_New(p->n);
    PyObject* xl = PyList_New(p->n);
    PyObject* xu = PyList_New(p->n);
    for (ipindex i = 0; i < p->n; ++i) {
        PyList_SET_ITEM(x_list, i, PyFloat_FromDouble(x[i]));
        PyList_SET_ITEM(xl, i, PyFloat_FromDouble(p->x_L[i]));
        PyList_SET_ITEM(xu, i, PyFloat_FromDouble(p->x_U[i]));
    }
    PyObject* gl = PyList_New(p->m);
    PyObject* gu = PyList_New(p->m);
    for (ipindex i = 0; i < p->m; ++i) {
        PyList_SET_ITEM(gl, i, PyFloat_FromDouble(p->g_L[i]));
        PyList_SET_ITEM(gu, i, PyFloat_FromDouble(p->g_U[i]));
    }

    PyObject* args = Py_BuildValue(
        "(iiOOOOOKKKKKs)", (int)p->n, (int)p->m, x_list, xl, xu, gl, gu,
        (unsigned long long)(uintptr_t)p->eval_f,
        (unsigned long long)(uintptr_t)p->eval_g,
        (unsigned long long)(uintptr_t)p->eval_grad_f,
        (unsigned long long)(uintptr_t)p->eval_jac_g,
        (unsigned long long)(uintptr_t)p->user_data,
        opts.c_str());
    Py_DECREF(x_list);
    Py_DECREF(xl);
    Py_DECREF(xu);
    Py_DECREF(gl);
    Py_DECREF(gu);

    PyObject* res = args ? PyObject_CallObject(fn, args) : nullptr;
    Py_XDECREF(args);
    Py_DECREF(fn);

    if (res && PyTuple_Check(res) && PyTuple_Size(res) >= 6) {
        if (PyTuple_Size(res) >= 7)
            p->iter_count =
                (ipindex)PyLong_AsLong(PyTuple_GetItem(res, 6));
        status = (int)PyLong_AsLong(PyTuple_GetItem(res, 0));
        PyObject* xs = PyTuple_GetItem(res, 1);
        for (ipindex i = 0; i < p->n; ++i)
            x[i] = PyFloat_AsDouble(PyList_GetItem(xs, i));
        if (obj_val) *obj_val = PyFloat_AsDouble(PyTuple_GetItem(res, 2));
        if (g_out && p->m) {
            PyObject* gs = PyTuple_GetItem(res, 3);
            for (ipindex i = 0; i < p->m; ++i)
                g_out[i] = PyFloat_AsDouble(PyList_GetItem(gs, i));
        }
        if (mult_g && p->m) {
            PyObject* ys = PyTuple_GetItem(res, 4);
            for (ipindex i = 0; i < p->m; ++i)
                mult_g[i] = PyFloat_AsDouble(PyList_GetItem(ys, i));
        }
        if (mult_x_L && mult_x_U) {
            PyObject* zs = PyTuple_GetItem(res, 5);
            for (ipindex i = 0; i < p->n; ++i) {
                mult_x_L[i] = PyFloat_AsDouble(PyList_GetItem(zs, i));
                mult_x_U[i] =
                    PyFloat_AsDouble(PyList_GetItem(zs, p->n + i));
            }
        }
    } else {
        PyErr_Print();
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return status;
}

/* EXIT strings matching the reference's final messages
 * (IpIpoptApplication.cpp:664-747). */
const char* IpoptTpuStatusMessage(int status) {
    switch (status) {
        case IPOPTTPU_SOLVE_SUCCEEDED: return "Optimal Solution Found.";
        case IPOPTTPU_SOLVED_TO_ACCEPTABLE_LEVEL:
            return "Solved To Acceptable Level.";
        case IPOPTTPU_INFEASIBLE_PROBLEM_DETECTED:
            return "Converged to a point of local infeasibility. Problem may "
                   "be infeasible.";
        case IPOPTTPU_SEARCH_DIRECTION_BECOMES_TOO_SMALL:
            return "Search Direction is becoming Too Small.";
        case IPOPTTPU_DIVERGING_ITERATES: return "Iterates diverging; problem "
                   "might be unbounded.";
        case IPOPTTPU_USER_REQUESTED_STOP: return "Stopping optimization at "
                   "current point as requested by user.";
        case IPOPTTPU_MAXITER_EXCEEDED:
            return "Maximum Number of Iterations Exceeded.";
        case IPOPTTPU_RESTORATION_FAILED: return "Restoration Failed!";
        case IPOPTTPU_ERROR_IN_STEP_COMPUTATION:
            return "Error in step computation!";
        case IPOPTTPU_INVALID_OPTION: return "Invalid option encountered.";
        default: return "INTERNAL ERROR: Unknown SolverReturn value.";
    }
}

ipindex IpoptTpuIterCount(IpoptTpuProblem p) {
    return p ? p->iter_count : 0;
}

}  // extern "C"
