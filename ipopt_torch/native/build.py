"""Build the C library of ipopt_torch with gcc/g++ and sysconfig's paths:
``python3 -m ipopt_torch.native.build [OUT_DIR]``.

Builds ``libipopt_torch_c.so`` from ``ipopt_torch/native/ipopt_torch_c.cpp``
and the reference's Fortran shim ``native/ipopt_tpu_f.c`` (compiled from its
own path, unchanged), then the reference's ``native/examples/hs071_c.c``
against it as ``hs071_c``, and the JNI bridge ``native/ipopt_tpu_jni.c``
as ``libipopt_torch_jni.so`` only where a JDK's headers are found (as
``native/CMakeLists.txt`` gates it).  The default output directory is
``ipopt_torch/_build/native/``.  ``ipopt_torch/native/CMakeLists.txt``
builds the same with CMake.
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
NATIVE = os.path.join(REPO, "native")
DEFAULT_OUT = os.path.join(REPO, "ipopt_torch", "_build", "native")


def python_flags():
    """(include dirs, link flags) of the running interpreter's libpython."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    return [inc], [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}", "-ldl", "-lm"]


def sys_path_define():
    """The repository root and this interpreter's sys.path, for the embedded
    interpreter (``IPOPT_TORCH_SYS_PATH``)."""
    paths = [REPO] + [p for p in sys.path if p and os.path.isdir(p)]
    return '-DIPOPT_TORCH_SYS_PATH="' + os.pathsep.join(paths) + '"'


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")


def _jni_include():
    home = os.environ.get("JAVA_HOME")
    if home and os.path.exists(os.path.join(home, "include", "jni.h")):
        inc = os.path.join(home, "include")
        return [inc, os.path.join(inc, "linux")]
    return None


def build(out_dir: str = DEFAULT_OUT) -> dict:
    """Compile and link; returns {"lib": ..., "hs071_c": ...[, "jni": ...]}."""
    os.makedirs(out_dir, exist_ok=True)
    incs, link = python_flags()
    inc_flags = [f"-I{d}" for d in incs + [NATIVE]]
    obj_c = os.path.join(out_dir, "ipopt_torch_c.o")
    obj_f = os.path.join(out_dir, "ipopt_tpu_f.o")
    lib = os.path.join(out_dir, "libipopt_torch_c.so")
    _run(["g++", "-std=c++17", "-O2", "-fPIC", "-c", sys_path_define(), *inc_flags,
          os.path.join(HERE, "ipopt_torch_c.cpp"), "-o", obj_c])
    _run(["gcc", "-O2", "-fPIC", "-c", *inc_flags, os.path.join(NATIVE, "ipopt_tpu_f.c"),
          "-o", obj_f])
    _run(["g++", "-shared", obj_c, obj_f, "-o", lib, *link])
    out = {"lib": lib, "hs071_c": os.path.join(out_dir, "hs071_c")}
    _run(["gcc", "-O2", f"-I{NATIVE}", os.path.join(NATIVE, "examples", "hs071_c.c"),
          "-o", out["hs071_c"], f"-L{out_dir}", f"-Wl,-rpath,{out_dir}",
          "-lipopt_torch_c", "-lm"])
    jni = _jni_include()
    if jni:
        out["jni"] = os.path.join(out_dir, "libipopt_torch_jni.so")
        _run(["gcc", "-O2", "-fPIC", "-shared", f"-I{NATIVE}", *(f"-I{d}" for d in jni),
              os.path.join(NATIVE, "ipopt_tpu_jni.c"), "-o", out["jni"],
              f"-L{out_dir}", f"-Wl,-rpath,{out_dir}", "-lipopt_torch_c"])
    return out


if __name__ == "__main__":
    for name, path in build(*sys.argv[1:2]).items():
        print(f"{name}: {path}")
