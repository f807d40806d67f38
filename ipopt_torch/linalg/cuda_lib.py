"""Build and load the port's hand-written CUDA kernels (``ipopt_torch/csrc``).

Every ``csrc/*.cu`` has a plain C interface and becomes its own shared
library, ``_build/<hash>/lib<name>.so``, loaded with ctypes.  The hash covers
all the sources, the headers they share (``csrc/*.cuh``) and the flags, so a
change to any of them rebuilds every kernel.
``build()`` starts one nvcc per source, all at once, and waits for them; it
runs at the first launch of any kernel (or ahead of it, as ``chip_smoke.py``
does) and keeps each compiler's report (registers, shared memory) in
``<name>.log`` beside the library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
# Headers the sources include: the build hash covers them too.
HEADERS = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh"))))
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one CTA can use on Hopper (bytes), and the SMs of an H100 SXM.
SMEM_BYTES = 232448
NUM_SMS = 132
# A kernel that packs blocks into warps spreads its warps over the SMs before
# a CTA takes more than one, up to this many.
MAX_WARPS_PER_CTA = 4

_libs = {}
_lock = threading.Lock()


def warp_pack(nb: int, per_warp: int, bytes_per_block: int):
    """(grid, threads, shared bytes per CTA) of a launch that packs
    ``per_warp`` of ``nb`` blocks into each warp: one warp per CTA while the
    warps fit the SMs, then up to MAX_WARPS_PER_CTA per CTA."""
    warps = -(-nb // per_warp)
    per_cta = min(MAX_WARPS_PER_CTA, -(-warps // NUM_SMS))
    return -(-warps // per_cta), 32 * per_cta, per_cta * per_warp * bytes_per_block


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME)")


def _name(src: str) -> str:
    return os.path.splitext(os.path.basename(src))[0]


def build_dir() -> str:
    h = hashlib.sha256()
    for path in SOURCES + HEADERS:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, "kernels-" + h.hexdigest()[:16])


def build() -> dict:
    """Compile every source that has no library yet, one nvcc each, in
    parallel; returns ``{name: library path}``."""
    out_dir = build_dir()
    libs = {_name(s): os.path.join(out_dir, f"lib{_name(s)}.so") for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.exists(libs[_name(s)])]
    if not todo:
        return libs
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        name = _name(src)
        tmp = f"{libs[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, cmd, proc in procs:
        out, err = proc.communicate()
        with open(os.path.join(out_dir, f"{name}.log"), "w") as fh:
            fh.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return libs


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` with ``functions``
    (``{symbol: argtypes}``, each returning a cudaError_t as int) declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build()[name])
            for sym, argtypes in functions.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib

