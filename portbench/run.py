"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m portbench.run ...`` works too).  The
last line of standard output is the result, one JSON object; the numbers
``correct`` was decided on are the last lines of standard error.  The kernels'
build (``ipopt_torch/_build/``) and any other compile cache stay inside the
checkout, under fixed paths, so only a checkout's first run compiles.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)

if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], ROOT))
