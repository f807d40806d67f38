"""The frozen yardstick: the kernels' least work and the import rule."""
import ast
import os

import pytest

from portbench import roofline
from portbench.harness import forbidden_modules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape, dtype, ms, bound_by", [
    # chip_smoke.k1_bound's corrected figures (PERF.md, PR 11 review round)
    ((1, 1726, 1726), "torch.float64", 0.025604, "ops"),
    ((512, 7, 7), "torch.float64", 0.000103, "bytes"),
    ((1, 3070, 3070), "torch.float64", 0.144023, "ops"),
])
def test_k1_least_time_matches_chip_smoke(shape, dtype, ms, bound_by):
    nbytes, ops = roofline.k1_work(shape[0], shape[-1], dtype)
    # the closed form equals the step-by-step count
    assert ops == shape[0] * sum(s * (s + 1) + s for s in range(shape[-1]))
    t = roofline.k1_least_s(shape, dtype) * 1e3
    assert t == pytest.approx(ms, abs=5e-7)
    by_ops = ops / roofline.PEAK_OPS_PER_S["float64"] > nbytes / roofline.PEAK_BYTES_PER_S
    assert by_ops == (bound_by == "ops")


@pytest.mark.parametrize("shape, ms", [
    ((6250, 16, 16), 0.007881),     # chip_smoke.k2_bound: bytes (26.4 MB)
    ((64, 156, 156), 0.007463),
    ((38, 408, 408), 0.077041),     # operations
])
def test_k2_least_time_matches_chip_smoke(shape, ms):
    assert roofline.k2_least_s(shape, "torch.float64") * 1e3 == pytest.approx(ms, abs=5e-7)


@pytest.mark.parametrize("names, found", [
    (["jax.numpy"], ["jax"]),
    (["ipopt_tpu.x"], ["ipopt_tpu"]),
    (["jaxlib", "flax.linen", "torch"], ["flax", "jaxlib"]),
    (["ipopt_torch", "ipopt_torch.sparse", "jaxtyping", "ipopt_tpux"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("rel", ["judge.py", "roofline.py", "reference/neuma1.py",
                                 "reference/lv1.py"])
def test_the_yardstick_imports_nothing_of_the_program(rel):
    found = _imports(os.path.join(HERE, rel))
    assert not found & {"torch", "ipopt_torch", "ipopt_tpu", "jax", "jaxlib", "flax"}, found


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                found = _imports(os.path.join(dirpath, f))
                assert not found & {"ipopt_tpu", "jax", "jaxlib", "flax"}, (f, found)
