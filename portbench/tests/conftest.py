"""Fixtures of the benchmark's own tests: a copy of the benchmark at test
size, and the card, decided inside a fixture."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the configurations at test size: the same problems, small enough for the CPU
TEST_SIZES = {"neuma1-128": {"N": 6}, "lv1-1m": {"n": 1000}}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def small_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ whose configurations are cut
    to test size."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TEST_SIZES.items():
        path = tmp_path / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    return str(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
