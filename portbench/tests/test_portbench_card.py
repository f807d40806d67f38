"""The benchmark on the card: one short run of each cell, traced, as the
benchmark's command runs it.  Run with ``python3 -m pytest -m gpu portbench/tests``
on a machine with the card; skips without one."""
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["neuma1-128.mf", "lv1-1m.banded"])
def test_traced_run_is_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, os.path.join("portbench", "run.py"),
                          "--workload", cell, "--seed", str(2**31 + 3),
                          "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
