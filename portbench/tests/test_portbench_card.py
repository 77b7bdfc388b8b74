"""A short run of a real cell on the card (skips without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fem_nm_n32", "bem_cbie_n20480"])
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                           "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and 0 < result["device"]["busy_s"]
    assert list(result)[-1] == "checks"
