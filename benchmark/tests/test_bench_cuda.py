"""A short run of every cell on the card, end to end through the command
the driver runs: a result line, correct. Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from harness import manifest

ROOT = manifest.ROOT
CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] >= 1
