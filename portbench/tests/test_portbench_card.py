"""One traced run of the K1 cell on the card (skips without one).

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "osc1024.free_energies",
         "--seed", str(2**31 + 900), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["k1_roofline_pct"]["value"] <= 100
