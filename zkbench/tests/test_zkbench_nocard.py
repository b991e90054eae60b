"""Without a card the run refuses: a non-zero exit and no result line."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("cell", ["loop20.segment", "ecdsa.succinct"])
def test_no_card_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "zkbench/run.py", "--workload", cell,
                        "--seed", str(2**31 + 7), "--seconds", "24",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no CUDA card" in r.stderr
