"""What the benchmark loads for each cell holds no JAX and nothing of the
JAX package (compared by whole top-level name: risc0_tpu_torch is the
port), and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOAD = """
import json, sys
sys.path.insert(0, {root!r})
from zkbench import harness, manifest, devtrace, readings
cell = manifest.Cell({root!r}, {cell!r})
drv = cell.traffic_module()
guest = cell.guest_module()
for m in cell.per_layer():
    cell.metric_reader(m["name"])
# what the traffic kinds import when they run
import risc0_tpu_torch.perf
import risc0_tpu_torch.circuit.rv32im.prove
import risc0_tpu_torch.zkvm.exec
import risc0_tpu_torch.zkvm.prover
import risc0_tpu_torch.zkvm.receipt
import risc0_tpu_torch.zkvm.recursion_driver
import zkbench.reference.stark, zkbench.reference.claims
import zkbench.reference.secp256k1
print(json.dumps(harness.forbidden_modules()))
"""


@pytest.mark.parametrize("cell", ["loop20.segment", "ecdsa.succinct"])
def test_no_jax_loaded(cell):
    r = subprocess.run([sys.executable, "-c",
                        LOAD.format(root=ROOT, cell=cell)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    from zkbench import harness

    for name in [m for m in sys.modules if m.split(".")[0] in
                 harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "risc0_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "risc0_tpux", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "zkbench", "reference", "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"risc0_tpu_torch", "risc0_tpu", "jax", "jaxlib",
                       "torch"}


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import zkbench.reference.stark, zkbench.reference.claims, "
            "zkbench.reference.secp256k1, zkbench.reference.circuits; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'risc0_tpu_torch', 'risc0_tpu', 'jax', 'torch'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
