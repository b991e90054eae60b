"""The port stands alone and runs on the card unless told otherwise.

  * importing every module of risc0_tpu_torch loads neither jax nor the
    JAX package (risc0_tpu and its modules);
  * chip_smoke.py imports neither;
  * every entry point, called without a device where torch sees no CUDA
    device, raises instead of running on the CPU.

Each check runs in a fresh subprocess (the test process itself has jax
loaded), with CUDA hidden from torch.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "risc0_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _run(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import risc0_tpu_torch
names = [m.name for m in pkgutil.walk_packages(risc0_tpu_torch.__path__,
                                               "risc0_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names,
                  "loaded": sorted(k for k, v in sys.modules.items() if v)}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    out = json.loads(_run(_IMPORT_ALL))
    assert "risc0_tpu_torch.circuit.rv32im.prove" in out["imported"]
    assert "risc0_tpu_torch.zkvm.exec" in out["imported"]
    assert [m for m in out["loaded"] if _forbidden(m)] == []


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "risc0_tpu_torch.circuit.rv32im.prove" in names
    assert [n for n in names if _forbidden(n)] == []


# each entry point called with its default device; `seg` and `res` are
# never reached, since the device is resolved first
_ENTRY_POINTS = {
    "prove_segment": "rv.prove_segment(None)",
    "prove_segment_core": "rv.prove_segment_core(None)",
    "fib.prove": "fib.prove(po2=6, seed=0)",
    "fib.code_root": "fib.code_root(6)",
    "fib.verify": "fib.verify(np.zeros(4, np.uint32))",
    "Prover": "Prover(POSEIDON2, fib.TAPS)",
    "commit_pipeline": "hal.commit_pipeline(np.zeros((1, 8), np.uint32))",
    "commit_pipeline_chunked":
        "hal.commit_pipeline_chunked(np.zeros((1, 8), np.uint32))",
}

_CALL_ALL = """
import json
import numpy as np
import torch
from risc0_tpu_torch.circuit import fib
from risc0_tpu_torch.circuit.rv32im import prove as rv
from risc0_tpu_torch.hal import torch_hal as hal
from risc0_tpu_torch.hash.suite import POSEIDON2
from risc0_tpu_torch.prove.prover import Prover
assert not torch.cuda.is_available()
out = {}
for name, call in json.loads(%r).items():
    try:
        eval(call)
        out[name] = "ran"
    except Exception as e:
        out[name] = type(e).__name__ + ": " + str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def default_device_calls():
    return json.loads(_run(_CALL_ALL % json.dumps(_ENTRY_POINTS)))


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(default_device_calls, name):
    got = default_device_calls[name]
    assert got.startswith("RuntimeError: device cuda: torch sees no CUDA"), \
        got
