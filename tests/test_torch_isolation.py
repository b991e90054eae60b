"""The port stands alone and runs on the card unless told otherwise.

  * importing every module of risc0_tpu_torch loads neither jax nor the
    JAX package (risc0_tpu and its modules);
  * chip_smoke.py imports neither;
  * every entry point, called without a device where torch sees no CUDA
    device, raises instead of running on the CPU; so does every example
    of risc0_tpu_torch.examples;
  * every public top-level name and class method of a JAX module (and of
    an example under examples/) has its counterpart in the port, but the
    deliberate omissions that ROADMAP.md lists.

Each import check runs in a fresh subprocess (the test process itself
has jax loaded), with CUDA hidden from torch; the name check reads the
sources only.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "risc0_tpu")
EXAMPLES = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.endswith(".py"))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _run(script: str) -> str:
    # dev mode off: the PoVW updater's default prover is then the card's
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               RISC0_DEV_MODE="")
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
    assert "risc0_tpu_torch.circuit.rv32im.accum_device" in out["imported"]
    assert "risc0_tpu_torch.circuit.rv32im.exec_device" in out["imported"]
    for name in ("circuit.layout", "circuit.rv32im.claim",
                 "circuit.recursion.circuit", "circuit.recursion.preflight",
                 "circuit.recursion.prove", "circuit.recursion.predicates",
                 "zkvm.receipt", "zkvm.recursion_driver",
                 "circuit.keccak.circuit", "circuit.keccak.witgen",
                 "circuit.keccak.prove", "circuit.keccak.verify",
                 "zkvm.guest", "zkvm.prover", "keccak_guest",
                 "hash.sha256", "hash.poseidon254", "hash.blake2b",
                 "hash.suite", "groth16", "groth16.bn254", "groth16.native",
                 "groth16.verifier", "groth16.seal_to_json", "groth16.r1cs",
                 "groth16.gadgets", "groth16.stark_verify", "groth16.prove",
                 "groth16.wrap", "groth16.solidity", "zkvm.povw",
                 "zkvm.povw_tree", "zkvm.povw_updater", "zkvm.povw_guest",
                 "zkvm.guest_env", "log", "telemetry", "cli", "zkvm.serde",
                 "zkvm.methods", "zkvm.bigint2", "zkvm.trace", "zkvm.gdb",
                 "zkvm.ipc", "zkvm.client", "zkvm.api_server", "zkvm.bonsai",
                 "parallel.scheduler", "parallel.config", "parallel.assets",
                 "parallel.remote", "parallel.sharded",
                 "circuit.recursion.asm", "circuit.recursion.zkr_verify",
                 "examples.common"):
        assert "risc0_tpu_torch." + name in out["imported"]
    for name in EXAMPLES:
        assert "risc0_tpu_torch.examples." + name in out["imported"]
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
    "fib.prove (sha256)": "fib.prove(po2=6, seed=0, suite=SHA256)",
    "prove_program (poseidon254)":
        "rec.prove_program(None, [], suite=POSEIDON254)",
    "Program.control_id (poseidon254)":
        "rec.load_keccak_lift(14).control_id(suite=POSEIDON254)",
    "Prover": "Prover(POSEIDON2, fib.TAPS)",
    "commit_pipeline": "hal.commit_pipeline(np.zeros((1, 8), np.uint32))",
    "commit_pipeline_chunked":
        "hal.commit_pipeline_chunked(np.zeros((1, 8), np.uint32))",
    "witgen_accum_device": "accum_device.witgen_accum_device(None, None)",
    "witgen_exec_device": "exec_device.witgen_exec_device(None)",
    "prove_program": "rec.prove_program(None, [])",
    "Program.control_id": "rec.load_keccak_lift(14).control_id()",
    "lift": "drv.lift(SegmentReceipt(np.zeros(100, np.uint32), 0, "
            "'poseidon2', None))",
    "compress_composite": "drv.compress_composite(CompositeReceipt("
                          "[SegmentReceipt(np.zeros(100, np.uint32), 0, "
                          "'poseidon2', None)]))",
    "segment_preflight": "rv.segment_preflight(None, exec='device')",
    "prove_keccak": "keccak.prove_keccak([[0] * 25], 14)",
    "lift_keccak": "drv.lift_keccak(np.zeros(4, np.uint32), 14)",
    "prove_keccak_request": "drv.prove_keccak_request("
                            "{'po2': 14, 'input': [[0] * 25]})",
    "union": "drv.union(None, None)",
    "resolve": "drv.resolve(None, None)",
    "keccak_union_root": "drv.keccak_union_root([{'input': [[0] * 25]}])",
    "identity_p254": "drv.identity_p254(None)",
    "ProverImpl": "ProverImpl()",
    "default_prover": "default_prover()",
    "lift_povw": "drv.lift_povw(SegmentReceipt(np.zeros(100, np.uint32), 0, "
                 "'poseidon2', None))",
    "join_povw": "drv.join_povw(None, None)",
    "unwrap_povw": "drv.unwrap_povw(None)",
    "resolve_povw": "drv.resolve_povw(None, None)",
    "compress_composite_povw": "drv.compress_composite_povw("
                               "CompositeReceipt([SegmentReceipt(np.zeros("
                               "100, np.uint32), 0, 'poseidon2', None)]))",
    "ProverImpl (PoVW)": "ProverImpl(ProverOpts(receipt_kind='succinct'))"
                         ".prove(loop_guest.session_env(16, 1, "
                         "PovwJobId(1, 2)), loop_guest.elf())",
    "WorkLogUpdateProver": "WorkLogUpdateProver(log_id=0).prove_update([])",
    "launch_cluster": "launch_cluster(load_config('version = 1\\n'), "
                      "prover=ProverImpl())",
    "make_local_pools": "make_local_pools(Factory())",
    "ApiServer": "ApiServer()",
    "LocalProver": "client.LocalProver()",
    "api_server.serve": "api_server.serve(port=0)",
    "cli prove": "cli.main(['prove', '--elf', 'guests/loop.bin', "
                 "'--input-hex', '0a000000', '--po2', '16'])",
    "predicates.lift_rv32im": "predicates.lift_rv32im(14)",
    "predicates.generate": "predicates.generate(['join'])",
    "commit_sharded": "commit_sharded(np.zeros((2, 8), np.uint32))",
    "mesh_context": "mesh_commit()",
}
_ENTRY_POINTS.update({f"examples.{name}": f"example({name!r})"
                      for name in EXAMPLES})

_CALL_ALL = """
import importlib
import json
import numpy as np
import torch
from risc0_tpu_torch.circuit import fib
from risc0_tpu_torch.circuit.rv32im import accum_device, exec_device
from risc0_tpu_torch.circuit.keccak import prove as keccak
from risc0_tpu_torch.circuit.recursion import prove as rec
from risc0_tpu_torch.circuit.rv32im import prove as rv
from risc0_tpu_torch.hal import torch_hal as hal
from risc0_tpu_torch.hash.suite import POSEIDON2, POSEIDON254, SHA256
from risc0_tpu_torch.prove.prover import Prover
from risc0_tpu_torch.zkvm import recursion_driver as drv
from risc0_tpu_torch import loop_guest
from risc0_tpu_torch.zkvm.povw import PovwJobId
from risc0_tpu_torch.zkvm.povw_updater import WorkLogUpdateProver
from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts, default_prover
from risc0_tpu_torch.zkvm.receipt import CompositeReceipt, SegmentReceipt
from risc0_tpu_torch import cli
from risc0_tpu_torch.parallel.config import launch_cluster, load_config
from risc0_tpu_torch.parallel.scheduler import Factory, make_local_pools
from risc0_tpu_torch.zkvm import api_server, client
from risc0_tpu_torch.zkvm.ipc import ApiServer
from risc0_tpu_torch.circuit.recursion import predicates
from risc0_tpu_torch.parallel.sharded import commit_sharded, mesh_context


def mesh_commit():
    with mesh_context(["cuda"]):
        hal.commit_pipeline(np.zeros((2, 8), np.uint32), device="cpu")


def example(name):
    importlib.import_module("risc0_tpu_torch.examples." + name).main([])


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


# -- every public name of the JAX package has its counterpart ----------------

# The deliberate omissions that ROADMAP.md lists ("not ported" and the
# differences in form), by module of risc0_tpu/ ("*": no counterpart
# module).  The test fails on a name missing from the port that is not
# listed here, and on a listed name that the port has after all.
DELIBERATE = {
    "hal/jnp_hal.py": "*",
    "hal/pallas/__init__.py": "*",
    "hal/pallas/ntt.py": "*",
    "hal/pallas/poseidon2.py": "*",
    "hal/trace_cache.py": "*",
    "circuit/ir_exec.py": {"Plan", "build_plan", "build_tap_matrix_np",
                           "execute_plan_jnp", "execute_plan_np",
                           "make_plan_runner"},
    "circuit/rv32im/accum_device.py": {"INVALID", "eval_graph_np",
                                       "witgen_accum_np"},
    "circuit/rv32im/exec_device.py": {"NUM_GLOBAL", "P", "eval_exec_np",
                                      "witgen_exec_np"},
    "circuit/rv32im/circuit.py": {"Rv32imCircuit.eval_check",
                                  "Rv32imCircuit.eval_check_np"},
    "circuit/rv32im/prove.py": {"Rv32imCircuitHal"},
    "circuit/keccak/witgen.py": {"GLOBAL_META", "SCATTER_COLS"},
    "circuit/layout.py": {"rv32im_inject_layout"},
    "circuit/recursion/circuit.py": {"ALLOWED_CONTROL_ROOT"},
    "core/poly.py": {"poly_divide", "poly_interpolate"},
    "field.py": {"ext_add", "ext_sub", "ext_scale", "ext_pow_static",
                 "from_subfield", "from_subfield_np"},
    "hash/suite.py": {"HashSuite.new_rng", "HashSuite.hash_pair",
                      "HashSuite.hash_elem_slice"},
    "parallel/scheduler.py": {"Task.affinity", "TaskDone.host"},
    "perf.py": {"ENABLED", "summary", "toplevel_seconds"},
    "prove/merkle.py": {"MerkleTreeProver.prove"},
    "prove/soundness.py": {"ETA", "conjectured_strict"},
}


def _public_names(path):
    """(defined, bound): the public top-level names that `path` defines
    (functions, classes, assignments) and binds by import, and each
    class's public methods and class-level fields as Class.name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    defined, bound = set(), set()
    for node in tree.body:
        targets = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(node.name)
        elif isinstance(node, ast.ClassDef):
            defined.add(node.name)
            for item in node.body:
                names = []
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names = [item.name]
                elif isinstance(item, ast.Assign):
                    names = [t.id for t in item.targets
                             if isinstance(t, ast.Name)]
                elif isinstance(item, ast.AnnAssign) and \
                        isinstance(item.target, ast.Name):
                    names = [item.target.id]
                defined.update(f"{node.name}.{n}" for n in names
                               if not n.startswith("_")
                               or (n.startswith("__") and n.endswith("__")))
        elif isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        for t in targets:
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(e, ast.Name):
                    defined.add(e.id)
    public = {n for n in defined
              if not n.split(".")[0].startswith("_")}
    return public, bound


def _missing(ref_root, port_root):
    """{module: names} of ref_root's modules that port_root lacks."""
    out = {}
    for dirpath, _dirs, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                out[rel] = "*"
                continue
            want, _ = _public_names(os.path.join(ref_root, rel))
            have, bound = _public_names(port)
            # a missing class counts once, not with each of its methods
            gone = {n for n in want - have if n not in bound
                    and n.split(".")[0] in have | bound | {n}}
            if gone:
                out[rel] = gone
    return out


def test_port_has_every_public_name_of_the_jax_package():
    got = _missing(os.path.join(REPO, "risc0_tpu"),
                   os.path.join(REPO, "risc0_tpu_torch"))
    assert got == DELIBERATE


def test_every_deliberate_omission_is_in_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for module, names in DELIBERATE.items():
        for name in ([module] if names == "*" else sorted(names)):
            assert f"`{name}`" in roadmap, (module, name)


def test_port_examples_have_every_public_name_of_the_jax_examples():
    got = _missing(os.path.join(REPO, "examples"),
                   os.path.join(REPO, "risc0_tpu_torch", "examples"))
    assert got == {}
