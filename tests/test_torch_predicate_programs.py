"""The port's predicate builders regenerate the vendored programs.

  * every vendored recursion and PoVW program, and lift_rv32im_14 and
    lift_rv32im_povw_14 (their rv32im code roots committed on the CPU), is
    built by the port word for word as its file under
    ``assets.RECURSION_ZKR`` (the JAX package's generator made those files);
  * the allowed root rebuilt from the vendored ID list is the vendored
    root, and every ID's inclusion proof verifies;
  * ``generate`` writes each program (the vendored file's bytes) and the
    merged ID set where it is told, and ``compare_vendored`` finds nothing
    to report for the vendored programs and reports a changed word, a
    wrong ID and a wrong root.

A control ID is a commit of a (23, 2^18) code group, minutes on the CPU,
so the generate test takes the vendored IDs in place of the commits;
scripts/torch_gen_predicates.py --check commits them.
"""

import os

import numpy as np
import pytest
import torch

from risc0_tpu_torch.assets import RECURSION_ZKR
from risc0_tpu_torch.circuit.recursion import predicates as pr
from risc0_tpu_torch.circuit.recursion.prove import MerkleGroup, Program

torch.set_num_threads(2)

VENDORED = ("join", "union", "identity", "resolve", "join_povw",
            "join_unwrap_povw", "unwrap_povw", "resolve_povw",
            "resolve_unwrap_povw", "lift_rv32im_14", "lift_rv32im_povw_14")


@pytest.mark.parametrize("name", VENDORED)
def test_builder_regenerates_the_vendored_program(name):
    prog = pr.build(name, device="cpu")
    want = pr.load_own_program(name)
    assert prog.code_rows == want.code_rows
    assert np.array_equal(prog.code, want.code)


def test_allowed_root_rebuilt_from_the_id_list():
    from risc0_tpu_torch.hash.suite import POSEIDON2
    from risc0_tpu_torch.zkvm.receipt import verify_control_inclusion

    ids, root = pr.own_control_ids()
    group = MerkleGroup([ids[n] for n in sorted(ids)])
    assert np.array_equal(group.calc_root(), root)
    for name in sorted(ids):
        proof = group.get_proof(ids[name])
        assert verify_control_inclusion(proof, ids[name], root, POSEIDON2)


@pytest.fixture
def vendored_ids(monkeypatch):
    """Program.control_id answers with the vendored ID of the program with
    the same words (the commits are the card's work, checked elsewhere)."""
    ids, _root = pr.own_control_ids()
    by_words = {pr.load_own_program(n).code.tobytes(): ids[n]
                for n in ("identity", "unwrap_povw")}
    monkeypatch.setattr(
        Program, "control_id",
        lambda self, device="cuda", suite=None: by_words.get(
            self.code.tobytes(), np.zeros(8, np.uint32)))


def test_generate_writes_and_compares(tmp_path, vendored_ids):
    seen = []
    result = pr.generate(["identity", "unwrap_povw"], device="cpu",
                         out_dir=tmp_path,
                         log=lambda r: seen.append(r["name"]))
    assert seen == ["identity", "unwrap_povw"]
    assert pr.compare_vendored(result) == []
    ids, root = pr.own_control_ids()
    assert np.array_equal(result["root"], root)
    z = np.load(tmp_path / "own_control_ids.npz", allow_pickle=True)
    assert sorted(map(str, z["names"])) == sorted(ids)
    assert np.array_equal(z["root"], root)
    for r in result["programs"]:
        name = r["name"] + ".zkr.xz"
        # xz preset 6, as the vendored files: the same bytes
        assert (tmp_path / name).read_bytes() == \
            open(os.path.join(RECURSION_ZKR, name), "rb").read()

    rec = result["programs"][0]
    rec["program"].code[5, 3] ^= 1
    rec["control_id"] = rec["control_id"] ^ 1
    diffs = pr.compare_vendored(result)
    assert len(diffs) == 3
    assert diffs[0].startswith("identity:") and "rows differ" in diffs[0]
    assert diffs[1].startswith("identity: control ID")
    assert diffs[2].startswith("allowed root")
