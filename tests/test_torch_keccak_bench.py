"""The keccak composition deployment of the benchmark on the CPU: the plain
reference (zkbench/reference/keccak.py) against the port, the guest that
reads its work from stdin (keccak_guest.build_stdin), and the spans and
counters of the composition.

  * the reference's keccak-f, batch claim and root claim are the port's
    keccak_f, compute_keccak_digest and receipt.keccak_root_claim, on
    seeded states; its batch claim of the golden keccak seal's inputs is
    the digest in tests/data/keccak_seal_po2_14.npy's globals;
  * build_stdin gives zkbench/guests/keccak_stdin.elf byte for byte, and
    the port's executor runs that ELF at small batch sizes to the
    reference's journal, pending keccak claims and output digest;
  * ProverImpl(succinct).prove of that guest, every STARK prove replaced
    by a stand-in, records prove_keccak, verify_keccak, lift_keccak,
    union and resolve under its one `prove` root beside the spans it
    recorded before, and counts the batches and permutations.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from risc0_tpu_torch import keccak_guest, telemetry
from risc0_tpu_torch.circuit.keccak import compute_keccak_digest
from risc0_tpu_torch.circuit.keccak.preflight import keccak_f
from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids
from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
from zkbench.guests import keccak as guest
from zkbench.reference import keccak as ref

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
with open(os.path.join(REPO, "zkbench", "configs",
                       "keccak_po2_17x2.json")) as _f:
    CONFIG = json.load(_f)
SMALL = (3, 2)


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
            for _ in range(n)]


def _inputs(sizes=SMALL, seed=5):
    return guest.inputs(CONFIG, np.random.default_rng(seed), sizes)


# -- the reference against the port ------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keccak_f_is_the_ports(seed):
    for state in _states(4, seed) + [[0] * 25, [(1 << 64) - 1] * 25]:
        assert ref.keccak_f(state) == keccak_f(state)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_batch_claim_is_the_ports(n):
    states = _states(n, 10 + n)
    assert ref.batch_claim(states) == compute_keccak_digest(states).tobytes()


def test_chain_permutes_in_place():
    start = _states(1, 3)[0]
    batches, final = ref.chain(start, [2, 3])
    flat = [s for b in batches for s in b]
    assert [len(b) for b in batches] == [2, 3] and flat[0] == start
    for a, b in zip(flat, flat[1:] + [final]):
        assert keccak_f(a) == b


@pytest.mark.parametrize("n", [1, 2, 3])
def test_root_claim_is_the_ports(n):
    from risc0_tpu_torch.zkvm.receipt import keccak_root_claim

    batches = [_states(i + 1, 20 + i) for i in range(n)]
    root = np.asarray(own_control_ids()[1], np.uint32).tobytes()
    got = ref.root_claim([ref.batch_claim(b) for b in batches], root)
    assert got == keccak_root_claim([{"input": b} for b in batches]).tobytes()


def test_batch_claim_of_the_golden_keccak_seal():
    """tests/data/keccak_seal_po2_14.npy proves the states of
    scripts/gen_keccak_seal.py's inputs(): its globals carry the claim."""
    from risc0_tpu_torch.circuit.keccak.verify import \
        keccak_digest_from_globals

    seal = np.load(os.path.join(DATA, "keccak_seal_po2_14.npy"))
    digest = keccak_digest_from_globals(seal[:17], montgomery=True)
    assert ref.batch_claim(_states(2, 14)) == digest.tobytes()


def test_output_digest_is_the_ports():
    from risc0_tpu_torch.zkvm.claims import (Assumption, Assumptions,
                                             MaybePruned, Output)

    journal, claim = bytes(range(200)), bytes(range(32, 64))
    zero = np.zeros(8, np.uint32)
    want = Output.of(journal, Assumptions([MaybePruned.of(Assumption(
        np.frombuffer(claim, np.uint32), zero))])).digest()
    got = ref.output_with(journal, [ref.assumption(claim, bytes(32))])
    assert got == want.tobytes()


# -- the guest ----------------------------------------------------------------

def test_stdin_guest_is_the_benchmark_elf():
    elf = keccak_guest.build_stdin()
    with open(os.path.join(REPO, CONFIG["elf"]), "rb") as f:
        assert elf == f.read()
    assert hashlib.sha256(elf).hexdigest() == CONFIG["elf_sha256"]


def _session(inp):
    env = ExecutorEnv(segment_po2=16, keccak_max_po2=14).write_slice(
        inp["stdin"])
    impl = ExecutorImpl(env, keccak_guest.build_stdin())
    return impl.run(), impl.compute_image_id()


@pytest.mark.parametrize("sizes", [SMALL, (1, 4)])
def test_stdin_guest_runs_to_the_references_claims(sizes):
    from risc0_tpu_torch.zkvm.receipt import (keccak_root_claim,
                                              session_segment_output)

    inp = _inputs(sizes)
    assert len(inp["stdin"]) == keccak_guest.stdin_size()
    session, _image_id = _session(inp)
    assert session.exit_code == ("Halted", 0)
    assert bytes(session.journal) == inp["journal"]
    assert [len(r["input"]) for r in session.pending_keccaks] == list(sizes)
    assert [r["input"] for r in session.pending_keccaks] == inp["batches"]
    assert [bytes(r["claim_digest"]) for r in session.pending_keccaks] == \
        inp["claims"]
    assert keccak_root_claim(session.pending_keccaks).tobytes() == \
        inp["root_claim"]
    assert session_segment_output(session).digest().tobytes() == \
        inp["output"]


# -- spans and counters ---------------------------------------------------------

@pytest.fixture
def stand_ins(monkeypatch):
    """Every STARK prove and check of the composition replaced by the
    stand-ins of tests/test_torch_composition.py: the rv32im seals carry
    their segment's index, the keccak seals the globals of their batch
    claim, and the recursion seals the output words of their claim."""
    from risc0_tpu_torch.circuit.keccak import prove as kprove
    from risc0_tpu_torch.circuit.keccak import verify as kverify
    from risc0_tpu_torch.circuit.recursion import circuit as rec_circuit
    from risc0_tpu_torch.zkvm import recursion_driver as drv
    from risc0_tpu_torch.zkvm.receipt import SuccinctReceipt
    from test_torch_composition import (_fake_keccak_seal, _stub_seal,
                                        _stub_seal_layer)

    inp = _inputs()
    session, image_id = _session(inp)
    _stub_seal_layer(monkeypatch, session)

    def prove_zkr(program, control_id, allowed, tape, claim=None, **kw):
        return SuccinctReceipt(
            seal=_stub_seal(claim.digest(), 0),
            control_id=np.asarray(control_id, np.uint32), claim=claim,
            control_root=own_control_ids()[1],
            control_inclusion_proof={"index": 0, "digests": []})

    monkeypatch.setattr(kprove, "prove_keccak",
                        lambda inputs, po2, **kw: _fake_keccak_seal(inputs,
                                                                    po2))
    monkeypatch.setattr(kverify, "verify_keccak_seal",
                        lambda s: np.asarray(s[:17]))
    monkeypatch.setattr(drv, "prove_zkr", prove_zkr)
    monkeypatch.setattr(drv, "load_keccak_lift", lambda po2: None)
    monkeypatch.setattr(drv, "load_own_program", lambda name: None)
    monkeypatch.setattr(rec_circuit, "verify_recursion_seal",
                        lambda seal, check_code, suite=None: None)
    return inp, image_id


def _counters():
    return telemetry.metrics().snapshot()["counters"]


def test_composition_spans_nest_under_one_prove(stand_ins):
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    inp, image_id = stand_ins
    env = ExecutorEnv(segment_po2=16, keccak_max_po2=14).write_slice(
        inp["stdin"])
    before = _counters()
    t0 = telemetry.tracer().finished()[-1].end_ns \
        if telemetry.tracer().finished() else 0
    info = ProverImpl(ProverOpts(receipt_kind="succinct"),
                      device="cpu").prove(env, keccak_guest.build_stdin())
    info.receipt.verify(image_id)
    spans = [s for s in telemetry.tracer().finished() if s.start_ns > t0]
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "prove"
    assert {s.trace_id for s in spans} == {root.trace_id}

    def kids(parent):
        return [s for s in sorted(spans, key=lambda s: s.start_ns)
                if s.parent_id == parent.span_id and s.path is None]

    top = kids(root)
    assert [s.name for s in top] == [
        "execute", "prove_segment", "prove_keccak", "lift_keccak",
        "prove_keccak", "lift_keccak", "union", "lift", "resolve",
        "self_check"]
    by = {}
    for s in top:
        by.setdefault(s.name, []).append(s)
    assert by["execute"][0].attributes == {"segments": 1}
    assert by["prove_segment"][0].attributes == {"po2": 14}
    assert by["lift"][0].attributes == {"po2": 14,
                                        "program": "lift_rv32im_14"}
    assert [s.attributes for s in by["prove_keccak"]] == [
        {"po2": 14, "permutations": n} for n in SMALL]
    for s in by["lift_keccak"]:
        assert s.attributes == {"program": "keccak_lift_14"}
        assert [k.name for k in kids(s)] == ["verify_keccak"]
    for s in top:
        if s.name not in ("lift_keccak", "self_check"):
            assert kids(s) == [], s.name
    after = _counters()
    for name, n in (("risc0_keccak_batches", len(SMALL)),
                    ("risc0_keccak_permutations", sum(SMALL))):
        assert after[name] - before.get(name, 0) == n
