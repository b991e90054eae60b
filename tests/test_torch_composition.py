"""Receipt composition in the port on the CPU against the JAX package:
the keccak lift, union, resolve, the keccak union root and the resolve
fold of compress_composite, the session claims of a keccak guest, and
ProverImpl.

A recursion seal depends on the rng of the recursion witgen, and the JAX
package's union, resolve and lift_keccak pass none, so seals cannot be
compared.  What decides them can: the program, control ID, allowed leaves,
input tape and claim that each function hands to prove_zkr.  Here
prove_zkr is replaced by a recorder in both packages (its seal is then a
stub that carries the control root and claim digest where a recursion
seal's output does), both are fed the golden receipts and the keccak seal
fixture, and the records must be equal word for word.  prove_zkr itself
is held to the JAX package byte for byte in tests/test_torch_recursion.py.

The keccak root claim is the one place where the port departs from the
JAX package on purpose: for two or more keccak batches the JAX package
merges the bare claim digests, which its own union program does not prove
(that program merges Assumption digests under the allowed-control-IDs
root).  The port merges as the union program proves, so the union root
resolves the guest's assumption; the two agree for one batch.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEGMENT_SEAL = os.path.join(DATA, "rv32im_seal_po2_14.npy")
KECCAK_SEAL = os.path.join(DATA, "keccak_seal_po2_14.npy")
PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
_ROOT = own_control_ids()[1]
_JAX_PROOFS = {}  # control ID -> the JAX package's inclusion proof


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _kw(pkg):
    """The port's entry points run on the CPU only when asked."""
    return {"device": "cpu"} if pkg == "torch" else {}


def _golden(pkg, name):
    """A golden succinct receipt of tests/data in `pkg`'s classes, its
    claim as in tests/test_golden.py."""
    C = _mod(pkg, "zkvm.claims")
    R = _mod(pkg, "zkvm.receipt")
    meta = np.load(os.path.join(DATA, name + ".meta.npz"))
    if name == "recursion_seal_lift14":
        claim = _mod(pkg, "circuit.rv32im.claim").decode_claim(
            np.load(SEGMENT_SEAL))
    else:
        with open(os.path.join(DATA, name + ".claim_digest")) as f:
            claim = C.MaybePruned.from_digest(
                np.frombuffer(bytes.fromhex(f.read().strip()), np.uint32))
    return R.SuccinctReceipt(
        seal=np.load(os.path.join(DATA, name + ".npy")),
        control_id=meta["control_id"], claim=claim,
        control_root=meta["control_root"],
        control_inclusion_proof={"index": int(meta["incl_index"]),
                                 "digests": meta["incl_digests"]})


def _stub_seal(claim_digest, tag):
    """A seal whose output words decode to the allowed root and the claim
    digest, as a recursion seal's do, then a tag word."""
    out = np.zeros(32, np.uint32)
    out[0:16:2] = _ROOT
    d = np.asarray(claim_digest, np.uint32)
    out[16::2], out[17::2] = d & 0xFFFF, d >> 16
    return np.concatenate([F.encode_np(out), np.array([tag], np.uint32)])


def _fake_keccak_seal(inputs, po2):
    """Montgomery globals whose final digest is the batch claim, and po2:
    the header of a keccak seal, which is what its verifier returns."""
    from risc0_tpu_torch.circuit.keccak import compute_keccak_digest
    from risc0_tpu_torch.circuit.keccak.witgen import global_meta

    d = compute_keccak_digest(inputs)
    glob = np.zeros(17, np.uint32)
    cols = global_meta()["final_digest"]
    glob[cols[0::2]], glob[cols[1::2]] = d & 0xFFFF, d >> 16
    return np.concatenate([F.encode_np(glob), np.array([po2], np.uint32)])


@pytest.fixture
def record(monkeypatch):
    """prove_zkr replaced in both packages by a recorder; returns
    {package: [record of each call]}."""
    logs = {pkg: [] for pkg in PKGS}

    def recorder(pkg):
        log, R = logs[pkg], _mod(pkg, "zkvm.receipt")

        def prove_zkr(program, control_id, allowed, tape, claim=None, **kw):
            log.append({
                "po2": program.po2, "code": program.code.tolist(),
                "control_id": [int(w) for w in control_id],
                "allowed": [[int(w) for w in leaf] for leaf in allowed],
                "tape": [int(w) for w in tape],
                "claim": [int(w) for w in claim.digest()]})
            return R.SuccinctReceipt(
                seal=_stub_seal(claim.digest(), len(log)),
                control_id=np.asarray(control_id, np.uint32), claim=claim,
                control_root=_ROOT, control_inclusion_proof={
                    "index": 0, "digests": []})
        return prove_zkr

    for pkg in PKGS:
        drv = _mod(pkg, "zkvm.recursion_driver")
        monkeypatch.setattr(drv, "prove_zkr", recorder(pkg))
    # the JAX lift_keccak imports prove_zkr where it runs
    jprove = _mod("jax", "circuit.recursion.prove")
    monkeypatch.setattr(jprove, "prove_zkr",
                        _mod("jax", "zkvm.recursion_driver").prove_zkr)
    # every set here is the allowed-control-IDs set: the JAX package's
    # inclusion proofs (1.3 s each on the host) are computed once an ID
    get_proof = jprove.MerkleGroup.get_proof

    def cached_proof(group, control_id):
        key = bytes(np.asarray(control_id, np.uint32))
        if key not in _JAX_PROOFS:
            _JAX_PROOFS[key] = get_proof(group, control_id)
        return _JAX_PROOFS[key]

    monkeypatch.setattr(jprove.MerkleGroup, "get_proof", cached_proof)
    return logs


def _claims_of(log):
    return [np.array(r["claim"], np.uint32) for r in log]


# -- the repairs --------------------------------------------------------------

@pytest.mark.parametrize("output", ["bare digest", "bare Output"])
def test_composite_claim_of_a_bare_output_matches_jax(output):
    """CompositeReceipt.claim() returns (the JAX package's guard) on a last
    claim whose output is a bare digest or a bare Output."""
    got = {}
    for pkg in PKGS:
        C, R = _mod(pkg, "zkvm.claims"), _mod(pkg, "zkvm.receipt")
        out = (np.arange(8, dtype=np.uint32) if output == "bare digest"
               else C.Output.of(b"journal", C.Assumptions([])))
        claim = C.ReceiptClaim(
            pre=C.MaybePruned.from_digest(np.arange(8, dtype=np.uint32) + 1),
            post=C.MaybePruned.from_digest(np.zeros(8, np.uint32)),
            exit_code=C.ExitCode("Halted", 0),
            input=C.MaybePruned.from_digest(np.zeros(8, np.uint32)),
            output=out)
        seg = R.SegmentReceipt(np.zeros(4, np.uint32), 0, "poseidon2", claim)
        got[pkg] = R.CompositeReceipt(segments=[seg]).claim().digest()
    assert np.array_equal(got["torch"], got["jax"])


# -- what each function hands to prove_zkr ------------------------------------

def test_lift_keccak_tape_matches_jax(record, monkeypatch):
    """The port verifies the fixture seal on the host for real; the JAX
    side reads the globals from the seal's header (what its verifier
    returns), so the two claims agree only if the port's verifier
    accepts the seal and returns its header."""
    seal = np.load(KECCAK_SEAL)
    monkeypatch.setattr(_mod("jax", "circuit.keccak.verify"),
                        "verify_keccak_seal", lambda s: np.asarray(s[:17]))
    for pkg in PKGS:
        _mod(pkg, "zkvm.recursion_driver").lift_keccak(seal, 14, **_kw(pkg))
    assert record["torch"] == record["jax"]
    with open(os.path.join(DATA, "keccak_lift14_seal.claim_digest")) as f:
        want = bytes.fromhex(f.read().strip())
    assert _claims_of(record["torch"])[0].tobytes() == want
    assert record["torch"][0]["tape"][-1] == 1 << 14


@pytest.mark.parametrize("order", ["lift, keccak", "keccak, lift"])
def test_union_tape_matches_jax(record, order):
    from risc0_tpu_torch.zkvm.claims import Assumption
    from risc0_tpu_torch.zkvm.receipt import union_claim

    names = ["recursion_seal_lift14", "keccak_lift14_seal"]
    if order == "keccak, lift":
        names.reverse()
    for pkg in PKGS:
        a, b = (_golden(pkg, n) for n in names)
        _mod(pkg, "zkvm.recursion_driver").union(a, b, **_kw(pkg))
    assert record["torch"] == record["jax"]
    a, b = (_golden("torch", n) for n in names)
    da, db = (Assumption(r.claim.digest(), _ROOT).digest() for r in (a, b))
    assert np.array_equal(_claims_of(record["torch"])[0],
                          union_claim(da, db).digest())


def _conditional(pkg):
    """The golden lift receipt with a claim that assumes the golden keccak
    receipt's claim (head) and one more claim."""
    C = _mod(pkg, "zkvm.claims")
    receipt = _golden(pkg, "recursion_seal_lift14")
    keccak = _golden(pkg, "keccak_lift14_seal").claim.digest()
    zero = np.zeros(8, np.uint32)
    out = C.Output.of(b"composed", C.Assumptions([
        C.MaybePruned.of(C.Assumption(keccak, zero)),
        C.MaybePruned.of(C.Assumption(np.arange(8, dtype=np.uint32), zero))]))
    receipt.claim = C.ReceiptClaim(
        pre=receipt.claim.pre, post=receipt.claim.post,
        exit_code=C.ExitCode("Halted", 0), input=receipt.claim.input,
        output=C.MaybePruned.of(out))
    return receipt


def test_resolve_tape_matches_jax(record):
    for pkg in PKGS:
        _mod(pkg, "zkvm.recursion_driver").resolve(
            _conditional(pkg), _golden(pkg, "keccak_lift14_seal"),
            **_kw(pkg))
    assert record["torch"] == record["jax"]


def test_resolve_without_assumptions_raises():
    from risc0_tpu_torch.zkvm.receipt import VerificationError
    from risc0_tpu_torch.zkvm.recursion_driver import resolve

    receipt = _golden("torch", "recursion_seal_lift14")
    with pytest.raises(VerificationError, match="no assumptions"):
        resolve(receipt, receipt, device="cpu")


@pytest.mark.parametrize("wrapped", [False, True])
def test_compress_composite_tape_matches_jax(record, wrapped):
    """One segment whose claim assumes the golden keccak claim, and that
    receipt (bare, or as the succinct inner of a Receipt) to resolve it:
    a lift, then a resolve."""
    for pkg in PKGS:
        C, R = _mod(pkg, "zkvm.claims"), _mod(pkg, "zkvm.receipt")
        seal = np.load(SEGMENT_SEAL)
        claim = _conditional(pkg).claim
        keccak = _golden(pkg, "keccak_lift14_seal")
        if wrapped:
            keccak = R.Receipt(R.InnerReceipt("succinct", keccak), b"")
        composite = R.CompositeReceipt(
            segments=[R.SegmentReceipt(seal, 0, "poseidon2", claim)],
            assumption_receipts=[keccak])
        _mod(pkg, "zkvm.recursion_driver").compress_composite(composite,
                                                              **_kw(pkg))
    assert record["torch"] == record["jax"]
    assert [r["po2"] for r in record["torch"]] == [18, 18]
    lift_id, resolve_id = (r["control_id"] for r in record["torch"])
    ids = own_control_ids()[0]
    assert (lift_id, resolve_id) == (
        [int(w) for w in ids["lift_rv32im_14"]],
        [int(w) for w in ids["resolve"]])


def test_composite_assumption_of_another_kind_raises():
    from risc0_tpu_torch.zkvm.receipt import InnerReceipt, Receipt
    from risc0_tpu_torch.zkvm.recursion_driver import (VerificationError,
                                                       _as_succinct)

    with pytest.raises(VerificationError, match="composite"):
        _as_succinct(Receipt(InnerReceipt("composite", None), b""))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_mmr_merges_like_jax(n):
    """MerkleMountainAccumulator with a recording merge: the same merges in
    the same order."""
    merges = {}
    for pkg in PKGS:
        log = merges[pkg] = []

        def merge(a, b, log=log):
            log.append((a, b))
            return f"({a} {b})"
        mmr = _mod(pkg, "zkvm.recursion_driver").MerkleMountainAccumulator(
            merge=merge)
        for i in range(n):
            mmr.insert(str(i))
        log.append(mmr.root())
    assert merges["torch"] == merges["jax"]


def _requests(n):
    """n keccak requests at po2 14, of 1, 2, ... permutations."""
    from risc0_tpu_torch import keccak_guest
    from risc0_tpu_torch.circuit.keccak import compute_keccak_digest

    batches = keccak_guest.batch_inputs(range(1, n + 1))
    return [{"input": b, "po2": 14, "claim_digest": compute_keccak_digest(b)}
            for b in batches]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_keccak_union_root_matches_jax(record, monkeypatch, n):
    """1, 2 and 3 keccak requests: each proved by a stub, lifted and
    union-merged (recorded) in the same order as the JAX package; the
    root's claim is the port's keccak_root_claim.  The JAX package's
    keccak_root_claim is that root's claim for one request only."""
    from risc0_tpu_torch.zkvm.receipt import keccak_root_claim

    reqs = _requests(n)
    roots = {}
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "circuit.keccak.prove"), "prove_keccak",
                            lambda inputs, po2, **kw: _fake_keccak_seal(
                                inputs, po2))
        monkeypatch.setattr(_mod(pkg, "circuit.keccak.verify"),
                            "verify_keccak_seal", lambda s: np.asarray(s[:17]))
        if pkg == "jax":  # prove_keccak_request imports it where it runs
            monkeypatch.setattr(_mod(pkg, "circuit.keccak"), "prove_keccak",
                                _mod(pkg, "circuit.keccak.prove").prove_keccak)
        root = _mod(pkg, "zkvm.recursion_driver").keccak_union_root(
            reqs, **_kw(pkg))
        roots[pkg] = root.claim.digest()
    assert record["torch"] == record["jax"]
    names = [r["control_id"] for r in record["torch"]]
    ids = own_control_ids()[0]
    assert names.count([int(w) for w in ids["keccak_lift_14"]]) == n
    assert names.count([int(w) for w in ids["union"]]) == n - 1
    assert np.array_equal(roots["torch"], keccak_root_claim(reqs))
    jax_root = _mod("jax", "zkvm.receipt").keccak_root_claim(reqs)
    assert np.array_equal(jax_root, roots["jax"]) == (n == 1)


# -- sessions and ProverImpl --------------------------------------------------

def _session(pkg, batches):
    """The keccak guest (risc0_tpu_torch/keccak_guest.py) with `batches`
    run by `pkg`'s executor at keccak po2 14; (session, image ID)."""
    from risc0_tpu_torch import keccak_guest

    X = _mod(pkg, "zkvm.exec")
    elf, _inputs, _root = keccak_guest.build(batches)
    env = X.ExecutorEnv(segment_po2=16, keccak_max_po2=14)
    impl = X.ExecutorImpl(env, elf)
    return impl.run(), impl.compute_image_id()


@pytest.fixture(scope="module")
def sessions():
    return {(pkg, batches): _session(pkg, batches)
            for pkg in PKGS for batches in ((3,), (3, 2))}


@pytest.mark.parametrize("batches", [(3,), (3, 2)])
def test_session_claims_match_jax(sessions, batches):
    """A session with pending keccak requests and the keccak root assumed
    through sys_verify_integrity2: the final segment's output lists it,
    and the session claim leaves it out, as in the JAX package.  For two
    batches the JAX package's root claim is not the guest's (see the
    module docstring), so its session claim keeps the assumption."""
    from risc0_tpu_torch import keccak_guest

    got = {}
    for pkg in PKGS:
        R = _mod(pkg, "zkvm.receipt")
        session, image_id = sessions[pkg, batches]
        assert session.exit_code == ("Halted", 0)
        assert [len(r["input"]) for r in session.pending_keccaks] == \
            list(batches)
        assert session.assumptions_used[0][1] is None
        got[pkg] = (R.keccak_root_claim(session.pending_keccaks),
                    R.session_segment_output(session).digest(),
                    R.session_claim(session), image_id)
    root, output, claim, image_id = got["torch"]
    assert np.array_equal(root, keccak_guest.build(batches)[2])
    assert np.array_equal(output, got["jax"][1])
    assert np.array_equal(image_id, got["jax"][3])
    assert claim.output.value.assumptions.value.items == []
    jax_claim = got["jax"][2]
    one = len(batches) == 1
    assert np.array_equal(got["jax"][0], root) == one
    assert np.array_equal(jax_claim.digest(), claim.digest()) == one
    assert len(jax_claim.output.value.assumptions.value.items) == (not one)


def test_assumption_receipts_take_the_union_root(monkeypatch):
    """_assumption_receipts (reference prover_impl.rs:121-153), with stubs
    as in tests/test_prover_impl.py: a proven entry keeps its receipt, an
    unresolved entry that the keccak union root covers takes that root,
    and one that it does not cover raises."""
    from risc0_tpu_torch.zkvm import recursion_driver
    from risc0_tpu_torch.zkvm.claims import Assumption
    from risc0_tpu_torch.zkvm.prover import ProverImpl

    root_claim = np.arange(8, dtype=np.uint32) + 9

    class Verifiable:
        def verify_integrity(self, ctx):
            pass

    union_root, proven, proved = Verifiable(), Verifiable(), []
    monkeypatch.setattr(recursion_driver, "keccak_union_root",
                        lambda reqs, device: (proved.extend(reqs),
                                              union_root)[1] if reqs else None)
    monkeypatch.setattr(recursion_driver, "receipt_claim_digest",
                        lambda r: root_claim)
    zero = np.zeros(8, np.uint32)

    class Session:
        pending_keccaks = [{"claim_digest": bytes(root_claim)}]
        assumptions_used = [(Assumption(root_claim, zero), None),
                            (Assumption(np.ones(8, np.uint32), zero), proven)]

    out = ProverImpl(device="cpu")._assumption_receipts(Session())
    assert out == [union_root, proven] and len(proved) == 1

    class Uncovered(Session):
        assumptions_used = [(Assumption(zero, zero), None)]

    with pytest.raises(ValueError, match="unresolved assumption"):
        ProverImpl(device="cpu")._assumption_receipts(Uncovered())


def _stub_seal_layer(monkeypatch, session):
    """The rv32im seal layer replaced by index-keyed stubs, as in
    tests/test_prover_impl.py, the claims logic kept: a segment's seal is
    [index, 0, ..., po2 at word 91], and decode_claim gives the claim the
    session implies for it."""
    from risc0_tpu_torch.circuit.rv32im import claim as claim_mod
    from risc0_tpu_torch.circuit.rv32im import prove as prove_mod
    from risc0_tpu_torch.circuit.rv32im import verify as verify_mod
    from risc0_tpu_torch.zkvm.claims import ExitCode
    from risc0_tpu_torch.zkvm.receipt import (segment_claim,
                                              session_segment_output)

    kind, *rest = session.exit_code
    exit_code = ExitCode(kind, rest[0] if rest else 0)
    output = session_segment_output(session)
    n = len(session.segments)
    claims = {seg.index: segment_claim(seg, i == n - 1, exit_code, output)
              for i, seg in enumerate(session.segments)}

    def seal(res, device):
        s = np.zeros(100, np.uint32)
        s[0], s[91] = res.index, res.po2
        return s

    monkeypatch.setattr(prove_mod, "segment_preflight",
                        lambda seg, device: seg)
    monkeypatch.setattr(prove_mod, "prove_segment_core", seal)
    monkeypatch.setattr(verify_mod, "verify_rv32im_seal",
                        lambda s: np.zeros(90, np.uint32))
    monkeypatch.setattr(claim_mod, "decode_claim",
                        lambda s: claims[int(np.asarray(s)[0])])


@pytest.mark.parametrize("batches", [(3,), (3, 2)])
def test_prover_impl_succinct_on_stubs(record, monkeypatch, sessions,
                                       batches):
    """ProverImpl(succinct).prove_session of the keccak guest on the CPU
    with every prove stubbed (rv32im seals, keccak seals, prove_zkr) and
    the recursion STARK check skipped, everything else real: the union
    root resolves the guest's assumption, and the receipt passes
    Receipt.verify(image_id) with the session's claim."""
    from risc0_tpu_torch.circuit.recursion import circuit as rec_circuit
    from risc0_tpu_torch.circuit.keccak import prove as kprove
    from risc0_tpu_torch.circuit.keccak import verify as kverify
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import (VerificationError,
                                              session_claim)

    session, image_id = sessions["torch", batches]
    _stub_seal_layer(monkeypatch, session)
    monkeypatch.setattr(kprove, "prove_keccak",
                        lambda inputs, po2, **kw: _fake_keccak_seal(inputs,
                                                                    po2))
    monkeypatch.setattr(kverify, "verify_keccak_seal",
                        lambda s: np.asarray(s[:17]))
    monkeypatch.setattr(rec_circuit, "verify_recursion_seal",
                        lambda seal, check_code, suite=None: None)
    info = ProverImpl(ProverOpts(receipt_kind="succinct"),
                      device="cpu").prove_session(session)
    info.receipt.verify(image_id)
    assert np.array_equal(info.receipt.claim().digest(),
                          session_claim(session).digest())
    n = len(batches)
    # keccak lifts, unions, the segment's lift and the resolve
    assert len(record["torch"]) == n + (n - 1) + 2
    with pytest.raises(VerificationError):
        info.receipt.verify(np.arange(8, dtype=np.uint32))


def test_prover_impl_composite_matches_jax(monkeypatch):
    """A two-segment loop session (tests/test_prover_impl.py's) proved as
    a composite receipt on stubs: the same claims as the JAX package's,
    and Receipt.verify(image_id) passes."""
    from risc0_tpu.zkvm.exec import ExecutorEnv as JEnv
    from risc0_tpu.zkvm.exec import ExecutorImpl as JImpl
    from risc0_tpu.zkvm.receipt import session_claim as jax_session_claim
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    elf = open(os.path.join(DATA, "..", "..", "guests", "loop.bin"),
               "rb").read()
    count = (1024 * 33).to_bytes(4, "little")
    env = ExecutorEnv(segment_po2=15).write_slice(count)
    session = ExecutorImpl(env, elf).run()
    assert len(session.segments) > 1
    _stub_seal_layer(monkeypatch, session)
    info = ProverImpl(ProverOpts(receipt_kind="composite"),
                      device="cpu").prove_session(session)
    info.receipt.verify(ExecutorImpl(env, elf).compute_image_id())
    jenv = JEnv(segment_po2=15).write_slice(count)
    jax_session = JImpl(jenv, elf).run()
    assert np.array_equal(info.receipt.claim().digest(),
                          jax_session_claim(jax_session).digest())
    segs = info.receipt.inner.value.segments
    assert [s.claim.exit_code.kind for s in segs] == \
        ["SystemSplit"] * (len(segs) - 1) + ["Halted"]


def test_what_is_not_ported_raises():
    """Every prover is served: the dev-mode one too (tests/
    test_torch_host.py), the groth16 kind, identity_p254 and shrink_wrap
    (tests/test_torch_snark.py), and identity_p254 takes only a
    Poseidon2 receipt; PoVW is served (tests/test_torch_povw_recursion.py
    proves a PoVW session on stubs)."""
    from risc0_tpu_torch.zkvm.prover import (DevModeProver, ProverImpl,
                                             ProverOpts, get_prover_server)
    from risc0_tpu_torch.zkvm.receipt import VerificationError

    assert isinstance(
        get_prover_server(ProverOpts(dev_mode=True), device="cpu"),
        DevModeProver)
    prover = ProverImpl(ProverOpts(receipt_kind="groth16"), device="cpu")
    p254 = _golden("torch", "recursion_seal_lift14")
    p254.hashfn = "poseidon254"
    for call in (lambda: prover.identity_p254(p254),
                 lambda: prover.shrink_wrap(p254)):
        with pytest.raises(VerificationError, match="poseidon2 inner"):
            call()

    class PovwSession:
        povw_job_id = 1

    # a PoVW session now reaches the prove, which reads its exit code
    with pytest.raises(AttributeError, match="exit_code"):
        prover.prove_session(PovwSession())
    for name in ("lift_povw", "join_povw", "unwrap_povw", "resolve_povw"):
        assert callable(getattr(prover, name))
