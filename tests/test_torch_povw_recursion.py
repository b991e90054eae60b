"""PoVW recursion in the port on the CPU against the JAX package: the Work
that a segment seal carries (decode_work, the executor's and witgen's
povw_nonce globals, session_work), the lift_rv32im_povw_14 program in the
port's preflight, what lift_povw, join_povw, unwrap_povw, resolve_povw and
compress_composite_povw hand to prove_zkr, ProverImpl's PoVW branch, and
the work-log update proved through the log-builder guest.

As in tests/test_torch_composition.py, prove_zkr is replaced by a recorder
in both packages and the records (program, control ID, allowed leaves,
tape, claim) must be equal word for word.  The proves of ProverImpl run on
stubs: a segment's seal is its real globals (the host witgen's), and a
stubbed recursion seal outputs what its program would: a lift the claim
decoded from the segment seal on its tape, and resolve its claim only
when the conditional's claim is what the resolve program recomputes from
the tape (the head assumption under the zero control root).  Under those
models the JAX package's log-builder guest cannot be proved (its seals
claim no assumption, and it assumes under the receipts' own root); the
port's can (ROADMAP.md queue 3).

`-m slow`: the live JAX preflight of lift_rv32im_povw_14, and a po2 14
segment with a nonce proved on the CPU and lifted with lift_povw.
"""

import importlib
import os

import numpy as np
import pytest
import torch
from test_torch_composition import (SEGMENT_SEAL, _golden,  # noqa: F401
                                    _kw, record)

from risc0_tpu_torch import field as F
from risc0_tpu_torch import loop_guest
from risc0_tpu_torch.circuit.layout import rv32im_global_layout
from risc0_tpu_torch.circuit.recursion.predicates import (load_own_program,
                                                          own_control_ids)
from risc0_tpu_torch.circuit.recursion.preflight import RecursionPreflight
from risc0_tpu_torch.circuit.rv32im.claim import decode_claim, decode_work
from risc0_tpu_torch.zkvm.povw import PovwJobId, PovwNonce, Work, WorkClaim

torch.set_num_threads(2)

PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
LOG = 0x5EED_C0FFEE
_IDS, _ROOT = own_control_ids()
_NAMES = {bytes(np.asarray(v, np.uint32)): k for k, v in _IDS.items()}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _port_work(jax_work):
    """A JAX Work as the port's (tests/test_torch_povw.py's helper)."""
    from test_torch_povw import work_from_jax_fields

    return work_from_jax_fields(jax_work)


def _seal_with_nonce(seal, nonce):
    """The fixture seal with its povw_nonce globals set to `nonce` (the
    recorder never verifies a seal; decode_work and decode_claim read
    these words)."""
    seal = np.array(seal, np.uint32)
    g = F.decode_np(seal[1:91])
    halfs = nonce.to_u16s()
    for i, pair in enumerate(rv32im_global_layout().povw_nonce.values):
        g[pair.low.offset], g[pair.high.offset] = halfs[2 * i:2 * i + 2]
    seal[1:91] = F.encode_np(g)
    return seal


# -- the Work of a segment seal -----------------------------------------------

def test_decode_work_matches_jax():
    from risc0_tpu.circuit.rv32im.claim import decode_work as jdecode
    from risc0_tpu.zkvm.povw import PovwNonce as JNonce

    seal = np.load(SEGMENT_SEAL)
    got, want = decode_work(seal), jdecode(seal)
    assert got.nonce_min == got.nonce_max == PovwNonce.ZERO
    assert want.nonce_min.to_u256() == 0
    assert np.array_equal(got.digest(), _port_work(want).digest())
    assert got.value == want.value == 1 << 14
    for log, job, segment in ((LOG, 7, 1), ((1 << 160) - 1, 1 << 63, 9)):
        nonced = _seal_with_nonce(seal, PovwJobId(log, job).nonce(segment))
        got, want = decode_work(nonced), jdecode(nonced)
        assert got.nonce_min.to_u256() == want.nonce_min.to_u256() == \
            JNonce(log, job, segment).to_u256()
        assert np.array_equal(got.digest(), _port_work(want).digest())
    bad = seal.copy()
    bad[0] = 1
    with pytest.raises(ValueError, match="version"):
        decode_work(bad)


def _sessions(pkg, po2, count, job):
    X = _mod(pkg, "zkvm.exec")
    P = _mod(pkg, "zkvm.povw")
    env = X.ExecutorEnv(segment_po2=po2,
                        povw_job_id=P.PovwJobId(log=LOG, job=job))
    return X.ExecutorImpl(env.write_slice(count.to_bytes(4, "little")),
                          loop_guest.elf()).run()


@pytest.mark.parametrize("po2,count,job", [(16, 100, 3), (15, 100, 4)])
def test_povw_nonce_globals_and_session_work_match_jax(po2, count, job):
    """The loop guest with a PoVW job id: one segment of po2 14 at segment
    po2 16, four segments at po2 15.  Each segment's nonce is job.nonce(i)
    in both executors, its povw_nonce globals from the host witgen are the
    JAX witgen's, and session_work is the JAX package's."""
    layout = rv32im_global_layout()
    cols = [c for pair in layout.povw_nonce.values
            for c in (pair.low.offset, pair.high.offset)]
    got = {}
    for pkg in PKGS:
        session = _sessions(pkg, po2, count, job)
        W = _mod(pkg, "circuit.rv32im.witgen")
        globs = [W.witgen_exec(seg, rand_z=(1, 2, 3, 4))["global"]
                 for seg in session.segments]
        P = _mod(pkg, "zkvm.povw")
        got[pkg] = (session, globs, P.session_work(session,
                                                   session.povw_job_id))
    (session, globs, work), (jsession, jglobs, jwork) = \
        got["torch"], got["jax"]
    assert [s.po2 for s in session.segments] == \
        [s.po2 for s in jsession.segments]
    for i, (seg, g, jg) in enumerate(zip(session.segments, globs, jglobs)):
        assert seg.povw_nonce == PovwJobId(LOG, job).nonce(i)
        assert np.array_equal(np.asarray(g)[cols], np.asarray(jg)[cols])
        halfs = np.asarray(g)[cols]
        assert np.array_equal(halfs, seg.povw_nonce.to_u16s())
    assert np.array_equal(work.digest(), _port_work(jwork).digest())
    assert work.value == sum(1 << s.po2 for s in session.segments)


def _lift_povw_tape(root, seal):
    return [int(w) for w in np.asarray(root, np.uint32)] + \
        [int(w) for w in np.asarray(seal, np.uint32)]


def test_lift_povw_14_preflight_outputs_the_work_claim():
    """The vendored lift_rv32im_povw_14 in the port's preflight over the
    fixture seal: it echoes the root and outputs the WorkClaim digest,
    which is the JAX package's host WorkClaim(decode_claim, decode_work)
    (the JAX package's tests/test_povw_predicates.py holds its own
    preflight to that digest; the live comparison is -m slow).  A flipped
    povw_nonce global breaks the STARK check in the VM."""
    from risc0_tpu.circuit.rv32im.claim import decode_claim as jclaim
    from risc0_tpu.circuit.rv32im.claim import decode_work as jwork
    from risc0_tpu.zkvm.povw import WorkClaim as JWorkClaim

    seal = np.load(SEGMENT_SEAL)
    prog = load_own_program("lift_rv32im_povw_14")
    pf = RecursionPreflight(_lift_povw_tape(_ROOT, seal))
    pf.run(prog.code)
    assert pf.output[:8] == [int(w) for w in _ROOT]
    want = WorkClaim(decode_claim(seal), decode_work(seal)).digest()
    jwant = JWorkClaim(jclaim(seal), jwork(seal)).digest()
    assert np.array_equal(want, jwant)
    assert pf.output[8:] == [int(w) & 0xFFFF for w in want]
    bad = seal.copy()
    bad[1 + 33] ^= 1  # the first povw_nonce short (layout register 33)
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight(_lift_povw_tape(_ROOT, bad)).run(prog.code)


@pytest.mark.slow
def test_lift_povw_14_preflight_is_the_jax_preflight():
    from risc0_tpu.circuit.recursion.predicates import \
        load_own_program as jload
    from risc0_tpu.circuit.recursion.preflight import \
        RecursionPreflight as JPreflight

    tape = _lift_povw_tape(_ROOT, np.load(SEGMENT_SEAL))
    ours = RecursionPreflight(tape)
    ours.run(load_own_program("lift_rv32im_povw_14").code)
    theirs = JPreflight(tape)
    theirs.run(jload("lift_rv32im_povw_14").code)
    assert ours.output == theirs.output


# -- what the drivers hand to prove_zkr ---------------------------------------

def _work_receipt(pkg, segment):
    """The golden lift receipt carrying WorkClaim{its claim, Work of
    job 5's `segment` with 2^14 cycles}."""
    P = _mod(pkg, "zkvm.povw")
    receipt = _golden(pkg, "recursion_seal_lift14")
    nonce = P.PovwJobId(log=LOG, job=5).nonce(segment)
    receipt.claim = P.WorkClaim(receipt.claim, P.Work(nonce, nonce, 1 << 14))
    return receipt


def _conditional(pkg):
    """A WorkClaim receipt whose claim assumes the golden keccak receipt's
    claim (head) and one more claim (test_torch_composition's)."""
    from test_torch_composition import _conditional as plain

    P = _mod(pkg, "zkvm.povw")
    receipt = plain(pkg)
    nonce = P.PovwJobId(log=LOG, job=5).nonce(0)
    receipt.claim = P.WorkClaim(receipt.claim,
                                P.Work(nonce, nonce, 1 << 14))
    return receipt


def _names(log):
    return [_NAMES[bytes(np.asarray(r["control_id"], np.uint32))]
            for r in log]


def test_lift_povw_tape_matches_jax(record):
    seal = _seal_with_nonce(np.load(SEGMENT_SEAL), PovwJobId(LOG, 5).nonce(2))
    for pkg in PKGS:
        C = _mod(pkg, "circuit.rv32im.claim")
        R = _mod(pkg, "zkvm.receipt")
        _mod(pkg, "zkvm.recursion_driver").lift_povw(
            R.SegmentReceipt(seal, 0, "poseidon2", C.decode_claim(seal)),
            **_kw(pkg))
    assert record["torch"] == record["jax"]
    assert _names(record["torch"]) == ["lift_rv32im_povw_14"]
    want = WorkClaim(decode_claim(seal), decode_work(seal)).digest()
    assert record["torch"][0]["claim"] == [int(w) for w in want]


@pytest.mark.parametrize("unwrap", [False, True])
def test_join_povw_tape_matches_jax(record, unwrap):
    for pkg in PKGS:
        _mod(pkg, "zkvm.recursion_driver").join_povw(
            _work_receipt(pkg, 0), _work_receipt(pkg, 1), unwrap=unwrap,
            **_kw(pkg))
    assert record["torch"] == record["jax"]
    assert _names(record["torch"]) == \
        ["join_unwrap_povw" if unwrap else "join_povw"]


def test_join_povw_rejects_a_gap_as_jax_does(record):
    for pkg in PKGS:
        P = _mod(pkg, "zkvm.povw")
        with pytest.raises(P.WorkError, match="contiguous"):
            _mod(pkg, "zkvm.recursion_driver").join_povw(
                _work_receipt(pkg, 0), _work_receipt(pkg, 2), **_kw(pkg))
    assert record["torch"] == record["jax"] == []


def test_unwrap_povw_tape_matches_jax(record):
    for pkg in PKGS:
        _mod(pkg, "zkvm.recursion_driver").unwrap_povw(
            _work_receipt(pkg, 3), **_kw(pkg))
    assert record["torch"] == record["jax"]
    assert _names(record["torch"]) == ["unwrap_povw"]
    assert record["torch"][0]["claim"] == [
        int(w) for w in _work_receipt("torch", 3).claim.claim.digest()]


@pytest.mark.parametrize("unwrap", [False, True])
def test_resolve_povw_tape_matches_jax(record, unwrap):
    for pkg in PKGS:
        _mod(pkg, "zkvm.recursion_driver").resolve_povw(
            _conditional(pkg), _golden(pkg, "keccak_lift14_seal"),
            unwrap=unwrap, **_kw(pkg))
    assert record["torch"] == record["jax"]
    assert _names(record["torch"]) == \
        ["resolve_unwrap_povw" if unwrap else "resolve_povw"]


def test_resolve_povw_without_assumptions_raises():
    from risc0_tpu_torch.zkvm.receipt import VerificationError
    from risc0_tpu_torch.zkvm.recursion_driver import resolve_povw

    receipt = _work_receipt("torch", 0)
    with pytest.raises(VerificationError, match="no assumptions"):
        resolve_povw(receipt, receipt, device="cpu")


@pytest.mark.parametrize("n,assumed", [(1, False), (2, False), (3, False),
                                       (2, True)])
def test_compress_composite_povw_tape_matches_jax(record, n, assumed):
    """n segments of job 5 (nonces 0..n-1 in the fixture seal's globals),
    the last one's claim assuming the golden keccak claim when `assumed`,
    with that receipt to resolve it; the returned Work is the JAX one."""
    seal = np.load(SEGMENT_SEAL)
    seals = [_seal_with_nonce(seal, PovwJobId(LOG, 5).nonce(i))
             for i in range(n)]
    works = {}
    for pkg in PKGS:
        C = _mod(pkg, "circuit.rv32im.claim")
        R = _mod(pkg, "zkvm.receipt")
        claims = [C.decode_claim(s) for s in seals]
        extra = []
        if assumed:
            from test_torch_composition import _conditional as plain

            claims[-1] = plain(pkg).claim
            extra = [_golden(pkg, "keccak_lift14_seal")]
        composite = R.CompositeReceipt(
            segments=[R.SegmentReceipt(s, i, "poseidon2", c)
                      for i, (s, c) in enumerate(zip(seals, claims))],
            assumption_receipts=extra)
        _receipt, works[pkg] = _mod(pkg, "zkvm.recursion_driver") \
            .compress_composite_povw(composite, **_kw(pkg))
    assert record["torch"] == record["jax"]
    want = {(1, False): ["lift_rv32im_povw_14", "unwrap_povw"],
            (2, False): ["lift_rv32im_povw_14"] * 2 + ["join_unwrap_povw"],
            (3, False): ["lift_rv32im_povw_14"] * 3
            + ["join_povw", "join_unwrap_povw"],
            (2, True): ["lift_rv32im_povw_14"] * 2
            + ["join_povw", "resolve_unwrap_povw"]}[n, assumed]
    assert _names(record["torch"]) == want
    assert np.array_equal(works["torch"].digest(),
                          _port_work(works["jax"]).digest())
    assert works["torch"].value == n << 14


@pytest.mark.parametrize("povw", [False, True])
def test_compress_composite_resolves_two_assumptions(record, povw):
    """A segment whose claim assumes two claims, with both receipts: the
    port resolves the head, then the next (the rest of the assumptions
    stays a value); the JAX package prunes the rest in its first resolve
    and fails at the second (ROADMAP.md queue 3).  The records they share
    are equal."""
    from test_torch_composition import _conditional as plain

    seal = _seal_with_nonce(np.load(SEGMENT_SEAL), PovwJobId(LOG, 5).nonce(0))
    errors = {}
    for pkg in PKGS:
        R = _mod(pkg, "zkvm.receipt")
        drv = _mod(pkg, "zkvm.recursion_driver")
        keccak = _golden(pkg, "keccak_lift14_seal")
        second = _golden(pkg, "recursion_seal_lift14")
        second.claim = _mod(pkg, "zkvm.claims").MaybePruned.from_digest(
            np.arange(8, dtype=np.uint32))
        composite = R.CompositeReceipt(
            segments=[R.SegmentReceipt(seal, 0, "poseidon2",
                                       plain(pkg).claim)],
            assumption_receipts=[keccak, second])
        run = drv.compress_composite_povw if povw else drv.compress_composite
        try:
            run(composite, **_kw(pkg))
        except AttributeError as e:
            errors[pkg] = e
    assert list(errors) == ["jax"]
    assert record["torch"][:len(record["jax"])] == record["jax"]
    resolves = ["resolve_povw", "resolve_unwrap_povw"] if povw \
        else ["resolve", "resolve"]
    assert _names(record["torch"])[1:] == resolves
    assert _names(record["jax"])[1:] == resolves[:1]


# -- ProverImpl's PoVW branch and the log-builder guest, on stubs -------------

def _read_halfs(words):
    return np.array([int(lo) | int(hi) << 16
                     for lo, hi in zip(words[0::2], words[1::2])], np.uint32)


def _resolve_claim_in_the_vm(tape):
    """The conditional claim digest that the resolve program recomputes
    from its tape (predicates.resolve): the head assumption's control
    root is zero.  The stub seals are 32 words and the inclusion proofs
    of the allowed set 8 digests deep."""
    from risc0_tpu_torch.zkvm.claims import tagged_struct

    t = np.asarray(tape, np.uint32)
    o = 8 + 1 + 8 * 8 + 32
    inp, pre, post = t[o:o + 8], t[o + 8:o + 16], t[o + 16:o + 24]
    sys_exit, user_exit = int(t[o + 24]), int(t[o + 25])
    journal, head, rest = t[o + 26:o + 34], t[o + 34:o + 42], t[o + 42:o + 50]
    assumption = tagged_struct("risc0.Assumption",
                               [head, np.zeros(8, np.uint32)], [])
    assumptions = tagged_struct("risc0.Assumptions", [assumption, rest], [])
    output = tagged_struct("risc0.Output", [journal, assumptions], [])
    return tagged_struct("risc0.ReceiptClaim", [inp, pre, post, output],
                         [sys_exit, user_exit])


@pytest.fixture
def modelled(monkeypatch):
    """The port's proves on stubs: a segment seal is [version, its real
    Montgomery globals, po2]; prove_zkr returns a 32-word seal that outputs
    the allowed root and what the program would claim (a lift: from the
    seal on its tape; resolve: its claim, if the conditional's claim is
    what the program recomputes, else it raises as the VM would); the
    recursion STARK check is skipped.  Returns the names proved."""
    from risc0_tpu_torch.circuit.recursion import circuit as rec_circuit
    from risc0_tpu_torch.circuit.rv32im import prove as prove_mod
    from risc0_tpu_torch.circuit.rv32im import verify as verify_mod
    from risc0_tpu_torch.circuit.rv32im.witgen import witgen_exec
    from risc0_tpu_torch.zkvm import recursion_driver as drv
    from risc0_tpu_torch.zkvm.receipt import SuccinctReceipt

    proved = []

    def core(res, device, **kw):
        po2 = res["rows"].bit_length() - 1
        return np.concatenate([[2], F.encode_np(res["global"]),
                               [po2]]).astype(np.uint32)

    def prove_zkr(program, control_id, allowed, tape, claim=None, **kw):
        name = _NAMES[bytes(np.asarray(control_id, np.uint32))]
        proved.append(name)
        out = claim.digest()
        seal = np.asarray(tape[8:], np.uint32)
        if name.startswith("lift_rv32im_povw"):
            out = WorkClaim(decode_claim(seal), decode_work(seal)).digest()
        elif name.startswith("lift_rv32im"):
            out = decode_claim(seal).digest()
        elif name == "resolve":
            cond = _read_halfs(F.decode_np(
                np.asarray(tape[73:105], np.uint32))[16:32])
            if not np.array_equal(_resolve_claim_in_the_vm(tape), cond):
                raise ValueError("resolve: recursion EQ failed")
        words = np.zeros(32, np.uint32)
        words[0:16:2] = _ROOT
        words[16::2], words[17::2] = out & 0xFFFF, out >> 16
        return SuccinctReceipt(
            seal=F.encode_np(words), control_id=np.asarray(control_id,
                                                           np.uint32),
            claim=claim, control_root=_ROOT,
            control_inclusion_proof={"index": 0, "digests": []})

    monkeypatch.setattr(prove_mod, "segment_preflight",
                        lambda seg, device, **kw: witgen_exec(seg,
                                                              (1, 2, 3, 4)))
    monkeypatch.setattr(prove_mod, "prove_segment_core", core)
    monkeypatch.setattr(verify_mod, "verify_rv32im_seal",
                        lambda s: np.zeros(90, np.uint32))
    monkeypatch.setattr(drv, "prove_zkr", prove_zkr)
    monkeypatch.setattr(rec_circuit, "verify_recursion_seal",
                        lambda seal, check_code, suite=None: None)
    return proved


def test_prover_impl_povw_branch_on_stubs(modelled):
    """ProverImpl(succinct).prove of a two-segment loop session with a PoVW
    job id (segment po2 16: segments of po2 16 and 15): two lift_povw and
    join_unwrap_povw; info.work is the JAX session_work, the receipt
    passes Receipt.verify(image_id) with the session's claim, and the
    composite kind reports the same work."""
    from risc0_tpu.zkvm.exec import ExecutorImpl as JImpl
    from risc0_tpu.zkvm.povw import PovwJobId as JJob
    from risc0_tpu.zkvm.povw import session_work as jsession_work
    from risc0_tpu_torch.zkvm.exec import ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import session_claim

    job = PovwJobId(log=LOG, job=7)
    env = loop_guest.session_env(16, 2, job)
    info = ProverImpl(ProverOpts(receipt_kind="succinct"),
                      device="cpu").prove(env, loop_guest.elf())
    session = info.session
    assert [s.po2 for s in session.segments] == [16, 15]
    assert modelled == ["lift_rv32im_povw_16", "lift_rv32im_povw_15",
                        "join_unwrap_povw"]
    info.receipt.verify(ExecutorImpl(env, loop_guest.elf())
                        .compute_image_id())
    assert np.array_equal(info.receipt.claim().digest(),
                          session_claim(session).digest())
    jenv = _mod("jax", "zkvm.exec").ExecutorEnv(
        segment_po2=16, povw_job_id=JJob(log=LOG, job=7)).write_slice(
            env.input)
    jwork = jsession_work(JImpl(jenv, loop_guest.elf()).run(),
                          JJob(log=LOG, job=7))
    assert np.array_equal(info.work.digest(), _port_work(jwork).digest())
    assert (info.work.nonce_min, info.work.nonce_max, info.work.value) == \
        (job.nonce(0), job.nonce(1), (1 << 16) + (1 << 15))
    composite = ProverImpl(ProverOpts(receipt_kind="composite"),
                           device="cpu").prove(env, loop_guest.elf())
    assert np.array_equal(composite.work.digest(), info.work.digest())
    plain = ProverImpl(ProverOpts(receipt_kind="composite"),
                       device="cpu").prove(loop_guest.session_env(16, 2),
                                           loop_guest.elf())
    assert plain.work is None


def _work_receipt_of_a_segment(job):
    """lift_povw (stubbed) of the one-segment po2 14 session of `job`."""
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.zkvm.receipt import SegmentReceipt
    from risc0_tpu_torch.zkvm.recursion_driver import lift_povw

    (seg,) = _sessions("torch", 16, 100, job).segments
    seal = prove_segment(seg, device="cpu")
    return lift_povw(SegmentReceipt(seal, 0, "poseidon2",
                                    decode_claim(seal)), device="cpu")


def test_work_log_update_through_the_proved_guest_on_stubs(modelled):
    """WorkLogUpdateProver.prove_update of lift_povw receipts with the
    log-builder guest proved by ProverImpl(succinct) (the JAX package's
    test_povw_full_cryptographic_chain), twice to chain a continuation:
    each guest segment is lifted and each assumption resolved, and the
    journal receipts pass Receipt.verify(guest image ID)."""
    from risc0_tpu_torch.zkvm.povw_guest import LogBuilderGuestProver
    from risc0_tpu_torch.zkvm.povw_updater import WorkLogUpdateProver
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    guest = LogBuilderGuestProver(prover=ProverImpl(
        ProverOpts(receipt_kind="succinct"), device="cpu"))
    updater = WorkLogUpdateProver(log_id=LOG, journal_prover=guest,
                                  device="cpu")
    for job in (8, 9):
        work = _work_receipt_of_a_segment(job)
        del modelled[:]
        journal, receipt = updater.prove_update([work])
        receipt.verify(guest.image_id())
        assert receipt.inner.kind == "succinct"
        assert journal.update_value == 1 << 14
        assert journal.updated_commit == updater.work_log.commit()
        resolves = 1 if job == 8 else 2  # the continuation's prior receipt
        assert modelled[-resolves:] == ["resolve"] * resolves
        assert modelled[0].startswith("lift_rv32im_")


def test_jax_guest_session_is_not_provable(monkeypatch):
    """The reference-side fault the port repairs (ROADMAP.md queue 3): the
    JAX log-builder guest commits Output{journal, no assumption} though
    its session records the work claims it verified, so its seal's claim
    is not the session's (the lift's claim check fails), and it assumes
    each claim under the receipts' own control root, which the resolve
    program does not discharge.  The port's guest commits what its
    session records, under the zero root."""
    for pkg in PKGS:
        G, R = _mod(pkg, "zkvm.povw_guest"), _mod(pkg, "zkvm.receipt")
        T, X = _mod(pkg, "zkvm.povw_tree"), _mod(pkg, "zkvm.exec")
        C, W = _mod(pkg, "circuit.rv32im.claim"), \
            _mod(pkg, "circuit.rv32im.witgen")
        P = _mod(pkg, "zkvm.povw")
        nonce = P.PovwJobId(log=LOG, job=1).nonce(0)
        wc = P.WorkClaim(C.decode_claim(np.load(SEGMENT_SEAL)),
                         P.Work(nonce, nonce, 1 << 14))
        receipt = R.FakeReceipt(wc)
        receipt.control_root = _ROOT  # as a succinct receipt carries it
        sessions = []
        run = X.ExecutorImpl.run
        monkeypatch.setattr(X.ExecutorImpl, "run",
                            lambda self: sessions.append(run(self))
                            or sessions[-1])
        gp = G.LogBuilderGuestProver()
        path = T.WorkLog().prove_add(1, T.Job(0)).path
        gp.prove(log_id=LOG, initial_commit=T.WorkLog().commit(),
                 updates=[(wc._digest_of(wc.claim).tobytes(),
                           nonce.to_bytes(), nonce.to_bytes(), 1 << 14,
                           path)],
                 work_receipts=[receipt])
        (session,) = sessions
        (seg,) = session.segments
        g = W.witgen_exec(seg, rand_z=(1, 2, 3, 4))["global"]
        seal = np.concatenate([[2], _mod(pkg, "field").encode_np(
            np.asarray(g, np.uint32)), [seg.po2]]).astype(np.uint32)
        committed = C.decode_claim(seal).output.digest()
        recorded = R.session_segment_output(session).digest()
        (assumption, _r), = session.assumptions_used
        root = np.asarray(assumption.control_root, np.uint32)
        if pkg == "jax":
            assert not np.array_equal(committed, recorded)
            assert np.array_equal(root, _ROOT)
        else:
            assert np.array_equal(committed, recorded)
            assert not root.any()
        monkeypatch.undo()


@pytest.mark.slow
def test_lift_povw_on_the_cpu():
    """A po2 14 loop segment with a nonce proved on the CPU, its
    decode_work, and lift_povw of it on the CPU, verified."""
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.zkvm.receipt import SegmentReceipt, VerifierContext
    from risc0_tpu_torch.zkvm.recursion_driver import lift_povw

    job = PovwJobId(log=LOG, job=11)
    (seg,) = _sessions("torch", 16, 100, 11).segments
    seal = prove_segment(seg, rand_z=(1, 2, 3, 4), device="cpu",
                         eval_chunk=1 << 12)
    work = decode_work(seal)
    assert (work.nonce_min, work.nonce_max, work.value) == \
        (job.nonce(0), job.nonce(0), 1 << 14)
    receipt = lift_povw(SegmentReceipt(seal, 0, "poseidon2",
                                       decode_claim(seal)),
                        rng=np.random.default_rng(1), device="cpu",
                        eval_chunk=1 << 13)
    receipt.verify_integrity(VerifierContext(control_root=_ROOT))
    assert np.array_equal(receipt.claim.digest(),
                          WorkClaim(decode_claim(seal), work).digest())
    assert isinstance(receipt.claim.work, Work)
