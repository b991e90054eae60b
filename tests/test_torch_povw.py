"""The PoVW host structures of the port against the JAX package: nonce and
job encodings, Work and WorkClaim (join, seal words, digests), the nonce
work log, the on-chain work-log trees and their openings, the update
transition and its journal, and the log-builder guest executed in both
packages (tests/test_povw.py, test_povw_tree.py, test_povw_updater.py and
the executed cases of test_povw_guest.py).

The same inputs go through both packages and the outputs must be equal.
The one deliberate difference is the log-builder guest: the port's
commits the Assumptions it verified in its Output and assumes each claim
under the zero control root, so its ELF and image ID differ from the JAX
package's (ROADMAP.md queue 3); with its assumption digest left out, the
ELF is the JAX package's byte for byte, and the two guests give the same
exit code and journal for the same batch.
"""

import importlib

import numpy as np
import pytest

PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
LOG = 0xABCDEF0123456789ABCDEF0123456789ABCDEF01
ULOG = 0xC0FFEE  # the work log of the update tests


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.zkvm.{name}")


def work_from_jax_fields(obj):
    """A JAX Work or WorkClaim as the port's: the nonces by their u256, the
    value, and a claim by its digest (so the WorkClaim digest is kept)."""
    P = _mod("torch", "povw")
    if hasattr(obj, "nonce_min"):
        return P.Work(P.PovwNonce.from_u256(obj.nonce_min.to_u256()),
                      P.PovwNonce.from_u256(obj.nonce_max.to_u256()),
                      int(obj.value))
    claim = np.asarray(obj._digest_of(obj.claim), np.uint32)
    work = obj.work if isinstance(obj.work, np.ndarray) \
        else work_from_jax_fields(obj.work)
    return P.WorkClaim(claim, work)


def _both(fn):
    """fn(pkg) for each package, as {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PKGS}


def _outcome(fn):
    """The result of fn(), or its exception's class name."""
    try:
        return fn()
    except Exception as e:  # both packages' errors, compared by name
        return type(e).__name__


def _claim(pkg, tag, exit_kind="SystemSplit"):
    C = _mod(pkg, "claims")
    return C.ReceiptClaim(
        pre=C.MaybePruned.of(C.SystemState(0, np.full(8, tag, np.uint32))),
        post=C.MaybePruned.of(C.SystemState(0, np.full(8, tag + 1,
                                                       np.uint32))),
        exit_code=C.ExitCode(exit_kind, 0), input=None, output=None)


# -- nonces, jobs, Work and WorkClaim -----------------------------------------

NONCES = [(0, 0, 0), (LOG, 0x1122334455667788, 7),
          ((1 << 160) - 1, (1 << 64) - 1, (1 << 32) - 1), (1, 2, 3)]


@pytest.mark.parametrize("log,job,segment", NONCES)
def test_nonce_and_job_encodings_match_jax(log, job, segment):
    def enc(pkg):
        P = _mod(pkg, "povw")
        n = P.PovwNonce(log, job, segment)
        buf = []
        n.encode_to_seal(buf)
        j = P.PovwJobId(log=log, job=job)
        back = P.PovwNonce.decode_from_seal(list(buf))
        return (n.to_u256(), n.to_bytes(), n.to_u32s().tolist(),
                n.to_u16s().tolist(), buf, P.PovwNonce.from_u16s(
                    n.to_u16s()) == n, back == n, j.to_bytes(),
                P.PovwJobId.from_bytes(j.to_bytes()) == j,
                j.nonce(segment) == n)
    got = _both(enc)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (log << 96) | (job << 32) | segment
    assert all(got["torch"][5:7]) and all(got["torch"][8:])


def test_nonce_zero_and_decode_rejection_match_jax():
    P = _mod("torch", "povw")
    assert P.PovwNonce.ZERO == P.PovwNonce(0, 0, 0)
    bad = [0] * 15 + [1 << 16]
    got = _both(lambda pkg: _outcome(
        lambda: _mod(pkg, "povw").PovwNonce.decode_from_seal(list(bad))))
    assert got == {"jax": "ValueError", "torch": "ValueError"}


# (first, second) as (segment_min, segment_max, value) of one job
JOINS = {
    "contiguous": ((0, 3, 100), (4, 9, 50)),
    "one_each": ((0, 0, 1 << 14), (1, 1, 1 << 15)),
    "gap": ((0, 3, 1), (5, 6, 1)),
    "overlap": ((0, 3, 1), (3, 6, 1)),
    "reversed": ((4, 9, 1), (0, 3, 1)),
    "value_carry": ((3, 3, 0xFFFF_FFFF), (4, 4, 1)),
}


@pytest.mark.parametrize("case", sorted(JOINS))
def test_work_join_matches_jax(case):
    (a0, a1, av), (b0, b1, bv) = JOINS[case]

    def join(pkg):
        P = _mod(pkg, "povw")
        j = P.PovwJobId(log=LOG, job=1)
        a, b = P.Work(j.nonce(a0), j.nonce(a1), av), \
            P.Work(j.nonce(b0), j.nonce(b1), bv)
        return _outcome(lambda: (a.join(b).digest().tolist(),
                                 a.join(b).value))
    got = _both(join)
    assert got["torch"] == got["jax"]
    contiguous = a1 + 1 == b0
    assert (got["torch"] != "WorkError") == contiguous


def test_work_join_past_the_top_of_the_nonce_space_matches_jax():
    def join(pkg):
        P = _mod(pkg, "povw")
        top = P.PovwNonce.from_u256((1 << 256) - 1)
        return _outcome(lambda: P.Work(top, top, 5).join(
            P.Work(P.PovwNonce.ZERO, P.PovwNonce.ZERO, 5)))
    assert _both(join) == {"jax": "WorkError", "torch": "WorkError"}


@pytest.mark.parametrize("value", [0, 1, 1 << 40, (1 << 64) - 1])
def test_work_seal_words_and_digest_match_jax(value):
    def enc(pkg):
        P = _mod(pkg, "povw")
        j = P.PovwJobId(log=LOG, job=2)
        w = P.Work(j.nonce(0), j.nonce(7), value)
        buf = []
        w.encode_to_seal(buf)
        return buf, P.Work.decode_from_seal(list(buf)) == w, \
            w.digest().tolist()
    got = _both(enc)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]


def test_work_claim_digests_and_join_match_jax():
    def wc(pkg):
        P = _mod(pkg, "povw")
        j = P.PovwJobId(log=LOG, job=3)
        wc1 = P.WorkClaim(_claim(pkg, 1), P.Work(j.nonce(0), j.nonce(0), 10))
        wc2 = P.WorkClaim(_claim(pkg, 2, "Halted"),
                          P.Work(j.nonce(1), j.nonce(1), 20))
        joined = wc1.join(wc2)
        pruned = _outcome(lambda: P.WorkClaim(wc1.digest(), wc1.work)
                          .join(wc2))
        return (wc1.digest().tolist(), wc2.digest().tolist(),
                joined.digest().tolist(), joined.work.value,
                joined.claim.exit_code.kind, pruned, (wc1, joined))
    got = _both(wc)
    assert got["torch"][:6] == got["jax"][:6]
    assert got["torch"][5] == "WorkError"
    # the helper keeps a WorkClaim's digest across the packages
    for jax_wc, torch_wc in zip(got["jax"][6], got["torch"][6]):
        port = work_from_jax_fields(jax_wc)
        assert np.array_equal(port.digest(), torch_wc.digest())
        assert np.array_equal(work_from_jax_fields(jax_wc.work).digest(),
                              torch_wc.work.digest())


def test_work_log_matches_jax():
    def run(pkg):
        P = _mod(pkg, "povw")
        log = P.WorkLog(LOG)
        j, j2 = P.PovwJobId(log=LOG, job=1), P.PovwJobId(log=LOG, job=2)
        out = []
        for lo, hi, job in ((0, 9, j), (9, 12, j), (10, 500, j), (0, 0, j2),
                            (3, 1, j2)):
            out.append(_outcome(lambda: log.record(
                P.Work(job.nonce(lo), job.nonce(hi), 1))))
            out.append(log.commit().tolist())
        out.append(_outcome(lambda: P.WorkLog(1).record(
            P.Work(j.nonce(501), j.nonce(501), 1))))
        out.append([log.contains(j.nonce(k)) for k in (0, 5, 10, 500, 501)])
        out.append(_outcome(lambda: log.to_tree().commit()))  # no hole
        guard = P.WorkLog(LOG)
        guard.record(P.Work(j.nonce(0), j.nonce(5), 6))
        out.append(guard.to_tree().commit())
        guard.record(P.Work(j.nonce(8), j.nonce(9), 2))
        out.append(_outcome(lambda: guard.to_tree()))
        return out
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == "WorkError"  # nonce 9 reused
    assert isinstance(got["torch"][-3], bytes)
    assert got["torch"][-1] == "WorkError"  # a hole at 6, 7


# -- the on-chain work-log trees ----------------------------------------------

# reference consts.rs:22-40 / 277-283 (protocol constants)
GOLDEN = {
    ("empty", 0): "a505c1affa9b6d2ed829d837d14eb8614f198bfc7f40e3c438ac9e366f410073",
    ("empty", 248): "99a98889a97781b0019cb47c8d71bbfb2de4a30a964fc0a81125bf060facb67c",
    ("full", 0): "db015763e201a3f7e51178938859ce0f6c6d9c3457f42b0dc9244c3ab65ebe89",
    ("full", 3): "38ae93b73e70d7735b2067227f5cc747e49cc692930333140bec3ed280cae1ef",
}


def test_subtree_roots_match_jax_and_the_goldens():
    T, JT = _mod("torch", "povw_tree"), _mod("jax", "povw_tree")
    assert T.EMPTY_SUBTREE_ROOTS == JT.EMPTY_SUBTREE_ROOTS
    assert T.FULL_SUBTREE_ROOTS == JT.FULL_SUBTREE_ROOTS
    assert len(T.EMPTY_SUBTREE_ROOTS) == T.WorkSet.TREE_HEIGHT + 1 == 249
    assert (T.Job.TREE_HEIGHT, T.WorkLog.TREE_HEIGHT) == (24, 88)
    for (kind, i), hexd in GOLDEN.items():
        table = T.EMPTY_SUBTREE_ROOTS if kind == "empty" \
            else T.FULL_SUBTREE_ROOTS
        assert table[i].hex() == hexd, (kind, i)
    for lo, hi in ((0, 1), (2, 5), (0, 256)):
        assert T.bitmap_from_range(lo, hi) == JT.bitmap_from_range(lo, hi)


def _verdicts(opening, commit, index):
    """(inclusion, non-inclusion) verdicts of an opening: True or the
    error's class name."""
    return tuple(_outcome(lambda f=f: f(commit, index) is None)
                 for f in (opening.verify_inclusion,
                           opening.verify_noninclusion))


@pytest.mark.parametrize("index_max", [None, 0, 1, 255, 256, 300, 1 << 16,
                                       (1 << 32) - 1])
def test_job_commits_and_openings_match_jax(index_max):
    def run(pkg):
        T = _mod(pkg, "povw_tree")
        job = T.Job(index_max)
        commit = job.commit()
        out = [commit]
        for probe in (0, 7, 255, 256, 300, 301, 557, (1 << 32) - 1):
            op = job.prove_opening(probe)
            out.append((op.bitmap, op.path, job.contains(probe),
                        _verdicts(op, commit, probe)))
        return out
    got = _both(run)
    assert got["torch"] == got["jax"]
    for _b, _p, included, verdicts in got["torch"][1:]:
        assert verdicts == ((True, "TreeError") if included
                            else ("TreeError", True))


@pytest.mark.parametrize("forge", ["sibling", "bitmap", "short"])
def test_forged_openings_are_rejected_as_in_jax(forge):
    def run(pkg):
        T = _mod(pkg, "povw_tree")
        log = T.WorkLog({0: T.Job(300), 5: T.Job(0)})
        commit = log.commit()
        op = log.prove_opening(7)
        if forge == "sibling":
            op = T.Opening(op.bitmap, [op.path[0][::-1]] + op.path[1:])
        elif forge == "bitmap":
            op = T.Opening(op.bitmap ^ 1 << 9, op.path)
        else:
            op = T.Opening(op.bitmap, op.path[:-1])
        return _verdicts(op, commit, 7)
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] != True  # noqa: E712 (a verdict or an error)


def test_work_log_and_work_set_match_jax():
    def run(pkg):
        T = _mod(pkg, "povw_tree")
        log = T.WorkLog()
        out = [log.commit()]
        for job_id, index_max in ((0, 499), (5, 0), (1 << 40, 65535)):
            log.add(job_id, T.Job(index_max))
            out.append(log.commit())
        out.append(_outcome(lambda: log.add(5, T.Job(1))))
        commit = log.commit()
        for seq in (0, 499, 500, 5 << 32, (5 << 32) | 1, (1 << 72) | 1234,
                    3 << 32):
            op = log.prove_opening(seq)
            out.append((log.contains(seq), op.bitmap, op.path,
                        _verdicts(op, commit, seq)))
        pre = log.commit()
        proof = log.prove_add(7, T.Job(3))
        out.append((proof.path, proof.level, log.commit(),
                    _outcome(lambda: proof.verify_empty(pre, 7 << 32)),
                    _outcome(lambda: proof.verify_empty(log.commit(),
                                                        7 << 32)),
                    _outcome(lambda: proof.verify_full(pre, 7 << 32))))
        ws = T.WorkSet()
        out.append(ws.commit())
        ws.add(0xABCDEF, T.WorkLog({0: T.Job(99)}))
        ws.add((1 << 159) | 17, T.WorkLog({3: T.Job(0)}))
        out.append(_outcome(lambda: ws.add(0xABCDEF, T.WorkLog())))
        commit = ws.commit()
        for nonce in ((0xABCDEF << 96) | 42, (0x999999 << 96) | 42,
                      (0xABCDEF << 96) | 100,
                      (((1 << 159) | 17) << 96) | (3 << 32)):
            op = ws.prove_opening(nonce)
            out.append((ws.contains(nonce), op.bitmap, op.path,
                        _verdicts(op, commit, nonce)))
        return out
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][4] == "TreeError"  # job 5 added twice


# -- the update transition and its journal ------------------------------------

def _random_claim(pkg):
    C = _mod(pkg, "claims")
    rng = np.random.default_rng(11)

    def d():
        return rng.integers(0, 2**32, 8, dtype=np.uint32)
    return C.ReceiptClaim(
        pre=C.MaybePruned.from_digest(d()),
        post=C.MaybePruned.from_digest(d()),
        exit_code=C.ExitCode("Halted", 0),
        input=C.MaybePruned.from_digest(np.zeros(8, np.uint32)),
        output=C.MaybePruned.from_digest(d()))


class _WorkReceipt:
    """A stand-in for a SuccinctReceipt[WorkClaim] of `pkg` that verifies
    only under a dev-mode context (tests/test_povw_updater.py's)."""

    def __init__(self, pkg, job, segments, value, log=ULOG, start=0):
        P = _mod(pkg, "povw")
        self.pkg = pkg
        jid = P.PovwJobId(log=log, job=job)
        self.claim = P.WorkClaim(_random_claim(pkg), P.Work(
            jid.nonce(start), jid.nonce(segments - 1), value))

    def verify_integrity(self, ctx):
        if not ctx.dev_mode:
            raise _mod(self.pkg, "receipt").VerificationError("dev mode only")


def _journal_fields(j):
    """A LogBuilderJournal without its self_image_id (each package's guest
    has its own image ID)."""
    return (j.work_log_id, j.initial_commit, j.updated_commit,
            j.update_value)


def _dev_updater(pkg, **kw):
    U, R = _mod(pkg, "povw_updater"), _mod(pkg, "receipt")
    return U.WorkLogUpdateProver(
        log_id=kw.pop("log_id", ULOG),
        verifier_ctx=R.VerifierContext(dev_mode=True), **kw)


@pytest.mark.parametrize("start,replay", [(0, False), (0, True), (2, False)])
def test_apply_update_matches_jax(start, replay):
    def run(pkg):
        P, T, U = (_mod(pkg, m) for m in ("povw", "povw_tree",
                                          "povw_updater"))
        log = T.WorkLog()
        log.add(9, T.Job(3))
        pre = log.commit()
        proof = log.prove_add(4, T.Job(19))
        jid = P.PovwJobId(log=ULOG, job=4)
        wc = P.WorkClaim(_random_claim(pkg), P.Work(
            jid.nonce(start), jid.nonce(19), 20 << 16))
        commit = log.commit() if replay else pre
        return _outcome(lambda: U.apply_update(commit,
                                               U.WorkLogUpdate(wc, proof))), \
            log.commit()
    got = _both(run)
    assert got["torch"] == got["jax"]
    if start == 0 and not replay:
        assert got["torch"][0] == (got["torch"][1], 20 << 16)
    else:
        assert isinstance(got["torch"][0], str)


def test_journal_encoding_matches_jax():
    def run(pkg):
        U = _mod(pkg, "povw_updater")
        j = U.LogBuilderJournal(ULOG, b"\1" * 32, b"\2" * 32, 12345,
                                np.arange(8, dtype=np.uint32))
        j2 = U.LogBuilderJournal.decode(j.encode())
        return j.encode(), _journal_fields(j2), \
            j2.self_image_id.tolist(), _outcome(
                lambda: U.LogBuilderJournal.decode(j.encode()[:-1]))
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == "ValueError"


def test_prove_update_chains_like_jax():
    """Three rounds through the executed log-builder guest in each package:
    the same journals (but the guest's image ID), commits and errors."""
    def run(pkg):
        up = _dev_updater(pkg)
        out = []
        for batch in ([(1, 30, 30 << 16), (2, 4, 4 << 16)],
                      [(3, 1, 1 << 16)],
                      [(7, 4, 1), (8, 5, 1, ULOG, 2)],   # a bad claim
                      [(7, 4, 1), (8, 5, 1)],            # its retry
                      [(7, 2, 1)],                       # job 7 reused
                      [(9, 1, 1, ULOG + 1)],             # another log
                      [(10, 1, 1), (10, 2, 2)]):         # one job twice
            res = _outcome(lambda: up.prove_update(
                [_WorkReceipt(pkg, *args) for args in batch]))
            if isinstance(res, str):
                out.append(res)
            else:
                journal, receipt = res
                decoded = _mod(pkg, "povw_updater").LogBuilderJournal \
                    .decode(receipt.journal)
                assert np.array_equal(decoded.self_image_id,
                                      up.journal_prover.image_id())
                out.append((_journal_fields(journal),
                            _journal_fields(decoded), receipt.inner.kind))
            out.append(up.work_log.commit())
        return out
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert [isinstance(x, str) for x in got["torch"][::2]] == \
        [False, False, True, False, True, True, True]


def test_prove_update_requires_verifiable_receipts_as_in_jax():
    def run(pkg):
        R = _mod(pkg, "receipt")
        up = _mod(pkg, "povw_updater").WorkLogUpdateProver(
            log_id=ULOG, verifier_ctx=R.VerifierContext(dev_mode=False))
        return _outcome(lambda: up.prove_update(
            [_WorkReceipt(pkg, 1, 4, 1)])), up.work_log.is_empty()
    assert _both(run) == {"jax": ("WorkError", True),
                          "torch": ("WorkError", True)}


def test_fake_receipt_verifies_only_in_dev_mode():
    R = _mod("torch", "receipt")
    C = _mod("torch", "claims")
    claim = C.receipt_claim_ok(np.arange(8, dtype=np.uint32),
                               C.bytes_digest(b"journal"))
    receipt = R.Receipt(R.InnerReceipt("fake", R.FakeReceipt(claim)),
                        b"journal")
    receipt.verify(np.arange(8, dtype=np.uint32),
                   R.VerifierContext(dev_mode=True))
    with pytest.raises(R.VerificationError, match="dev mode"):
        receipt.verify(np.arange(8, dtype=np.uint32),
                       R.VerifierContext(dev_mode=False))
    assert np.array_equal(receipt.inner.value.claim_digest(), claim.digest())


# -- the log-builder guest, executed ------------------------------------------

def test_log_builder_elf_is_the_jax_elf_but_the_assumption_digest(
        monkeypatch):
    TG, JG = _mod("torch", "povw_guest"), _mod("jax", "povw_guest")
    TE = _mod("torch", "exec")
    repaired = TG.log_builder_elf()
    image_id = TG.LogBuilderGuestProver().image_id()
    assert repaired != JG.log_builder_elf()
    monkeypatch.setattr(TG, "_ELF_CACHE", None)
    monkeypatch.setattr(_mod("torch", "guest_env").GuestEnv,
                        "_record_assumption", lambda self, tok: None)
    assert TG.log_builder_elf() == JG.log_builder_elf()
    assert np.array_equal(
        TE.ExecutorImpl(TE.ExecutorEnv(), TG.log_builder_elf())
        .compute_image_id(), JG.LogBuilderGuestProver().image_id())
    # the image ID does not depend on the input: one stable digest
    monkeypatch.setattr(TG, "_ELF_CACHE", None)
    monkeypatch.undo()
    assert TG.log_builder_elf() == repaired
    assert np.array_equal(TG.LogBuilderGuestProver().image_id(), image_id)


def _updates_for(pkg, receipts, tree=None):
    """The guest's update records of `receipts` (test_povw_guest.py's)."""
    T = _mod(pkg, "povw_tree")
    tree = tree or T.WorkLog()
    out = []
    for r in receipts:
        wc = r.claim
        proof = tree.prove_add(wc.work.nonce_min.job,
                               T.Job(wc.work.nonce_max.segment))
        out.append((wc._digest_of(wc.claim).tobytes(),
                    wc.work.nonce_min.to_bytes(),
                    wc.work.nonce_max.to_bytes(), wc.work.value, proof.path))
    return out


def _run_guest(pkg, case):
    """Execute the log-builder guest of `pkg` on the input of `case`;
    (exit code, journal without its image ID) or the error's class."""
    G, T, U = (_mod(pkg, m) for m in ("povw_guest", "povw_tree",
                                      "povw_updater"))
    E = _mod(pkg, "exec")
    gp = G.LogBuilderGuestProver()
    empty = T.WorkLog().commit()
    receipts = [_WorkReceipt(pkg, 1, 30, 30 << 16),
                _WorkReceipt(pkg, 2, 4, 4 << 16)]
    initial, assumed, prior = empty, receipts, None
    updates = _updates_for(pkg, receipts)
    if case == "tampered_path":
        claim, nmin, nmax, value, path = updates[0]
        updates[0] = (claim, nmin, nmax, value,
                      path[:3] + [bytes(32)] + path[4:])
    elif case == "foreign_log":
        assumed = [_WorkReceipt(pkg, 1, 5, 5 << 16, log=0xBEEF)]
        updates = _updates_for(pkg, assumed)
    elif case == "nonzero_start":
        assumed = [_WorkReceipt(pkg, 1, 5, 5 << 16, start=2)]
        updates = _updates_for(pkg, assumed)
    elif case == "no_receipt":
        assumed = []
    elif case == "duplicate_job":
        updates = [updates[0], updates[0]]
    elif case == "nonempty_initial":
        tree = T.WorkLog({99: T.Job(1)})
        initial = tree.commit()
        updates = _updates_for(pkg, receipts,
                               T.WorkLog(jobs=dict(tree.jobs)))
    elif case.startswith("continuation"):
        up = _dev_updater(pkg)
        j1, r1 = up.prove_update([_WorkReceipt(pkg, 1, 4, 4 << 16)])
        prior = bytearray(j1.encode())
        if case == "continuation_forged":
            prior[52] ^= 1
        elif case == "continuation_other_image":
            prior[92] ^= 1
        tree = T.WorkLog(jobs=dict(up.work_log.jobs))
        initial = tree.commit()
        assumed = [_WorkReceipt(pkg, 2, 5, 5 << 16)]
        updates = _updates_for(pkg, assumed, tree)
        env_prior = r1
    data = G.encode_update_input(gp.image_id(), ULOG, initial,
                                 np.zeros(8, np.uint32), updates,
                                 prior_journal=None if prior is None
                                 else bytes(prior))
    env = E.ExecutorEnv(segment_po2=17).write_slice(data)
    for r in assumed:
        env.add_assumption(r)
    if prior is not None:
        env.add_assumption(env_prior)

    def run():
        session = E.ExecutorImpl(env, G.log_builder_elf()).run()
        journal = session.journal
        return session.exit_code, (
            _journal_fields(U.LogBuilderJournal.decode(journal))
            if session.exit_code == ("Halted", 0) else journal)
    return _outcome(run)


GUEST_CASES = ["honest", "tampered_path", "foreign_log", "nonzero_start",
               "no_receipt", "duplicate_job", "nonempty_initial",
               "continuation", "continuation_forged",
               "continuation_other_image"]


@pytest.mark.parametrize("case", GUEST_CASES)
def test_guest_exit_and_journal_match_jax(case):
    got = _both(lambda pkg: _run_guest(pkg, case))
    assert got["torch"] == got["jax"]
    ok = case in ("honest", "continuation")
    assert (got["torch"][0] == ("Halted", 0)) == ok, got["torch"]


def test_guest_prover_rejections_match_jax():
    """LogBuilderGuestProver.prove of a rejected batch raises WorkError
    in both packages; one batch must share a control root."""
    def run(pkg):
        G, T = _mod(pkg, "povw_guest"), _mod(pkg, "povw_tree")
        gp = G.LogBuilderGuestProver()
        r = _WorkReceipt(pkg, 9, 5, 5 << 16)
        (claim, nmin, nmax, value, path), = _updates_for(pkg, [r])
        bad = (claim, nmin, nmax, value, path[:3] + [bytes(32)] + path[4:])
        tampered = _outcome(lambda: gp.prove(
            log_id=ULOG, initial_commit=T.WorkLog().commit(),
            updates=[bad], work_receipts=[r]))
        r2 = _WorkReceipt(pkg, 10, 1, 1)
        r2.control_root = np.arange(8, dtype=np.uint32)
        mixed = _outcome(lambda: gp.prove(
            log_id=ULOG, initial_commit=T.WorkLog().commit(),
            updates=_updates_for(pkg, [r, r2]), work_receipts=[r, r2]))
        return tampered, mixed
    assert _both(run) == {"jax": ("WorkError", "WorkError"),
                          "torch": ("WorkError", "WorkError")}
