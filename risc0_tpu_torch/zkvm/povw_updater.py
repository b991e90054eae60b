# The port's own copy of risc0_tpu/zkvm/povw_updater.py, with `device`.
"""Work-log update prover — the host driver around the PoVW Log Builder.

Mirrors the reference's `WorkLogUpdateProver` (risc0/povw/src/prover.rs:
34-242) and the Log Builder guest contract (povw/src/guest.rs): each
update round takes WorkClaim receipts, adds one `Job` per claim to the
prover's on-chain work-log tree with a non-inclusion proof that the job
slot was empty, and commits a `LogBuilderJournal` binding
(initial_commit -> updated_commit, summed work value) for the on-chain
accounting contract.

The reference runs these checks inside a prebuilt Rust guest
(risc0-povw-log-builder.bin) so the state transition itself is proven.
Here the default `journal_prover` is the framework's OWN log-builder
guest (zkvm/povw_guest.py, assembled rv32im): the whole transition —
WorkClaim digests, assumption verification, non-inclusion proofs, tree
insertion, journal — re-runs inside the zkVM and the journal is what the
guest committed; `prove_update` cross-checks it against the host-side
`apply_update` replay.  Pass `LogBuilderGuestProver(prover=...)` to get
a cryptographic receipt over the guest session, or any plain callable
`(journal_bytes, image_id) -> receipt` to stub it (scheduler tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .claims import bytes_digest, receipt_claim_ok
from .povw import WorkClaim, WorkError
from .povw_tree import Job, SubtreeOpening, WorkLog


@dataclass
class WorkLogUpdate:
    """One claim + proof that its job slot was unused
    (guest.rs:100-125)."""

    claim: WorkClaim
    noninclusion_proof: SubtreeOpening


@dataclass
class LogBuilderJournal:
    """Journal the Log Builder commits (guest.rs:127-171)."""

    work_log_id: int
    initial_commit: bytes
    updated_commit: bytes
    update_value: int
    self_image_id: np.ndarray

    def encode(self) -> bytes:
        return (self.work_log_id.to_bytes(20, "little")
                + self.initial_commit + self.updated_commit
                + self.update_value.to_bytes(8, "little")
                + np.asarray(self.self_image_id, np.uint32).tobytes())

    @staticmethod
    def decode(buf: bytes) -> "LogBuilderJournal":
        if len(buf) != 20 + 32 + 32 + 8 + 32:
            raise ValueError("bad LogBuilderJournal length")
        return LogBuilderJournal(
            work_log_id=int.from_bytes(buf[:20], "little"),
            initial_commit=buf[20:52],
            updated_commit=buf[52:84],
            update_value=int.from_bytes(buf[84:92], "little"),
            self_image_id=np.frombuffer(buf[92:124], np.uint32).copy(),
        )


def apply_update(commit: bytes, update: WorkLogUpdate) -> tuple[bytes, int]:
    """The Log Builder guest's per-update state transition: check the
    non-inclusion proof against the current commitment, then recompute
    the commitment with the job's full boundary subtree in place
    (prover.rs:163-205 validations + the in-guest root update).

    Returns (new_commit, work_value)."""
    work = update.claim.work
    if isinstance(work, np.ndarray):
        raise WorkError("work claim work is pruned")
    nmin, nmax = work.nonce_min, work.nonce_max
    if nmin.log != nmax.log:
        raise WorkError("nonce range spans work logs")
    if nmin.job != nmax.job:
        raise WorkError("nonce range spans jobs")
    if nmin.segment != 0:
        raise WorkError("work claim nonce range must start at segment 0")
    seq = nmin.job << 32
    update.noninclusion_proof.verify_empty(commit, seq)
    job_root = Job(nmax.segment).commit()
    new_commit = update.noninclusion_proof.root(job_root, seq)
    return new_commit, work.value


@dataclass
class WorkLogUpdateProver:
    """Stateful update driver (prover.rs:34-242): owns the work-log tree,
    proves each batch of WorkClaim receipts into a journal receipt, and
    chains updates through `continuation`."""

    log_id: int
    work_log: WorkLog = field(default_factory=WorkLog)
    image_id: np.ndarray = field(
        default_factory=lambda: np.zeros(8, np.uint32))
    journal_prover: object = None   # callable(journal_bytes, image_id)
    continuation: tuple | None = None   # (LogBuilderJournal, Receipt)
    verifier_ctx: object = None   # VerifierContext for work receipts
    # where the default journal prover proves the guest session: the
    # card unless the caller names another
    device: object = "cuda"

    def _verify_work_receipt(self, receipt):
        """Cryptographically verify one work receipt before consuming it —
        the reference adds each receipt as a guest assumption and the
        log-builder guest calls env::verify_assumption per claim
        (povw/src/guest.rs); skipping this would let a forged WorkClaim
        commit value into the journal."""
        from .receipt import VerificationError, VerifierContext

        ctx = self.verifier_ctx or VerifierContext()
        verify = getattr(receipt, "verify_integrity", None)
        if verify is None:
            if not ctx.dev_mode:
                raise WorkError(
                    "work receipt carries no proof (dev mode not enabled)")
            return
        try:
            verify(ctx)
        except VerificationError as e:
            raise WorkError(f"work receipt failed verification: {e}") from e

    def prove_update(self, work_receipts):
        """Add each receipt's job to the work log and produce the update
        receipt. Work receipts must carry non-pruned WorkClaims whose
        nonce ranges live in this prover's log (prove_update
        validations, prover.rs:142-205).  All per-claim validations run
        BEFORE the first work-log mutation (reference prover.rs:186-197
        ordering) so a rejected claim cannot leave its job inserted."""
        from .receipt import FakeReceipt, InnerReceipt, Receipt

        if not self.work_log.is_empty() and self.continuation is None:
            raise WorkError(
                "missing continuation information with non-empty work log")
        initial_commit = self.work_log.commit()

        claims = []
        for receipt in work_receipts:
            wc = receipt.claim
            if not isinstance(wc, WorkClaim):
                raise WorkError("receipt does not carry a WorkClaim")
            work = wc.work
            if isinstance(work, np.ndarray):
                raise WorkError("work receipt claim work is pruned")
            nmin, nmax = work.nonce_min, work.nonce_max
            if nmin.log != self.log_id or nmax.log != self.log_id:
                raise WorkError(
                    f"work claim log id {nmin.log:#x} is not "
                    f"this prover's log {self.log_id:#x}")
            if nmin.job != nmax.job:
                raise WorkError("nonce range spans jobs")
            if nmin.segment != 0:
                raise WorkError(
                    "work claim nonce range must start at segment 0")
            if any(nmin.job == c[1].work.nonce_min.job for c in claims):
                raise WorkError(
                    f"job id {nmin.job:#x} appears twice in one update")
            self._verify_work_receipt(receipt)
            claims.append((receipt, wc))

        commit, total = initial_commit, 0
        snapshot = dict(self.work_log.jobs)
        guest_updates = []
        try:
            for _receipt, wc in claims:
                work = wc.work
                job_number = work.nonce_min.job
                proof = self.work_log.prove_add(
                    job_number, Job(work.nonce_max.segment))
                guest_updates.append((
                    wc._digest_of(wc.claim).tobytes(),
                    work.nonce_min.to_bytes(), work.nonce_max.to_bytes(),
                    work.value, proof.path))
                commit, value = apply_update(
                    commit, WorkLogUpdate(wc, proof))
                total += value
        except Exception:
            # restore the tree so a failed batch leaves no partial insert
            self.work_log.jobs = snapshot
            raise
        if commit != self.work_log.commit():
            raise WorkError("update commitment mismatch")  # unreachable

        if self.journal_prover is None:
            # default = the in-zkVM log builder (reference parity: the
            # update transition is always run in the guest; pass an
            # explicit callable to override, e.g. for scheduler stubs).
            # Outside dev mode the guest session is PROVEN — the journal
            # receipt is cryptographic end-to-end (reference
            # povw/src/prover.rs:207-231 always proves); RISC0_DEV_MODE
            # keeps the executed-session FakeReceipt for fast tests.
            from .povw_guest import LogBuilderGuestProver
            from .receipt import is_dev_mode

            dev = is_dev_mode() or getattr(self.verifier_ctx, "dev_mode",
                                           False)
            prover = None
            if not dev:
                from .prover import ProverImpl

                prover = ProverImpl(device=self.device)
            self.journal_prover = LogBuilderGuestProver(prover=prover)
        if getattr(self.journal_prover, "is_guest_prover", False):
            # in-zkVM log builder: the guest re-runs the whole transition
            # (claim digests, assumption verification, non-inclusion
            # proofs, tree update) and journals the result itself.
            # The tree mutation above must be rolled back if the guest
            # prove (or its cross-check) fails — otherwise the inserted
            # jobs have no journal/receipt and every later prove_update
            # hits the commitment-mismatch error with the prover wedged.
            prior_image_id = self.image_id
            try:
                self.image_id = np.asarray(self.journal_prover.image_id(),
                                           np.uint32)
                cont = None
                if self.continuation is not None:
                    prior_journal, prior_receipt = self.continuation
                    cont = (prior_journal.encode(), prior_receipt)
                receipt = self.journal_prover.prove(
                    log_id=self.log_id, initial_commit=initial_commit,
                    updates=guest_updates,
                    work_receipts=[r for r, _ in claims],
                    continuation=cont)
                journal = LogBuilderJournal.decode(receipt.journal)
                if (journal.updated_commit != commit
                        or journal.update_value != total
                        or journal.initial_commit != initial_commit):
                    raise WorkError(
                        "guest journal disagrees with the host transition")
            except Exception:
                # leave the prover object fully unchanged: a retry with a
                # different journal_prover must not keep a stale image id
                self.work_log.jobs = snapshot
                self.image_id = prior_image_id
                raise
            self.continuation = (journal, receipt)
            return journal, receipt

        journal = LogBuilderJournal(
            work_log_id=self.log_id,
            initial_commit=initial_commit,
            updated_commit=commit,
            update_value=total,
            self_image_id=self.image_id,
        )
        data = journal.encode()
        if self.journal_prover is not None:
            try:
                receipt = self.journal_prover(data, self.image_id)
            except Exception:
                self.work_log.jobs = snapshot
                raise
        else:
            claim = receipt_claim_ok(self.image_id, bytes_digest(data))
            receipt = Receipt(inner=InnerReceipt("fake", FakeReceipt(claim)),
                              journal=data)
        self.continuation = (journal, receipt)
        return journal, receipt
