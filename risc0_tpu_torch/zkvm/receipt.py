"""Receipts: segment, composite, succinct and Groth16 containers, the
top-level receipt, and their verification (counterpart of
``risc0_tpu/zkvm/receipt.py``; reference risc0/zkvm/src/receipt.rs and
receipt/{segment,composite,succinct,groth16,merkle}.rs).

Verification runs the port's host verifiers: the STARK verifier under the
receipt's hash suite, and the BN254 pairing check for Groth16.  A fake
(dev-mode) receipt proves nothing and verifies only in a dev-mode context.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .claims import (Assumption, Assumptions, ExitCode, MaybePruned, Output,
                     ReceiptClaim, SystemState, UnionClaim, bytes_digest,
                     receipt_claim_ok)


class VerificationError(Exception):
    pass


DEFAULT_MAX_PO2 = 22  # reference receipt.rs:884


def is_dev_mode() -> bool:
    v = os.environ.get("RISC0_DEV_MODE", "")
    return v.lower() not in ("", "0", "false", "no")


@dataclass
class VerifierContext:
    """reference receipt.rs:888-1008, the parameters of the receipts
    ported here.  `control_root` is the allowed-control-IDs Merkle root a
    succinct receipt must include its control ID in (default: the
    receipt's own); `inner_control_root` is the root the recursion program
    must echo in its output (default: `control_root`), as in
    receipt/succinct.rs:229-260.  A Poseidon254 receipt's program echoes
    the Poseidon2 root of the receipt it wraps (succinct.rs:182)."""

    hashfn: str = "poseidon2"
    max_po2: int = DEFAULT_MAX_PO2
    dev_mode: bool = field(default_factory=is_dev_mode)
    control_root: np.ndarray | None = None
    inner_control_root: np.ndarray | None = None
    # Groth16 verifier parameters (reference receipt/groth16.rs:132-185);
    # None: Groth16ReceiptVerifierParameters.default()
    groth16_params: object | None = None


@dataclass
class FakeReceipt:
    """Dev-mode receipt; proves nothing (reference receipt.rs
    FakeReceipt)."""

    claim: ReceiptClaim

    def verify_integrity(self, ctx: VerifierContext):
        if not ctx.dev_mode:
            raise VerificationError(
                "fake receipt rejected: dev mode is not enabled")

    def claim_digest(self) -> np.ndarray:
        return self.claim.digest()


def _check_hashfn(hashfn: str, ctx: VerifierContext):
    if hashfn != ctx.hashfn:
        raise VerificationError(
            f"hashfn mismatch: seal {hashfn}, ctx {ctx.hashfn}")


@dataclass
class SegmentReceipt:
    """STARK proof of one segment (reference receipt/segment.rs)."""

    seal: np.ndarray
    index: int
    hashfn: str
    claim: ReceiptClaim
    verifier_parameters: np.ndarray | None = None

    def verify_integrity(self, ctx: VerifierContext):
        """Run the rv32im STARK verifier over the seal, then check that the
        claim decoded from the seal's globals is this receipt's claim."""
        from ..circuit.rv32im.claim import decode_claim
        from ..circuit.rv32im.verify import verify_rv32im_seal
        from ..verify.verifier import VerificationError as ZkpError

        _check_hashfn(self.hashfn, ctx)
        try:
            verify_rv32im_seal(self.seal)
        except ZkpError as e:
            raise VerificationError(f"rv32im seal invalid: {e}") from e
        if not np.array_equal(decode_claim(self.seal).digest(),
                              self.claim.digest()):
            raise VerificationError(
                "seal-decoded claim does not match receipt claim")


@dataclass
class CompositeReceipt:
    """Chain of segment receipts + assumption receipts
    (reference receipt/composite.rs)."""

    segments: list
    assumption_receipts: list = field(default_factory=list)

    def claim(self) -> ReceiptClaim:
        first = self.segments[0].claim
        last = self.segments[-1].claim
        # Remove the assumptions from the last claim: verification requires
        # every assumption to carry a verifiable receipt (reference
        # receipt/composite.rs:161-194).
        output = last.output
        if output is not None and hasattr(output, "value") \
                and output.value is not None:
            output = MaybePruned.of(Output(
                output.value.journal, MaybePruned.of(Assumptions([]))))
        return ReceiptClaim(
            pre=first.pre, post=last.post, exit_code=last.exit_code,
            input=first.input, output=output)

    def verify_integrity(self, ctx: VerifierContext):
        # claim chaining: each segment's post state must equal the next pre
        for a, b in zip(self.segments, self.segments[1:]):
            if not np.array_equal(a.claim.post.digest(), b.claim.pre.digest()):
                raise VerificationError("segment claims do not chain")
            if a.claim.exit_code.kind != "SystemSplit":
                raise VerificationError("non-final segment must SystemSplit")
        for seg in self.segments:
            seg.verify_integrity(ctx)
        for ar in self.assumption_receipts:
            ar.verify_integrity(ctx)


def verify_control_inclusion(proof, control_id, root, suite) -> bool:
    """Check a MerkleProof {index, digests} roots `control_id` into `root`
    (reference zkvm/src/receipt/merkle.rs:73-103)."""
    cur = np.asarray(control_id, np.uint32)
    idx = int(proof["index"])
    for sib in proof["digests"]:
        sib = np.asarray(sib, np.uint32)
        cur = suite.hash_pair(sib, cur) if idx & 1 else suite.hash_pair(cur, sib)
        idx >>= 1
    return idx == 0 and np.array_equal(cur, np.asarray(root, np.uint32))


@dataclass
class SuccinctReceipt:
    """Recursion-compressed receipt (reference receipt/succinct.rs:37-88).

    `claim` may be a ReceiptClaim or a MaybePruned digest; only its digest
    is checked against the seal output.  `control_inclusion_proof` is the
    Merkle path of `control_id` into the allowed-control-IDs set root."""

    seal: np.ndarray
    control_id: np.ndarray
    claim: object
    control_root: np.ndarray
    control_inclusion_proof: dict
    hashfn: str = "poseidon2"

    def verify_integrity(self, ctx: VerifierContext):
        """reference receipt/succinct.rs:103-190: decode the output globals
        ([0:16] the Poseidon2 control root at even slots, [16:32] the claim
        digest as SHA halfs) and check them, then verify the recursion-
        circuit STARK, which binds those globals, with the control-ID
        inclusion check as check_code.  The receipt is accepted only if
        every check passes; the cheap ones run first."""
        from .. import field as F
        from ..circuit.recursion.circuit import verify_recursion_seal
        from ..circuit.recursion.prove import read_sha_halfs
        from ..hash.suite import get_suite
        from ..verify.verifier import VerificationError as ZkpError

        _check_hashfn(self.hashfn, ctx)
        suite = get_suite(self.hashfn)
        params_root = (ctx.control_root if ctx.control_root is not None
                       else self.control_root)

        out = F.decode_np(np.asarray(self.seal[:32], np.uint32))
        expect_inner = (ctx.inner_control_root
                        if ctx.inner_control_root is not None else params_root)
        if not np.array_equal(np.asarray(out[0:16:2], np.uint32),
                              np.asarray(expect_inner, np.uint32)):
            raise VerificationError(
                "seal output control root does not match expected "
                "inner control root")
        if not np.array_equal(read_sha_halfs(out[16:32]),
                              self.claim.digest()):
            raise VerificationError(
                "seal output claim digest does not match receipt claim")

        def check_code(_po2, code_root):
            if not np.array_equal(np.asarray(code_root, np.uint32),
                                  np.asarray(self.control_id, np.uint32)):
                raise ZkpError("seal code root != receipt control_id")
            if not verify_control_inclusion(
                    self.control_inclusion_proof, self.control_id,
                    params_root, suite):
                raise ZkpError("control-ID inclusion proof invalid")

        try:
            verify_recursion_seal(self.seal, check_code, suite=suite)
        except ZkpError as e:
            raise VerificationError(f"recursion seal invalid: {e}") from e

    def claim_digest(self) -> np.ndarray:
        return self.claim.digest()


@dataclass
class Groth16ReceiptVerifierParameters:
    """reference receipt/groth16.rs:132-185.  The default is the
    repository's own allowed-control-IDs root and identity_p254 control
    ID (the reference's ALLOWED_CONTROL_ROOT and BN254_IDENTITY_CONTROL_ID
    counterparts) with the ceremony verifying key."""

    control_root: np.ndarray
    bn254_control_id: np.ndarray
    verifying_key: object = None  # groth16.VerifyingKey; None: ceremony key

    @staticmethod
    def default():
        from ..circuit.recursion.predicates import (identity_p254_control_id,
                                                    own_control_ids)

        _ids, root = own_control_ids()
        return Groth16ReceiptVerifierParameters(
            control_root=root, bn254_control_id=identity_p254_control_id())

    def vk(self):
        from ..groth16 import GROTH16_VERIFIER_KEY

        return self.verifying_key or GROTH16_VERIFIER_KEY

    def digest(self) -> np.ndarray:
        from ..groth16.verifier import vk_digest
        from .claims import tagged_struct

        return tagged_struct(
            "risc0.Groth16ReceiptVerifierParameters",
            [self.control_root, self.bn254_control_id, vk_digest(self.vk())],
            [])


@dataclass
class Groth16Receipt:
    """SNARK-wrapped receipt (reference receipt/groth16.rs:39-129): a
    256-byte BN254 Groth16 seal over the public inputs (control root,
    claim digest, BN254 control ID)."""

    seal: bytes
    claim: object  # ReceiptClaim | MaybePruned
    verifier_parameters: np.ndarray

    def verify_integrity(self, ctx: VerifierContext):
        from ..groth16 import Verifier

        params = (ctx.groth16_params
                  or Groth16ReceiptVerifierParameters.default())
        if not np.array_equal(np.asarray(params.digest(), np.uint32),
                              np.asarray(self.verifier_parameters,
                                         np.uint32)):
            raise VerificationError("groth16 verifier parameters mismatch")
        try:
            v = Verifier.from_seal(
                bytes(self.seal), params.control_root, self.claim.digest(),
                params.bn254_control_id, params.vk())
        except ValueError as e:
            raise VerificationError(f"groth16 seal format: {e}") from e
        if not v.verify():
            raise VerificationError("groth16 proof invalid")

    def seal_calldata(self) -> bytes:
        """On-chain seal: the bytes4 verifier selector, then the 256-byte
        proof, as RiscZeroGroth16Verifier.verifyIntegrity expects
        (``groth16/solidity.py``)."""
        from ..groth16.solidity import seal_to_calldata

        return seal_to_calldata(bytes(self.seal), self.verifier_parameters)

    def claim_digest(self) -> np.ndarray:
        return self.claim.digest()


@dataclass
class InnerReceipt:
    """The proof inside a Receipt: kind "composite", "succinct",
    "groth16" or "fake"."""

    kind: str
    value: object

    def claim(self) -> ReceiptClaim:
        if self.kind == "composite":
            return self.value.claim()
        return self.value.claim

    def verify_integrity(self, ctx: VerifierContext):
        self.value.verify_integrity(ctx)


@dataclass
class Receipt:
    """Top-level receipt: inner proof and journal (reference
    receipt.rs:114-330)."""

    inner: InnerReceipt
    journal: bytes

    def claim(self) -> ReceiptClaim:
        return self.inner.claim()

    def verify(self, image_id, ctx: VerifierContext | None = None):
        """Full verification (reference receipt.rs:163-194): verify the
        inner proof, then compare the claim digest with
        ReceiptClaim::ok(image_id, journal), which fixes the pre-state to
        the image ID, exit Halted(0), a zero input digest, a zeroed post
        state, the journal and an empty assumptions list at once."""
        ctx = ctx or VerifierContext()
        self.inner.verify_integrity(ctx)
        claim = self.claim()
        expected = receipt_claim_ok(image_id, bytes_digest(self.journal))
        if not np.array_equal(expected.digest(), claim.digest()):
            raise VerificationError(
                "receipt claim does not match the expected claim for "
                f"image_id/journal (got exit={claim.exit_code}, "
                "expected Halted(0))")

    def verify_integrity(self, ctx: VerifierContext | None = None):
        self.inner.verify_integrity(ctx or VerifierContext())


def union_claim(da, db) -> UnionClaim:
    """The UnionClaim that the union program proves over two assumption
    digests: the lesser, as a tuple of u32 words (the reference's Digest
    Ord), on the left.  recursion_driver.union orders its operands by it."""
    da, db = np.asarray(da, np.uint32), np.asarray(db, np.uint32)
    if tuple(db.tolist()) < tuple(da.tolist()):
        da, db = db, da
    return UnionClaim(left=da, right=db)


def keccak_root_claim(pending_keccaks):
    """Claim digest of the keccak union-MMR root assumption the guest-side
    batcher commits (reference session.rs:239-256 keccak_root_assumption
    and mmr.rs GuestPeak), computed on the host without proving.  Each
    batch's claim is compute_keccak_digest of its inputs; claims merge by
    peaks, in the order of recursion_driver.MerkleMountainAccumulator, as
    the union receipts prove them: each operand is Assumption{claim, the
    allowed-control-IDs root that the keccak lifts and unions carry}.  A
    request's own control_root is not read: it is the root the guest names
    for its assumption of the whole root (the zero digest, the verifier's
    own root), not that of the lifted batches.  The JAX package merges the
    bare claim digests instead, which its union program does not prove:
    the two agree for one batch only (ROADMAP.md queue 3)."""
    if not pending_keccaks:
        return None
    from ..circuit.keccak import compute_keccak_digest
    from ..circuit.recursion.predicates import own_control_ids

    _ids, root = own_control_ids()

    def merge(a, b):
        return union_claim(Assumption(a, root).digest(),
                           Assumption(b, root).digest()).digest()

    peaks: list = []  # (height, claim digest), back = smallest
    for req in pending_keccaks:
        item, height = compute_keccak_digest(req["input"]), 0
        while peaks and peaks[-1][0] == height:
            item = merge(item, peaks.pop()[1])
            height += 1
        peaks.append((height, item))
    acc = peaks[0][1]
    for _h, nxt in peaks[1:]:
        acc = merge(acc, nxt)
    return acc


def session_segment_output(session) -> MaybePruned | None:
    """The output the guest committed, journal and every assumption it
    recorded (proven and unresolved), which the final segment claims
    (reference prover_impl.rs:98-114)."""
    kind, *rest = session.exit_code
    if not ExitCode(kind, rest[0] if rest else 0).is_term:
        return None
    assumptions = Assumptions(
        [MaybePruned.of(a) for a, _receipt in session.assumptions_used])
    return MaybePruned.of(Output.of(session.journal, assumptions))


def session_claim(session) -> ReceiptClaim:
    """The ReceiptClaim this session's final receipt proves (reference
    host/server/session.rs:199-256 Session::claim).  Its output lists only
    the assumptions without a receipt: proven ones are resolved during
    compression, and the keccak batcher's union-root assumption is left
    out when the pending keccak requests reproduce it (the union receipt
    resolves it at prove time)."""
    kind, *rest = session.exit_code
    exit_code = ExitCode(kind, rest[0] if rest else 0)
    output = None
    if exit_code.is_term:
        kroot = keccak_root_claim(getattr(session, "pending_keccaks", []))
        unresolved = [
            MaybePruned.of(a) for a, receipt in session.assumptions_used
            if receipt is None and not (
                kroot is not None
                and np.array_equal(np.asarray(a.claim, np.uint32), kroot))]
        output = MaybePruned.of(Output.of(session.journal,
                                          Assumptions(unresolved)))
    return ReceiptClaim(
        pre=MaybePruned.of(SystemState(0, session.pre_state)),
        post=MaybePruned.of(SystemState(0, session.post_state)),
        exit_code=exit_code,
        input=MaybePruned.from_digest(session.input_digest),
        output=output,
    )


def segment_claim(seg, final: bool, session_exit: ExitCode,
                  output: MaybePruned | None) -> ReceiptClaim:
    """ReceiptClaim for one segment of a session."""
    from .exec import resolve_segment

    seg = resolve_segment(seg)  # FileSegmentRef -> SegmentInfo
    exit_code = session_exit if final else ExitCode("SystemSplit")
    # Halted segments have a zeroed post state root in the decoded claim
    # (reference claim/receipt.rs:168-171).
    post_digest = (np.zeros(8, np.uint32) if exit_code.kind == "Halted"
                   else seg.post_digest)
    return ReceiptClaim(
        pre=MaybePruned.of(SystemState(0, seg.pre_digest)),
        post=MaybePruned.of(SystemState(0, post_digest)),
        exit_code=exit_code,
        input=MaybePruned.from_digest(seg.input_digest),
        output=output if final else None,
    )
