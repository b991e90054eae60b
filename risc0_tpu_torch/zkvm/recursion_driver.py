"""Recursion driver: lift rv32im segment receipts and join them into one
succinct receipt (counterpart of the lift/join/compress part of
``risc0_tpu/zkvm/recursion_driver.py``; reference risc0/zkvm/src/host/
recursion/prove/mod.rs:73-260 and host/server/prove/prover_impl.rs).

The predicate programs and the allowed-control-IDs set are the
repository's own (``circuit/recursion/predicates.py``).  Every helper
returns a SuccinctReceipt carrying the full ReceiptClaim, so receipts can
be joined further; each runs on `device`, the card unless the caller
names another.  Resolve, union and the keccak lift wait for their
slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np

from .. import field as F
from ..circuit.recursion.predicates import load_own_program, own_control_ids
from ..circuit.recursion.prove import MerkleGroup, prove_zkr, read_sha_halfs
from ..convert import card
from .claims import ReceiptClaim, opt_digest
from .receipt import SuccinctReceipt, VerificationError


def _allowed():
    ids, root = own_control_ids()
    leaves = [ids[k] for k in sorted(ids)]
    return ids, leaves, root


def _words(a) -> list[int]:
    return [int(w) for w in np.asarray(a, np.uint32)]


def _proof_words(group: MerkleGroup, control_id) -> list[int]:
    """[index word] ++ sibling digest words for the in-VM inclusion check."""
    proof = group.get_proof(control_id)
    words = [int(proof["index"])]
    for d in proof["digests"]:
        words += _words(d)
    return words


def _claim_body_words(claim: ReceiptClaim) -> list[int]:
    """input/pre/post/output digests + exit pair: the claim layout of the
    join tape (the JAX package's predicates._read_claim)."""
    words = []
    for d in (opt_digest(claim.input), claim.pre.digest(),
              claim.post.digest(), opt_digest(claim.output)):
        words += _words(d)
    return words + list(claim.exit_code.into_pair())


def receipt_claim_digest(receipt: SuccinctReceipt) -> np.ndarray:
    """Claim digest decoded from the receipt's seal output."""
    out = F.decode_np(np.asarray(receipt.seal[:32], np.uint32))
    return read_sha_halfs(out[16:32])


def lift(segment_receipt, device="cuda", **kw) -> SuccinctReceipt:
    """rv32im SegmentReceipt -> SuccinctReceipt via lift_rv32im_{po2}
    (reference recursion/prove/mod.rs:73-103), proved on `device`; `kw`
    goes to ``prove_program`` (rng, eval_chunk)."""
    device = card(device)
    seal = np.asarray(segment_receipt.seal, np.uint32)
    po2 = int(seal[91])  # [version][90 globals][po2]
    ids, leaves, root = _allowed()
    name = f"lift_rv32im_{po2}"
    if name not in ids:
        raise VerificationError(f"no lift predicate for po2={po2}")
    tape = _words(root) + _words(seal)
    receipt = prove_zkr(load_own_program(name), ids[name], leaves, tape,
                        claim=segment_receipt.claim, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt),
                          segment_receipt.claim.digest()):
        raise VerificationError("lift output claim digest mismatch")
    return receipt


def join(left: SuccinctReceipt, right: SuccinctReceipt, device="cuda",
         **kw) -> SuccinctReceipt:
    """Two chained SuccinctReceipts -> one (reference recursion/prove/
    mod.rs:168-190), proved on `device`.  left/right must carry full
    ReceiptClaims."""
    device = card(device)
    ids, leaves, root = _allowed()
    group = MerkleGroup(leaves)
    tape = _words(root)
    for r in (left, right):
        tape += _proof_words(group, r.control_id)
        tape += _words(r.seal)
        tape += _claim_body_words(r.claim)
    joined = ReceiptClaim(
        pre=left.claim.pre, post=right.claim.post,
        exit_code=right.claim.exit_code,
        input=left.claim.input, output=right.claim.output)
    receipt = prove_zkr(load_own_program("join"), ids["join"], leaves, tape,
                        claim=joined, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), joined.digest()):
        raise VerificationError("join output claim digest mismatch")
    return receipt


def compress_composite(composite, device="cuda", **kw) -> SuccinctReceipt:
    """Lift every segment receipt and left-fold joins on `device`
    (reference prove/mod.rs:337-391 composite_to_succinct).  A composite
    with assumption receipts raises: resolve is not ported yet."""
    device = card(device)
    if composite.assumption_receipts:
        raise NotImplementedError(
            f"composite carries {len(composite.assumption_receipts)} "
            "assumption receipts: resolve is not ported to risc0_tpu_torch "
            "yet (ROADMAP.md queue 1)")
    lifted = [lift(sr, device, **kw) for sr in composite.segments]
    acc = lifted[0]
    for nxt in lifted[1:]:
        acc = join(acc, nxt, device, **kw)
    return acc
