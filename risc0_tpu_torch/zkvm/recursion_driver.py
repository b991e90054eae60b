"""Recursion driver: lift rv32im segment and keccak receipts, join,
union and resolve them into one succinct receipt, thread the PoVW work
record through the WorkClaim variants of lift, join and resolve, and
re-prove a receipt under the Poseidon254 suite for the Groth16 wrap
(counterpart of ``risc0_tpu/zkvm/recursion_driver.py``; reference
risc0/zkvm/src/host/recursion/prove/mod.rs:73-392 and
host/server/prove/prover_impl.rs).

The predicate programs and the allowed-control-IDs set are the
repository's own (``circuit/recursion/predicates.py``); the keccak lifts
are the released programs.  Every helper returns a SuccinctReceipt
carrying its full claim, so receipts can be combined further; each runs
on `device`, the card unless the caller names another, and passes `kw`
(rng, eval_chunk) to ``prove_program``.
"""

from __future__ import annotations

import numpy as np

from .. import field as F
from ..circuit.recursion.predicates import (identity_p254_control_id,
                                            load_own_program, own_control_ids)
from ..circuit.recursion.prove import (MerkleGroup, load_keccak_lift,
                                       prove_zkr, read_sha_halfs)
from ..circuit.rv32im.claim import decode_work
from ..convert import card
from .claims import (Assumption, Assumptions, MaybePruned, Output,
                     ReceiptClaim, opt_digest)
from .povw import WorkClaim
from .receipt import SuccinctReceipt, VerificationError, union_claim


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


def identity_p254(inner: SuccinctReceipt, device="cuda",
                  **kw) -> SuccinctReceipt:
    """Poseidon2 SuccinctReceipt -> Poseidon254 SuccinctReceipt, the input
    of the stark-to-snark wrap (reference recursion/prove/mod.rs:355-392),
    proved on `device`.  The identity predicate verifies the inner seal
    in the VM against the Poseidon2 allowed root; the outer proof hashes
    under Poseidon254, with the singleton identity_p254 control ID as its
    allowed set."""
    from ..hash.suite import POSEIDON254

    device = card(device)
    if inner.hashfn != "poseidon2":
        raise VerificationError("identity_p254 requires a poseidon2 inner")
    ids, leaves, root = _allowed()
    tape = _words(root) + _proof_words(MerkleGroup(leaves), inner.control_id)
    tape += _words(inner.seal)
    p254_id = identity_p254_control_id()
    receipt = prove_zkr(load_own_program("identity"), p254_id, [p254_id],
                        tape, claim=inner.claim, suite=POSEIDON254,
                        device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt),
                          inner.claim.digest()):
        raise VerificationError("identity_p254 output claim digest mismatch")
    return receipt


def lift_keccak(keccak_seal, po2: int, device="cuda",
                **kw) -> SuccinctReceipt:
    """Keccak coprocessor seal -> SuccinctReceipt via the released
    keccak_lift_{po2} program (reference host/server/prove/keccak.rs and
    recursion/prove/mod.rs prove_keccak_lift), proved on `device`.  The
    seal is verified on the host first; the receipt's claim is the pruned
    keccak claim digest."""
    from ..circuit.keccak.verify import (keccak_digest_from_globals,
                                         verify_keccak_seal)

    device = card(device)
    claim = keccak_digest_from_globals(verify_keccak_seal(keccak_seal),
                                       montgomery=True)
    # proved against the repository's allowed set (the keccak_lift IDs are
    # members), so the receipt unions and resolves with rv32im receipts
    # under one control root: the program echoes the tape's control root
    # into its output, which union and resolve require to equal theirs
    ids, leaves, root = _allowed()
    tape = _words(root) + _words(keccak_seal)
    for w in _words(claim):
        tape += [w & 0xFFFF, w >> 16]
    tape.append(1 << po2)
    receipt = prove_zkr(load_keccak_lift(po2), ids[f"keccak_lift_{po2}"],
                        leaves, tape, claim=MaybePruned.from_digest(claim),
                        device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), claim):
        raise VerificationError("keccak lift claim digest mismatch")
    return receipt


def prove_keccak_request(request: dict, device="cuda",
                         **kw) -> SuccinctReceipt:
    """A ProveKeccakRequest (api.proto:63-71; the Session.pending_keccaks
    entries: claim_digest, po2, control_root, input) -> SuccinctReceipt:
    the keccak prove and its lift on `device`."""
    from ..circuit.keccak.prove import prove_keccak

    device = card(device)
    po2 = int(request["po2"])
    seal = prove_keccak(request["input"], po2, device=device)
    receipt = lift_keccak(seal, po2, device, **kw)
    want = request["claim_digest"]
    want = (np.frombuffer(bytes(want), np.uint32)
            if isinstance(want, (bytes, bytearray))
            else np.asarray(want, np.uint32))
    if not np.array_equal(receipt_claim_digest(receipt), want):
        raise VerificationError(
            "keccak claim digest mismatch vs guest request")
    return receipt


def _digest_of(v) -> np.ndarray:
    return np.asarray(v if isinstance(v, np.ndarray) else v.digest(),
                      np.uint32)


def _resolve_parts(conditional: SuccinctReceipt, claim: ReceiptClaim,
                   assumption: SuccinctReceipt, work=None):
    """(tape, resolved claim) of resolving the head assumption of `claim`,
    the conditional receipt's ReceiptClaim, which must carry an unpruned
    Output.  The tape is the resolve program's, with the Work record before
    the assumption for the PoVW programs.  The resolved claim keeps the
    rest of the assumptions as a value (reference Assumptions::resolve),
    so the next resolve finds its head; the JAX package prunes the rest to
    its digest and cannot resolve a second assumption (ROADMAP.md queue
    3).  Its digest, which the program proves, is the same."""
    out = claim.output.value if hasattr(claim.output, "value") \
        else claim.output
    if out is None or not out.assumptions.value.items:
        raise VerificationError("conditional receipt has no assumptions")
    items = out.assumptions.value.items
    head = items[0]
    head_claim = _digest_of(head.value.claim if hasattr(head, "value")
                            else head.claim)
    rest = Assumptions(list(items[1:]))
    journal = _digest_of(out.journal)

    ids, leaves, root = _allowed()
    group = MerkleGroup(leaves)
    tape = _words(root)
    tape += _proof_words(group, conditional.control_id)
    tape += _words(conditional.seal)
    for d in (opt_digest(claim.input), claim.pre.digest(),
              claim.post.digest()):
        tape += _words(d)
    tape += list(claim.exit_code.into_pair())
    for d in (journal, head_claim, rest.digest()):
        tape += _words(d)
    if work is not None:
        tape += _work_tape_words(work)
    tape += _proof_words(group, assumption.control_id)
    tape += _words(assumption.seal)

    resolved = ReceiptClaim(
        pre=claim.pre, post=claim.post, exit_code=claim.exit_code,
        input=claim.input,
        output=MaybePruned.of(Output(MaybePruned.from_digest(journal),
                                     MaybePruned.of(rest))))
    return tape, resolved


def resolve(conditional: SuccinctReceipt, assumption: SuccinctReceipt,
            device="cuda", **kw) -> SuccinctReceipt:
    """Remove the head assumption from a conditional receipt's claim
    (reference host/recursion/prove/mod.rs:214-258), proved on `device`.
    The conditional's claim must carry an unpruned Output whose head
    assumption is `assumption`'s claim."""
    device = card(device)
    tape, resolved = _resolve_parts(conditional, conditional.claim,
                                    assumption)
    ids, leaves, _root = _allowed()
    receipt = prove_zkr(load_own_program("resolve"), ids["resolve"], leaves,
                        tape, claim=resolved, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), resolved.digest()):
        raise VerificationError("resolve output claim digest mismatch")
    return receipt


def _assumption_digest(receipt: SuccinctReceipt) -> np.ndarray:
    """Assumption{claim, control_root = the receipt's allowed root}.digest()
    (reference receipt/succinct.rs to_assumption(false))."""
    return Assumption(np.asarray(receipt.claim.digest(), np.uint32),
                      np.asarray(receipt.control_root, np.uint32)).digest()


def union(a: SuccinctReceipt, b: SuccinctReceipt, device="cuda",
          **kw) -> SuccinctReceipt:
    """Two SuccinctReceipts -> one SuccinctReceipt[UnionClaim] (reference
    host/recursion/prove/mod.rs:185-213), proved on `device`.  The operands
    go in the order of their assumption digests in receipt.union_claim."""
    device = card(device)
    da = _assumption_digest(a)
    claim = union_claim(da, _assumption_digest(b))
    left, right = (a, b) if np.array_equal(claim.left, da) else (b, a)

    ids, leaves, root = _allowed()
    group = MerkleGroup(leaves)
    tape = _words(root)
    for r in (left, right):
        tape += _proof_words(group, r.control_id)
        tape += _words(r.seal)
    receipt = prove_zkr(load_own_program("union"), ids["union"], leaves,
                        tape, claim=claim, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), claim.digest()):
        raise VerificationError("union output claim digest mismatch")
    return receipt


class MerkleMountainAccumulator:
    """Accumulate receipts into one union receipt with a log-depth merge
    tree (reference zkvm/src/mmr.rs:22-95).  `merge` defaults to the union
    prover on the card; inject another to test the order of merges."""

    def __init__(self, merge=None):
        self.merge = merge or union
        self.peaks: list = []  # (height, item), back = smallest

    def insert(self, item):
        height = 0
        while self.peaks and self.peaks[-1][0] == height:
            _, other = self.peaks.pop()
            item = self.merge(item, other)
            height += 1
        self.peaks.append((height, item))

    def root(self):
        if not self.peaks:
            raise ValueError("no elements in MMR")
        items = [it for _h, it in self.peaks]
        acc = items[0]
        for nxt in items[1:]:
            acc = self.merge(acc, nxt)
        return acc


def keccak_union_root(pending_keccaks, device="cuda",
                      **kw) -> SuccinctReceipt | None:
    """Prove every pending keccak request on `device` and union-merge the
    receipts into the MMR root receipt that resolves the guest's keccak
    root assumption (reference prover_impl.rs:121-139)."""
    device = card(device)
    if not pending_keccaks:
        return None
    mmr = MerkleMountainAccumulator(
        merge=lambda a, b: union(a, b, device, **kw))
    for req in pending_keccaks:
        mmr.insert(prove_keccak_request(req, device, **kw))
    return mmr.root()


def _as_succinct(receipt):
    """A top-level Receipt -> its inner succinct receipt (reference
    InnerAssumptionReceipt conversion, receipt.rs succinct())."""
    if hasattr(receipt, "inner"):
        if receipt.inner.kind != "succinct":
            raise VerificationError(
                f"cannot resolve with a {receipt.inner.kind} assumption "
                "receipt; compress it to succinct first")
        return receipt.inner.value
    return receipt


def compress_composite(composite, device="cuda", **kw) -> SuccinctReceipt:
    """Lift every segment receipt, left-fold joins, then resolve-fold the
    assumption receipts head first, all on `device` (reference
    prove/mod.rs:337-391 composite_to_succinct)."""
    device = card(device)
    lifted = [lift(sr, device, **kw) for sr in composite.segments]
    acc = lifted[0]
    for nxt in lifted[1:]:
        acc = join(acc, nxt, device, **kw)
    for ar in composite.assumption_receipts:
        acc = resolve(acc, _as_succinct(ar), device, **kw)
    return acc


# ---------------------------------------------------------------------------
# PoVW variants: WorkClaim-wrapped receipts that thread the segment nonces
# through the recursion programs (reference recursion/prove/mod.rs:88-173,
# 255-352)
# ---------------------------------------------------------------------------

def _work_tape_words(work) -> list[int]:
    """nonce_min and nonce_max as 8 raw u32 words each, then value as 2
    raw words (the layout of the JAX package's predicates._read_work)."""
    return (_words(work.nonce_min.to_u32s()) + _words(work.nonce_max.to_u32s())
            + _words(np.frombuffer(int(work.value).to_bytes(8, "little"),
                                   np.uint32)))


def lift_povw(segment_receipt, device="cuda", **kw) -> SuccinctReceipt:
    """rv32im SegmentReceipt -> SuccinctReceipt[WorkClaim] via
    lift_rv32im_povw_{po2} (reference recursion/prove/mod.rs:88-103),
    proved on `device`.  The claim is WorkClaim{segment claim,
    Work{nonce, nonce, cycles}}, the nonce read from the seal's
    povw_nonce globals in the VM."""
    device = card(device)
    seal = np.asarray(segment_receipt.seal, np.uint32)
    po2 = int(seal[91])
    ids, leaves, root = _allowed()
    name = f"lift_rv32im_povw_{po2}"
    if name not in ids:
        raise VerificationError(f"no PoVW lift predicate for po2={po2}")
    wc = WorkClaim(segment_receipt.claim, decode_work(seal))
    receipt = prove_zkr(load_own_program(name), ids[name], leaves,
                        _words(root) + _words(seal), claim=wc, device=device,
                        **kw)
    if not np.array_equal(receipt_claim_digest(receipt), wc.digest()):
        raise VerificationError("lift_povw output claim digest mismatch")
    return receipt


def join_povw(left: SuccinctReceipt, right: SuccinctReceipt, unwrap=False,
              device="cuda", **kw) -> SuccinctReceipt:
    """Join two WorkClaim receipts on `device`: the claims must chain and
    the nonce ranges be contiguous; the work values add up.  With
    `unwrap`, the joined receipt carries the bare ReceiptClaim
    (join_unwrap_povw; reference recursion/prove/mod.rs:137-173)."""
    device = card(device)
    ids, leaves, root = _allowed()
    group = MerkleGroup(leaves)
    name = "join_unwrap_povw" if unwrap else "join_povw"
    tape = _words(root)
    for r in (left, right):
        tape += _proof_words(group, r.control_id)
        tape += _words(r.seal)
        tape += _claim_body_words(r.claim.claim)
        tape += _work_tape_words(r.claim.work)
    lc, rc = left.claim.claim, right.claim.claim
    joined = ReceiptClaim(pre=lc.pre, post=rc.post, exit_code=rc.exit_code,
                          input=lc.input, output=rc.output)
    claim = joined if unwrap else WorkClaim(
        joined, left.claim.work.join(right.claim.work))
    receipt = prove_zkr(load_own_program(name), ids[name], leaves, tape,
                        claim=claim, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), claim.digest()):
        raise VerificationError(f"{name} output claim digest mismatch")
    return receipt


def unwrap_povw(inner: SuccinctReceipt, device="cuda",
                **kw) -> SuccinctReceipt:
    """SuccinctReceipt[WorkClaim] -> SuccinctReceipt[ReceiptClaim] on
    `device`, the work record dropped (reference recursion/prove/
    mod.rs:336-352)."""
    device = card(device)
    ids, leaves, root = _allowed()
    tape = _words(root) + _proof_words(MerkleGroup(leaves), inner.control_id)
    tape += _words(inner.seal)
    tape += _claim_body_words(inner.claim.claim)
    tape += _work_tape_words(inner.claim.work)
    claim = inner.claim.claim
    receipt = prove_zkr(load_own_program("unwrap_povw"), ids["unwrap_povw"],
                        leaves, tape, claim=claim, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), claim.digest()):
        raise VerificationError("unwrap_povw output claim digest mismatch")
    return receipt


def resolve_povw(conditional: SuccinctReceipt, assumption: SuccinctReceipt,
                 unwrap=False, device="cuda", **kw) -> SuccinctReceipt:
    """Resolve the head assumption of a WorkClaim receipt on `device`; the
    work record passes through unchanged, or is dropped with `unwrap`
    (resolve_unwrap_povw; reference recursion/prove/mod.rs:255-332).
    `assumption` is a plain succinct receipt, and the tape is `resolve`'s
    with the work record before the assumption."""
    device = card(device)
    wc = conditional.claim
    tape, resolved = _resolve_parts(conditional, wc.claim, assumption,
                                    wc.work)
    ids, leaves, _root = _allowed()
    name = "resolve_unwrap_povw" if unwrap else "resolve_povw"
    rclaim = resolved if unwrap else WorkClaim(resolved, wc.work)
    receipt = prove_zkr(load_own_program(name), ids[name], leaves, tape,
                        claim=rclaim, device=device, **kw)
    if not np.array_equal(receipt_claim_digest(receipt), rclaim.digest()):
        raise VerificationError(f"{name} output claim digest mismatch")
    return receipt


def compress_composite_povw(composite, device="cuda", **kw):
    """The PoVW compress on `device`: lift_povw every segment, join_povw
    the chain, resolve the assumption receipts head first, and unwrap the
    WorkClaim in the last merge (reference prover_impl povw flow and
    composite_to_succinct_povw).  Returns (the succinct receipt of the
    bare session claim, the total Work)."""
    device = card(device)
    lifted = [lift_povw(sr, device, **kw) for sr in composite.segments]
    assumptions = list(composite.assumption_receipts)
    if len(lifted) == 1 and not assumptions:
        return unwrap_povw(lifted[0], device, **kw), lifted[0].claim.work
    acc = lifted[0]
    for nxt in lifted[1:-1] if not assumptions else lifted[1:]:
        acc = join_povw(acc, nxt, device=device, **kw)
    if not assumptions:
        total = acc.claim.work.join(lifted[-1].claim.work)
        return join_povw(acc, lifted[-1], True, device, **kw), total
    total = acc.claim.work
    for i, ar in enumerate(assumptions):
        acc = resolve_povw(acc, _as_succinct(ar), i == len(assumptions) - 1,
                           device, **kw)
    return acc, total
