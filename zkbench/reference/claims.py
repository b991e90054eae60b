"""What a seal claims, read and computed plainly: the rv32im globals, the
recursion output, risc0's tagged-struct SHA-256 digests of claims
(risc0 binfmt/src/hash.rs, zkvm/src/claim/receipt.rs), and the allowed
set of recursion programs (a Merkle set of depth 8 under Poseidon2,
risc0 zkvm/src/receipt/merkle.rs).
"""

import hashlib
import os
import struct

import numpy as np

from . import field as F
from .circuits import RECURSION_DATA
from .poseidon2 import hash_pair

ZERO = bytes(32)
ALLOWED_DEPTH = 8

# rv32im globals (risc0 circuit/rv32im LAYOUT_GLOBAL): digests are 8 pairs
# of 16-bit halves, low first
INPUT, IS_TERMINATE, OUTPUT, POVW_NONCE, RNG = 0, 16, 17, 33, 49
STATE_IN, STATE_OUT, TERM_A0_HIGH, TERM_A0_LOW = 54, 70, 86, 87


def halves_digest(shorts) -> bytes:
    """16 values, each a 16-bit half (low, high per word) -> 32 bytes."""
    if any(s >= 1 << 16 for s in shorts):
        raise ValueError("a digest half is above 16 bits")
    return struct.pack("<8I", *(shorts[2 * i] | shorts[2 * i + 1] << 16
                                for i in range(8)))


def tagged_struct(tag: str, down, data) -> bytes:
    h = hashlib.sha256(tag.encode()).digest()
    body = h + b"".join(down) + b"".join(struct.pack("<I", w) for w in data)
    return hashlib.sha256(body + struct.pack("<H", len(down))).digest()


def system_state(pc: int, root: bytes) -> bytes:
    return tagged_struct("risc0.SystemState", [root], [pc])


def output_digest(journal: bytes, assumptions: bytes = ZERO) -> bytes:
    return tagged_struct("risc0.Output",
                         [hashlib.sha256(journal).digest(), assumptions], [])


def receipt_claim(pre: bytes, post: bytes, exit_pair, output: bytes,
                  input_: bytes = ZERO) -> bytes:
    return tagged_struct("risc0.ReceiptClaim", [input_, pre, post, output],
                         list(exit_pair))


def segment_claim(globals_):
    """The claim an rv32im segment seal's globals make: (pre-state root,
    post-state root, input digest, output digest, terminated, exit pair)."""
    def digest(at):
        return halves_digest(globals_[at:at + 16])
    term = globals_[IS_TERMINATE]
    if term not in (0, 1):
        raise ValueError(f"is_terminate is {term}")
    exit_pair = (2, 0)  # SystemSplit
    if term:
        halt, user = globals_[TERM_A0_LOW], globals_[TERM_A0_HIGH]
        if halt not in (0, 1):
            raise ValueError(f"halt type {halt}")
        exit_pair = (halt, user)
    return {"pre": digest(STATE_IN), "post": digest(STATE_OUT),
            "input": digest(INPUT), "output": digest(OUTPUT),
            "terminated": bool(term), "exit": exit_pair,
            "rng": tuple(globals_[RNG:RNG + 4]),
            "povw_nonce": tuple(globals_[POVW_NONCE:POVW_NONCE + 16])}


def segment_receipt_claim(c) -> bytes:
    """The ReceiptClaim digest of one segment's claim (risc0
    claim/receipt.rs decode_from_seal_v2): on Halted the post state's root
    is zero, and a segment that does not terminate has no output."""
    post_root = ZERO if c["exit"][0] == 0 and c["terminated"] else c["post"]
    output = c["output"] if c["terminated"] else ZERO
    return receipt_claim(system_state(0, c["pre"]),
                         system_state(0, post_root), c["exit"], output,
                         c["input"])


def recursion_output(globals_):
    """(control root as 8 words, claim digest) of a recursion seal's 32
    output values."""
    return tuple(globals_[0:16:2]), halves_digest(globals_[16:32])


def allowed_set():
    """({name: control ID as values}, root) of the repository's vendored
    set of recursion programs; the root is rebuilt here from the IDs."""
    z = np.load(os.path.join(RECURSION_DATA, "own_control_ids.npz"))
    ids = {str(n): tuple(F.decode(w) for w in z["ids"][i].tolist())
           for i, n in enumerate(z["names"].tolist())}
    leaves = [tuple(F.decode(w) for w in row) for row in z["ids"].tolist()]

    def root(lo, hi):
        if hi - lo == 1:
            return leaves[lo] if lo < len(leaves) else (0,) * 8
        mid = (lo + hi) // 2
        return hash_pair(root(lo, mid), root(mid, hi))

    built = root(0, 1 << ALLOWED_DEPTH)
    if built != tuple(F.decode(w) for w in z["root"].tolist()):
        raise ValueError("the vendored allowed root is not the root of the "
                         "vendored control IDs")
    return ids, tuple(int(w) for w in z["root"].tolist())
