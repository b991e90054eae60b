# The port's own copy of risc0_tpu/zkvm/claims.py.
"""Claims: tagged-struct hashing, ReceiptClaim, Output, Assumptions.

Mirrors the reference claim algebra (risc0/binfmt/src/{hash,exit_code,
sys_state}.rs and risc0/zkvm/src/claim/receipt.rs).  Digests are numpy (8,)
uint32 words (little-endian byte convention, standard SHA-256).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

ZERO_DIGEST = np.zeros(8, np.uint32)


def _sha(data: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(data).digest(), np.uint32).copy()


def digest_bytes(d) -> bytes:
    return np.asarray(d, np.uint32).tobytes()


def tagged_struct(tag: str, down: list, data: list[int]) -> np.ndarray:
    """reference binfmt/src/hash.rs:52-71"""
    out = hashlib.sha256(tag.encode()).digest()
    for d in down:
        out += digest_bytes(d)
    for word in data:
        out += int(word).to_bytes(4, "little")
    out += len(down).to_bytes(2, "little")
    return _sha(out)


def tagged_list(tag: str, digests: list) -> np.ndarray:
    acc = ZERO_DIGEST
    for d in reversed(digests):
        acc = tagged_struct(tag, [d, acc], [])
    return acc


def bytes_digest(data: bytes) -> np.ndarray:
    """Digestible for [u8] — plain SHA-256."""
    return _sha(bytes(data))


# ---------------------------------------------------------------------------
# Exit codes (reference binfmt/src/exit_code.rs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExitCode:
    kind: str  # Halted | Paused | SystemSplit | SessionLimit
    user_exit: int = 0

    def into_pair(self) -> tuple[int, int]:
        return {
            "Halted": (0, self.user_exit),
            "Paused": (1, self.user_exit),
            "SystemSplit": (2, 0),
            "SessionLimit": (2, 2),
        }[self.kind]

    @staticmethod
    def from_pair(sys_exit: int, user_exit: int) -> "ExitCode":
        if sys_exit == 0:
            return ExitCode("Halted", user_exit)
        if sys_exit == 1:
            return ExitCode("Paused", user_exit)
        if sys_exit == 2:
            return ExitCode("SessionLimit" if user_exit == 2 else "SystemSplit")
        raise ValueError(f"invalid exit code pair ({sys_exit}, {user_exit})")

    @property
    def is_term(self) -> bool:
        return self.kind in ("Halted", "Paused")


# ---------------------------------------------------------------------------
# MaybePruned — value or digest (reference claim/maybe_pruned.rs)
# ---------------------------------------------------------------------------

class MaybePruned:
    def __init__(self, value=None, pruned=None):
        assert (value is None) != (pruned is None)
        self.value = value
        self.pruned = pruned

    @staticmethod
    def of(value) -> "MaybePruned":
        return MaybePruned(value=value)

    @staticmethod
    def from_digest(d) -> "MaybePruned":
        return MaybePruned(pruned=np.asarray(d, np.uint32))

    def digest(self) -> np.ndarray:
        if self.pruned is not None:
            return self.pruned
        if self.value is None:
            return ZERO_DIGEST  # Option::None
        return self.value.digest()

    def __repr__(self):
        if self.pruned is not None:
            return f"Pruned({digest_bytes(self.pruned).hex()[:16]})"
        return f"Value({self.value!r})"


def opt_digest(v) -> np.ndarray:
    """Digestible for Option<T>: None -> zero digest."""
    if v is None:
        return ZERO_DIGEST
    if isinstance(v, MaybePruned):
        return v.digest()
    if isinstance(v, np.ndarray):
        return v
    return v.digest()


# ---------------------------------------------------------------------------
# Claim structures (reference claim/receipt.rs, binfmt/src/sys_state.rs)
# ---------------------------------------------------------------------------

@dataclass
class SystemState:
    pc: int
    merkle_root: np.ndarray

    def digest(self) -> np.ndarray:
        return tagged_struct("risc0.SystemState", [self.merkle_root], [self.pc])


@dataclass
class Assumption:
    claim: np.ndarray
    control_root: np.ndarray

    def digest(self) -> np.ndarray:
        return tagged_struct("risc0.Assumption", [self.claim, self.control_root], [])


@dataclass
class UnionClaim:
    """Claim binding two assumptions into one (reference claim/
    receipt.rs:379-392); `left` is the lesser digest big-endian."""

    left: np.ndarray
    right: np.ndarray

    def digest(self) -> np.ndarray:
        return tagged_struct("risc0.UnionClaim", [self.left, self.right], [])


@dataclass
class Assumptions:
    items: list = field(default_factory=list)  # list[MaybePruned[Assumption]]

    def add(self, assumption):
        self.items.insert(0, assumption)

    def digest(self) -> np.ndarray:
        return tagged_list("risc0.Assumptions", [opt_digest(a) for a in self.items])

    def __len__(self):
        return len(self.items)


@dataclass
class Output:
    journal: MaybePruned      # of bytes (digest via sha)
    assumptions: MaybePruned  # of Assumptions

    @staticmethod
    def of(journal_bytes: bytes, assumptions: Assumptions | None = None) -> "Output":
        j = MaybePruned.from_digest(bytes_digest(journal_bytes))
        j.raw = bytes(journal_bytes)
        a = MaybePruned.of(assumptions or Assumptions())
        return Output(j, a)

    def digest(self) -> np.ndarray:
        return tagged_struct(
            "risc0.Output",
            [self.journal.digest(), self.assumptions.digest()], [])


@dataclass
class ReceiptClaim:
    """reference claim/receipt.rs:326-341"""

    pre: MaybePruned   # SystemState (for rv32im v2: pruned image digest)
    post: MaybePruned
    exit_code: ExitCode
    input: MaybePruned | None = None
    output: MaybePruned | None = None

    def digest(self) -> np.ndarray:
        sys_exit, user_exit = self.exit_code.into_pair()
        return tagged_struct(
            "risc0.ReceiptClaim",
            [
                opt_digest(self.input),
                self.pre.digest(),
                self.post.digest(),
                opt_digest(self.output),
            ],
            [sys_exit, user_exit],
        )


def receipt_claim_ok(image_id, journal_digest) -> "ReceiptClaim":
    """The claim of a successful (Halted(0), unconditional) execution
    (reference claim/receipt.rs:77-95 ReceiptClaim::ok): pre is the pruned
    image ID, post is SystemState{pc: 0, merkle_root: ZERO}, input is the
    zero digest, and the output carries the journal digest with an empty
    (zero-digest) assumptions list."""
    out = Output(
        journal=MaybePruned.from_digest(np.asarray(journal_digest, np.uint32)),
        assumptions=MaybePruned.from_digest(ZERO_DIGEST),
    )
    return ReceiptClaim(
        pre=MaybePruned.from_digest(np.asarray(image_id, np.uint32)),
        post=MaybePruned.of(SystemState(0, ZERO_DIGEST)),
        exit_code=ExitCode("Halted", 0),
        input=None,
        output=MaybePruned.of(out),
    )


