# The port's own copy of risc0_tpu/zkvm/povw.py.
"""Proof of Verifiable Work (PoVW) types and work-log tracking.

Mirrors reference risc0/binfmt/src/povw.rs (PovwLogId / PovwJobId /
PovwNonce and their little-endian byte/u16 encodings),
risc0/zkvm/src/claim/work.rs (Work / WorkClaim with tagged digests and
contiguous-range join), and the nonce-tracking work log of
risc0/povw/src/tree.rs (per-job 256-bit bitmaps guarding against
double-counting).

Nonce layout (povw.rs:164-167): u256 = log << 96 | job << 32 | segment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .claims import tagged_struct

LOG_BITS, JOB_BITS, SEGMENT_BITS = 160, 64, 32


@dataclass(frozen=True)
class PovwJobId:
    """Globally unique proving-job id: work log (160-bit) + job number
    (binfmt/src/povw.rs:45-95)."""

    log: int = 0
    job: int = 0

    def nonce(self, segment_index: int) -> "PovwNonce":
        return PovwNonce(self.log, self.job, segment_index)

    def to_bytes(self) -> bytes:
        return self.job.to_bytes(8, "little") + self.log.to_bytes(
            20, "little")

    @staticmethod
    def from_bytes(b: bytes) -> "PovwJobId":
        return PovwJobId(job=int.from_bytes(b[:8], "little"),
                         log=int.from_bytes(b[8:28], "little"))


@dataclass(frozen=True)
class PovwNonce:
    """256-bit unique nonce for one segment proof
    (binfmt/src/povw.rs:119-250)."""

    log: int = 0
    job: int = 0
    segment: int = 0

    def to_u256(self) -> int:
        return (self.log << 96) | (self.job << 32) | self.segment

    @staticmethod
    def from_u256(v: int) -> "PovwNonce":
        return PovwNonce(log=v >> 96, job=(v >> 32) & ((1 << 64) - 1),
                         segment=v & 0xFFFFFFFF)

    def to_bytes(self) -> bytes:
        return self.to_u256().to_bytes(32, "little")

    def to_u32s(self) -> np.ndarray:
        return np.frombuffer(self.to_bytes(), np.uint32).copy()

    def to_u16s(self) -> np.ndarray:
        return np.frombuffer(self.to_bytes(), np.uint16).copy()

    @staticmethod
    def from_u16s(h) -> "PovwNonce":
        b = np.asarray(h, np.uint16).tobytes()
        return PovwNonce.from_u256(int.from_bytes(b, "little"))

    def encode_to_seal(self, buf: list) -> None:
        buf.extend(int(h) for h in self.to_u16s())

    @staticmethod
    def decode_from_seal(buf: list) -> "PovwNonce":
        halfs = [buf.pop(0) for _ in range(16)]
        if any(h > 0xFFFF for h in halfs):
            raise ValueError("nonce half out of range")
        return PovwNonce.from_u16s(halfs)


PovwNonce.ZERO = PovwNonce(0, 0, 0)


class WorkError(Exception):
    pass


@dataclass
class Work:
    """Compact completed-work record: inclusive nonce range + value
    (claim/work.rs:101-170)."""

    nonce_min: PovwNonce
    nonce_max: PovwNonce
    value: int

    def join(self, other: "Work") -> "Work":
        """Ranges must be contiguous (self.max + 1 == other.min), matching
        the join_povw recursion-program check."""
        if self.nonce_max.to_u256() + 1 != other.nonce_min.to_u256():
            raise WorkError(
                f"work nonce ranges are not contiguous: "
                f"{self.nonce_max} then {other.nonce_min}")
        return Work(self.nonce_min, other.nonce_max,
                    self.value + other.value)

    def encode_to_seal(self, buf: list) -> None:
        self.nonce_min.encode_to_seal(buf)
        self.nonce_max.encode_to_seal(buf)
        buf.extend(int(h) for h in np.frombuffer(
            int(self.value).to_bytes(8, "little"), np.uint16))

    @staticmethod
    def decode_from_seal(buf: list) -> "Work":
        nmin = PovwNonce.decode_from_seal(buf)
        nmax = PovwNonce.decode_from_seal(buf)
        halfs = [buf.pop(0) for _ in range(4)]
        value = int.from_bytes(np.array(halfs, np.uint16).tobytes(),
                               "little")
        return Work(nmin, nmax, value)

    def digest(self) -> np.ndarray:
        buf: list = []
        self.encode_to_seal(buf)
        return tagged_struct("risc0.Work", [], buf)


@dataclass
class WorkClaim:
    """Claim + work wrapper, digest tag "risc0.WorkClaim"
    (claim/work.rs:33-67).  `claim` is anything Digestible (ReceiptClaim
    or a pruned digest); `work` a Work or pruned digest."""

    claim: object
    work: object

    def _digest_of(self, v) -> np.ndarray:
        return np.asarray(v if isinstance(v, np.ndarray) else v.digest(),
                          np.uint32)

    def digest(self) -> np.ndarray:
        return tagged_struct("risc0.WorkClaim",
                             [self._digest_of(self.claim),
                              self._digest_of(self.work)], [])

    def join(self, other: "WorkClaim") -> "WorkClaim":
        """ReceiptClaim join + contiguous Work join
        (claim/receipt.rs:266-287)."""
        from .claims import ReceiptClaim

        if isinstance(self.claim, np.ndarray) or isinstance(
                other.claim, np.ndarray):
            raise WorkError("cannot join pruned work claims")
        joined = ReceiptClaim(
            pre=self.claim.pre, post=other.claim.post,
            exit_code=other.claim.exit_code, input=self.claim.input,
            output=other.claim.output)
        return WorkClaim(joined, self.work.join(other.work))


class WorkLog:
    """Tracks used nonces per job with 256-bit bitmaps and rejects
    double-counting (reference povw/src/tree.rs Bitmap + WorkLog).  The
    commit digest folds sorted (job -> bitmap) leaves with the same
    tagged-struct hashing the claims use — a fast framework-level
    commitment.  For the reference's fixed-depth on-chain layout
    (sparse 248-level tree, inclusion/non-inclusion openings) use
    povw_tree.WorkSet/WorkLog/Job; `to_tree()` converts when every job
    range starts at segment 0."""

    def __init__(self, log_id: int = 0):
        self.log_id = log_id
        self.jobs: dict[int, int] = {}  # job -> used-segment bitmap (int)

    def record(self, work: Work) -> None:
        """Mark [nonce_min, nonce_max] used; raises on reuse or on a range
        outside this work log."""
        lo, hi = work.nonce_min, work.nonce_max
        if lo.log != self.log_id or hi.log != self.log_id:
            raise WorkError("nonce range belongs to a different work log")
        if lo.to_u256() > hi.to_u256():
            raise WorkError("empty nonce range")
        if lo.job != hi.job:
            raise WorkError("nonce range spans multiple jobs")
        mask = ((1 << (hi.segment - lo.segment + 1)) - 1) << lo.segment
        used = self.jobs.get(lo.job, 0)
        if used & mask:
            raise WorkError(f"nonce reuse in job {lo.job}")
        self.jobs[lo.job] = used | mask

    def contains(self, nonce: PovwNonce) -> bool:
        return bool(self.jobs.get(nonce.job, 0) >> nonce.segment & 1)

    def to_tree(self):
        """This log as an on-chain-layout povw_tree.WorkLog.  The tree's
        Job stores only [0, index_max] (tree.rs:400-423), so every job's
        used bitmap must be contiguous from segment 0 — which is how
        session proving consumes nonces (session_work)."""
        from .povw_tree import Job as TreeJob
        from .povw_tree import WorkLog as TreeWorkLog

        out = TreeWorkLog()
        for job, bits in self.jobs.items():
            index_max = bits.bit_length() - 1
            if bits != (1 << (index_max + 1)) - 1:
                raise WorkError(
                    f"job {job} bitmap is not contiguous from 0; "
                    "no on-chain Job representation")
            out.add(job, TreeJob(index_max))
        return out

    def commit(self) -> np.ndarray:
        leaves = []
        for job in sorted(self.jobs):
            bits = self.jobs[job]
            nbytes = max(32, -(-((bits.bit_length() + 7) // 8) // 32) * 32)
            raw = bits.to_bytes(nbytes, "little")
            for g in range(nbytes // 32):
                chunk = raw[g * 32 : (g + 1) * 32]
                if g and chunk == b"\0" * 32:
                    continue  # sparse: skip empty 256-nonce groups
                leaves.append(tagged_struct(
                    "risc0.WorkLogLeaf", [np.frombuffer(chunk, np.uint32)],
                    [job & 0xFFFFFFFF, (job >> 32) & 0xFFFFFFFF, g]))
        log_words = [int(w) for w in np.frombuffer(
            self.log_id.to_bytes(20, "little"), np.uint32)]
        return tagged_struct("risc0.WorkLog", leaves, log_words)


def session_work(session, job: PovwJobId) -> Work:
    """Work for a whole session: one nonce per segment, value = proved
    cycles (reference prover_impl.rs povw path: nonce(i) per segment,
    joined into one contiguous range)."""
    works = [Work(job.nonce(seg.index), job.nonce(seg.index), 1 << seg.po2)
             for seg in session.segments]
    acc = works[0]
    for w in works[1:]:
        acc = acc.join(w)
    return acc
