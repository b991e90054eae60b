# The port's own copy of risc0_tpu/zkvm/povw_tree.py.
"""On-chain-compatible PoVW nonce-accounting Merkle trees.

Bit-exact re-implementation of the reference's sparse commitment layout
(risc0/povw/src/tree.rs + consts.rs): a 248-level binary tree over the
full 2^256 nonce space, committed bottom-up from 256-bit leaf bitmaps.

    WorkSet  (height 248 = 88 + 160-bit log id)
      └─ WorkLog (height  88 = 24 +  64-bit job id)
           └─ Job (height  24 = 32-bit index space / 256-bit leaves)

Sparsity makes this tractable: a `Job` stores only `index_max` (nonces
[0, index_max] are used, tree.rs:400-423), so every subtree is either
all-empty, all-full, or on the single boundary path; empty/full subtree
roots at each height are precomputed (consts.rs EMPTY_SUBTREE_ROOTS /
FULL_SUBTREE_ROOTS — our tables reproduce those digests, see
tests/test_povw_tree.py goldens).

Hashing (tree.rs:755-762): node = sha256(left || right), leaf =
sha256(b"POVWLEAF" || bitmap_le_bytes).  This is the layout the
reference's on-chain contract consumes; the host-side nonce reuse guard
lives in povw.WorkLog (zkvm/povw.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

MASK256 = (1 << 256) - 1
_LEAF_TAG = b"POVWLEAF"


def _join(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def _hash_leaf(bitmap: int) -> bytes:
    return hashlib.sha256(_LEAF_TAG + bitmap.to_bytes(32, "little")).digest()


def bitmap_from_range(lo: int, hi: int) -> int:
    """((1 << hi) - 1) << lo, exactly as tree.rs:75-79 (for lo=0, the
    only way it is used: bits 0..hi set, hi exclusive)."""
    return (((1 << hi) - 1) << lo) & MASK256


def _root_tables():
    empty, full = [_hash_leaf(0)], [_hash_leaf(MASK256)]
    for _ in range(WorkSet.TREE_HEIGHT):
        empty.append(_join(empty[-1], empty[-1]))
        full.append(_join(full[-1], full[-1]))
    return empty, full


class TreeError(Exception):
    pass


@dataclass
class Job:
    """Used-nonce range [0, index_max] of one continuation job
    (tree.rs:395-510).  index_max=None is the empty job."""

    TREE_HEIGHT = 32 - 8  # 2^24 leaves of 256 bits each

    index_max: int | None = None

    def is_empty(self) -> bool:
        return self.index_max is None

    def contains(self, index: int) -> bool:
        return self.index_max is not None and index <= self.index_max

    def commit(self) -> bytes:
        return self.subtree_root(self.TREE_HEIGHT, 0)

    def prove_opening(self, index: int) -> "Opening":
        bitmap = self.bitmap_at(index)
        path, index = [], index >> 8
        for i in range(self.TREE_HEIGHT):
            path.append(self.subtree_root(i, index ^ 1))
            index >>= 1
        return Opening(bitmap, path)

    def subtree_root(self, height: int, index: int) -> bytes:
        assert height <= self.TREE_HEIGHT
        assert index < 1 << (self.TREE_HEIGHT - height)
        if height == 0:
            return _hash_leaf(self.bitmap_at(index << 8))
        if self.index_max is None:
            return EMPTY_SUBTREE_ROOTS[height]
        boundary = self.index_max >> (8 + height)
        if index < boundary:
            return FULL_SUBTREE_ROOTS[height]
        if index > boundary:
            return EMPTY_SUBTREE_ROOTS[height]
        return self._boundary_subtree_root(height)

    def _boundary_subtree_root(self, height: int) -> bytes:
        # all leaves left of index_max's leaf are full, right are empty
        index = self.index_max
        node = _hash_leaf(self.bitmap_at(index))
        index >>= 8
        for i in range(height):
            if index & 1:
                node = _join(FULL_SUBTREE_ROOTS[i], node)
            else:
                node = _join(node, EMPTY_SUBTREE_ROOTS[i])
            index >>= 1
        return node

    def bitmap_at(self, index: int) -> int:
        if self.index_max is None:
            return 0
        bi, bi_max = index >> 8, self.index_max >> 8
        if bi < bi_max:
            return MASK256
        if bi > bi_max:
            return 0
        return bitmap_from_range(0, (self.index_max & 0xFF) + 1)


def _sparse_levels(level: dict[int, bytes], lo: int, hi: int) -> bytes:
    """Fold a sparse {index: root} map at height `lo` up to the single
    root at height `hi` (tree.rs:206-229 / 356-372)."""
    for i in range(lo, hi):
        nxt = {}
        for idx in {k >> 1 for k in level}:
            empty = EMPTY_SUBTREE_ROOTS[i]
            nxt[idx] = _join(level.get(idx << 1, empty),
                             level.get((idx << 1) | 1, empty))
        level = nxt
    assert len(level) == 1
    return next(iter(level.values()))


@dataclass
class WorkLog:
    """Jobs of one prover's work log, keyed by 64-bit job number
    (tree.rs:243-393)."""

    TREE_HEIGHT = Job.TREE_HEIGHT + 64

    jobs: dict[int, Job] = field(default_factory=dict)

    def is_empty(self) -> bool:
        return all(j.is_empty() for j in self.jobs.values())

    def add(self, job_id: int, job: Job) -> None:
        if job_id in self.jobs:
            raise TreeError(f"job id {job_id} already in work log")
        self.jobs[job_id] = job

    def prove_add(self, job_id: int, job: Job) -> "SubtreeOpening":
        """Add `job`, returning a non-inclusion proof that its slot was
        previously an empty subtree (tree.rs:276-287)."""
        proof = self.prove_job_opening(job_id)
        self.add(job_id, job)
        return proof

    def contains(self, seq: int) -> bool:
        job = self.jobs.get(seq >> 32)
        return job.contains(seq & 0xFFFFFFFF) if job else False

    def commit(self) -> bytes:
        return self.subtree_root(self.TREE_HEIGHT, 0)

    def prove_opening(self, seq: int) -> "Opening":
        bitmap = self.bitmap_at(seq)
        path, index = [], seq >> 8
        for i in range(self.TREE_HEIGHT):
            path.append(self.subtree_root(i, index ^ 1))
            index >>= 1
        return Opening(bitmap, path)

    def prove_job_opening(self, job_id: int) -> "SubtreeOpening":
        path, index = [], job_id
        for i in range(self.TREE_HEIGHT - Job.TREE_HEIGHT):
            path.append(self.subtree_root(Job.TREE_HEIGHT + i, index ^ 1))
            index >>= 1
        return SubtreeOpening(path, level=Job.TREE_HEIGHT)

    def subtree_root(self, height: int, index: int) -> bytes:
        assert height <= self.TREE_HEIGHT
        assert index < 1 << (self.TREE_HEIGHT - height)
        if height <= Job.TREE_HEIGHT:
            bits = Job.TREE_HEIGHT - height
            job = self.jobs.get(index >> bits, Job())
            return job.subtree_root(height, index & ((1 << bits) - 1))
        off = height - Job.TREE_HEIGHT
        level = {jid: job.commit() for jid, job in self.jobs.items()
                 if jid >> off == index}
        if not level:
            return EMPTY_SUBTREE_ROOTS[height]
        return _sparse_levels(level, Job.TREE_HEIGHT, height)

    def bitmap_at(self, seq: int) -> int:
        job = self.jobs.get(seq >> 32)
        return job.bitmap_at(seq & 0xFFFFFFFF) if job else 0


@dataclass
class WorkSet:
    """All work logs, keyed by 160-bit log id (tree.rs:110-238).  The
    commit is the root the on-chain accounting contract tracks."""

    TREE_HEIGHT = WorkLog.TREE_HEIGHT + 160

    logs: dict[int, WorkLog] = field(default_factory=dict)

    def is_empty(self) -> bool:
        return all(l.is_empty() for l in self.logs.values())

    def add(self, log_id: int, log: WorkLog) -> None:
        if log_id in self.logs:
            raise TreeError(f"log id {log_id:#x} already in work set")
        self.logs[log_id] = log

    def contains(self, nonce: int) -> bool:
        log = self.logs.get(nonce >> 96)
        return log.contains(nonce & ((1 << 96) - 1)) if log else False

    def commit(self) -> bytes:
        return self.subtree_root(self.TREE_HEIGHT, 0)

    def prove_opening(self, nonce: int) -> "Opening":
        bitmap = self.bitmap_at(nonce)
        path, index = [], nonce >> 8
        for i in range(self.TREE_HEIGHT):
            path.append(self.subtree_root(i, index ^ 1))
            index >>= 1
        return Opening(bitmap, path)

    def subtree_root(self, height: int, index: int) -> bytes:
        assert height <= self.TREE_HEIGHT
        assert index < 1 << (self.TREE_HEIGHT - height)
        if height < WorkLog.TREE_HEIGHT:
            bits = WorkLog.TREE_HEIGHT - height
            log = self.logs.get(index >> bits, WorkLog())
            return log.subtree_root(height, index & ((1 << bits) - 1))
        off = height - WorkLog.TREE_HEIGHT
        level = {lid: log.commit() for lid, log in self.logs.items()
                 if lid >> off == index}
        if not level:
            return EMPTY_SUBTREE_ROOTS[height]
        return _sparse_levels(level, WorkLog.TREE_HEIGHT, height)

    def bitmap_at(self, nonce: int) -> int:
        log = self.logs.get(nonce >> 96)
        return log.bitmap_at(nonce & ((1 << 96) - 1)) if log else 0


@dataclass
class Opening:
    """Inclusion/non-inclusion proof of one nonce: leaf bitmap + sibling
    path to the root (tree.rs:591-662)."""

    bitmap: int
    path: list[bytes]

    def verify_inclusion(self, commit: bytes, index: int) -> None:
        if not (self.bitmap >> (index & 0xFF)) & 1:
            raise TreeError("bitmap indicates non-inclusion")
        if self._root(index) != commit:
            raise TreeError("opening path does not match commitment")

    def verify_noninclusion(self, commit: bytes, index: int) -> None:
        if (self.bitmap >> (index & 0xFF)) & 1:
            raise TreeError("bitmap indicates inclusion")
        if self._root(index) != commit:
            raise TreeError("opening path does not match commitment")

    def _root(self, index: int) -> bytes:
        index >>= 8
        node = _hash_leaf(self.bitmap)
        for sib in self.path:
            node = _join(sib, node) if index & 1 else _join(node, sib)
            index >>= 1
        assert index == 0, "index wider than the opening path"
        return node


@dataclass
class SubtreeOpening:
    """Proof that an entire subtree at `level` is empty or full, without
    shipping its leaves (tree.rs:664-752)."""

    path: list[bytes]
    level: int

    def verify_empty(self, commit: bytes, index: int) -> None:
        if self.root(EMPTY_SUBTREE_ROOTS[self.level], index) != commit:
            raise TreeError("subtree opening does not match commitment")

    def verify_full(self, commit: bytes, index: int) -> None:
        if self.root(FULL_SUBTREE_ROOTS[self.level], index) != commit:
            raise TreeError("subtree opening does not match commitment")

    def root(self, subtree_root: bytes, index: int) -> bytes:
        index >>= self.level + 8
        node = subtree_root
        for sib in self.path:
            node = _join(sib, node) if index & 1 else _join(node, sib)
            index >>= 1
        return node


EMPTY_SUBTREE_ROOTS, FULL_SUBTREE_ROOTS = _root_tables()
