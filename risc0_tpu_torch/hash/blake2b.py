"""Blake2b hash suite, host side (counterpart of ``risc0_tpu/hash/blake2b.py``;
reference risc0/zkp/src/core/hash/blake2b.rs).

Digest = 32-byte Blake2bVar output viewed as 8 u32 LE words.  Element
slices hash their Montgomery u32 words BIG-endian (blake2b.rs:114-127);
the RNG chains `current = blake2b(current || digest)` on mix and draws
u32s big-endian from `blake2b(current)` (blake2b.rs:131-175).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import field as F


def _h(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def digest_words(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, np.uint32).copy()


def hash_pair(a, b) -> np.ndarray:
    raw = _h(np.asarray(a, np.uint32).tobytes() +
             np.asarray(b, np.uint32).tobytes())
    return digest_words(raw)


def hash_elem_slice(elems) -> np.ndarray:
    """Montgomery words big-endian (blake2b.rs hash_elem_slice)."""
    words = np.asarray(elems, np.uint32).ravel()
    return digest_words(_h(words.astype(">u4").tobytes()))


class Blake2bRng:
    """reference blake2b.rs:131-175."""

    def __init__(self):
        self.current = b"\0" * 32

    def mix(self, digest) -> None:
        self.current = _h(
            self.current + np.asarray(digest, np.uint32).tobytes())

    def next_u32(self) -> int:
        nxt = _h(self.current)
        self.current = nxt
        return int.from_bytes(nxt[:4], "big")

    def random_bits(self, bits: int) -> int:
        return ((1 << bits) - 1) & self.next_u32()

    def random_elem(self) -> int:
        # [0, 2^192) % P via 6 u32 draws (baby_bear.rs:110-141), Montgomery
        val = 0
        for _ in range(6):
            val = ((val << 32) + self.next_u32()) % F.P
        return F.s_encode(val)

    def random_ext_elem(self) -> np.ndarray:
        return np.array([self.random_elem() for _ in range(4)], np.uint32)


def hash_rows(matrix) -> np.ndarray:
    """leaves[r] = hash_elem_slice(matrix[:, r]) (reference hal
    CpuHal::hash_rows under the blake2b suite)."""
    m = np.asarray(matrix, np.uint32)
    be = m.astype(">u4")
    return np.stack([digest_words(_h(be[:, r].tobytes()))
                     for r in range(m.shape[1])])


def hash_pairs(left, right) -> np.ndarray:
    lb = np.asarray(left, np.uint32)
    rb = np.asarray(right, np.uint32)
    return np.stack([digest_words(_h(lb[i].tobytes() + rb[i].tobytes()))
                     for i in range(len(lb))])
