"""Hash suites and their Fiat-Shamir rngs (host side; counterpart of
``risc0_tpu/hash/suite.py``, reference risc0/zkp/src/core/hash/mod.rs:26-60).

Four suites: "poseidon2", "sha-256", "poseidon254" and "blake2b".  Digests
are numpy (8,) uint32 arrays.  The transcript rng is sequential and tiny,
so it lives on the host.  A suite's bulk Merkle hashing (`hash_rows` of a
(cols, rows) matrix, `hash_pairs` of two digest arrays) runs on the card's
kernels for Poseidon2 (``hal/torch_hal.py``) and on the host for the
others, whose host functions each suite names here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .. import field as F
from . import blake2b as b2
from . import poseidon2 as p2
from . import poseidon254 as p254
from . import sha256 as sha


class Poseidon2Rng:
    """Reference: risc0/zkp/src/core/hash/poseidon2/rng.rs:26-90."""

    def __init__(self):
        self.cells = np.zeros(p2.CELLS, np.uint32)
        self.pool_used = 0

    def mix(self, digest):
        if self.pool_used != 0:
            self.cells = p2.permute_np(self.cells)
            self.pool_used = 0
        d = np.asarray(digest, np.uint32)
        self.cells[: p2.CELLS_OUT] = F.add_np(self.cells[: p2.CELLS_OUT], d)
        self.cells = p2.permute_np(self.cells)

    def random_elem(self) -> int:
        """Returns a Montgomery-form element."""
        if self.pool_used == p2.CELLS_RATE:
            self.cells = p2.permute_np(self.cells)
            self.pool_used = 0
        out = int(self.cells[self.pool_used])
        self.pool_used += 1
        return out

    def random_bits(self, bits: int) -> int:
        # draw 4 elems, keep the first nonzero (rng.rs:66-74); mask the low
        # bits of the standard-form value
        val = F.s_decode(self.random_elem())
        for _ in range(3):
            new_val = F.s_decode(self.random_elem())
            if val == 0:
                val = new_val
        return ((1 << bits) - 1) & val

    def random_ext_elem(self) -> np.ndarray:
        """Returns (4,) uint32 Montgomery."""
        return np.array([self.random_elem() for _ in range(4)], np.uint32)


class ShaRng:
    """Reference: risc0/zkp/src/core/hash/sha/rng.rs:26-103."""

    def __init__(self):
        self.pool0 = sha.hash_bytes(b"Hello")
        self.pool1 = sha.hash_bytes(b"World")
        self.pool_used = 0

    def _step(self):
        self.pool0 = sha.hash_pair(self.pool0, self.pool1)
        self.pool1 = sha.hash_pair(self.pool0, self.pool1)
        self.pool_used = 0

    def mix(self, digest):
        self.pool0 = np.bitwise_xor(self.pool0, np.asarray(digest, np.uint32))
        self._step()

    def next_u32(self) -> int:
        if self.pool_used == 8:
            self._step()
        out = int(self.pool0[self.pool_used])
        self.pool_used += 1
        return out

    def random_bits(self, bits: int) -> int:
        return ((1 << bits) - 1) & self.next_u32()

    def random_elem(self) -> int:
        # [0, 2^192) % P via 6 u32 draws (reference baby_bear.rs:109-141),
        # returned in Montgomery form
        val = 0
        for _ in range(6):
            val = ((val << 32) + self.next_u32()) % F.P
        return F.s_encode(val)

    def random_ext_elem(self) -> np.ndarray:
        return np.array([self.random_elem() for _ in range(4)], np.uint32)


class HashSuite:
    """A suite's hash functions and rng factory.  `hash_rows` and
    `hash_pairs` are its host Merkle functions; Poseidon2 has none here,
    since its trees are hashed on the card (`on_card`)."""

    def __init__(self, name: str, new_rng: Callable, hash_pair: Callable,
                 hash_elem_slice: Callable, hash_rows: Callable | None = None,
                 hash_pairs: Callable | None = None):
        self.name = name
        self.new_rng = new_rng
        self.hash_pair = hash_pair
        # elems: 1-D uint32 Montgomery-form array (ext elems flattened)
        self.hash_elem_slice = hash_elem_slice
        self.hash_rows = hash_rows
        self.hash_pairs = hash_pairs

    @property
    def on_card(self) -> bool:
        """True when the card's kernels hash this suite's Merkle trees and
        its FRI digest; the other suites hash them on the host."""
        return self.hash_rows is None

    def __repr__(self):
        return f"HashSuite({self.name!r})"


POSEIDON2 = HashSuite("poseidon2", Poseidon2Rng, p2.hash_pair_np,
                      p2.unpadded_hash_np)
SHA256 = HashSuite("sha-256", ShaRng, sha.hash_pair, sha.hash_raw_words,
                   sha.hash_rows_np, sha.hash_pairs_np)
POSEIDON254 = HashSuite("poseidon254", p254.Poseidon254Rng, p254.hash_pair,
                        p254.unpadded_hash, p254.hash_rows, p254.hash_pairs)
BLAKE2B = HashSuite("blake2b", b2.Blake2bRng, b2.hash_pair,
                    b2.hash_elem_slice, b2.hash_rows, b2.hash_pairs)

_BY_NAME = {"poseidon2": POSEIDON2, "sha256": SHA256, "sha-256": SHA256,
            "poseidon254": POSEIDON254, "poseidon_254": POSEIDON254,
            "blake2b": BLAKE2B}


def get_suite(name: str) -> HashSuite:
    """The hash suite of a receipt's `hashfn`, by any name the reference
    accepts."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown hash suite {name!r}") from None
