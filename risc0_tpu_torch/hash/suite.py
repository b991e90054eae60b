"""The Poseidon2 hash suite and its Fiat-Shamir rng (host side; counterpart
of the Poseidon2 half of ``risc0_tpu/hash/suite.py``).  Digests are numpy
(8,) uint32 arrays.  The SHA-256, Poseidon254 and Blake2b suites are not
ported yet: ``get_suite`` names them and raises, and never hands back
another suite in their place."""

from __future__ import annotations

import numpy as np

from .. import field as F
from . import poseidon2 as p2


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


class Poseidon2Suite:
    """Hash functions + rng factory of the Poseidon2 suite."""

    name = "poseidon2"

    def new_rng(self):
        return Poseidon2Rng()

    def hash_pair(self, a, b) -> np.ndarray:
        return p2.hash_pair_np(a, b)

    def hash_elem_slice(self, elems) -> np.ndarray:
        """elems: 1-D uint32 Montgomery-form array (ext elems flattened)."""
        return p2.unpadded_hash_np(elems)


POSEIDON2 = Poseidon2Suite()


# the reference's other suites; ROADMAP.md queue 1 ports them
_NOT_PORTED = ("sha256", "sha-256", "poseidon254", "poseidon_254", "blake2b")


def get_suite(name: str) -> Poseidon2Suite:
    """The hash suite of a receipt's `hashfn`."""
    if name == POSEIDON2.name:
        return POSEIDON2
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"hash suite {name!r} is not ported to risc0_tpu_torch yet "
            "(ROADMAP.md queue 1: the SHA-256, Poseidon254 and Blake2b "
            "suites); only 'poseidon2' is")
    raise ValueError(f"unknown hash suite {name!r}")
