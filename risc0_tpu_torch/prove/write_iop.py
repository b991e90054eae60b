# The port's own copy of risc0_tpu/prove/write_iop.py.
"""Prover-side IOP transcript (reference: risc0/zkp/src/prove/write_iop.rs).

The seal is a flat u32 stream; Fiat-Shamir state advances only on
``commit(digest)``.  Field elements are written as raw Montgomery words
(write_iop.rs:42-54 + Appendix A of SURVEY.md).
"""

from __future__ import annotations

import numpy as np


class WriteIOP:
    def __init__(self, suite):
        self.suite = suite
        self.rng = suite.new_rng()
        self._chunks: list[np.ndarray] = []

    def write_u32s(self, words):
        self._chunks.append(np.ascontiguousarray(np.asarray(words, np.uint32).ravel()))

    # field elems are stored as u32 Montgomery words already
    write_field_elems = write_u32s
    write_digests = write_u32s

    def commit(self, digest):
        self.rng.mix(digest)

    def random_bits(self, bits: int) -> int:
        return self.rng.random_bits(bits)

    def random_elem(self) -> int:
        return self.rng.random_elem()

    def random_ext_elem(self) -> np.ndarray:
        return self.rng.random_ext_elem()

    @property
    def proof(self) -> np.ndarray:
        return (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, np.uint32)
        )
