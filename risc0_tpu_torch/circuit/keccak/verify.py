"""Keccak seal verification (counterpart of
``risc0_tpu/circuit/keccak/verify.py``; reference keccak/src/prove/
mod.rs:59-71): the generic STARK verifier with the keccak circuit, on the
host.  The seal has no version word and no code-root check."""

from __future__ import annotations

import numpy as np

from ... import field as F
from ...hash.suite import POSEIDON2
from ...verify import verifier as V
from .circuit import load_circuit
from .witgen import global_meta


def verify_keccak_seal(seal) -> np.ndarray:
    """Verify a keccak seal; returns its 17 global words (Montgomery)."""
    seal = np.asarray(seal, np.uint32)
    return V.verify(load_circuit(), POSEIDON2, seal, lambda po2, root: None)


def keccak_digest_from_globals(out, montgomery=False) -> np.ndarray:
    """Reassemble the final SHA-256 transcript digest from the 16 global
    shorts (reference keccak prove/mod.rs:148-153).  Seal globals read by
    the verifier are Montgomery words: pass montgomery=True to decode."""
    if montgomery:
        out = F.decode_np(np.asarray(out, np.uint32))
    dig = [int(out[c]) for c in global_meta()["final_digest"]]
    return np.array([dig[2 * i] | (dig[2 * i + 1] << 16) for i in range(8)],
                    np.uint32)
