"""Keccak accelerator circuit on torch (counterpart of
``risc0_tpu/circuit/keccak``; reference risc0/circuit/keccak).

Proves batches of keccak-f[1600] permutations, binding the input and
output states into a running SHA-256 transcript digest exposed in the
globals (reference keccak/src/lib.rs compute_keccak_digest).
"""

from __future__ import annotations

import numpy as np

from .circuit import load_circuit  # noqa: F401
from .preflight import SHA_INIT, compute_sha_infos, keccak_f
from .prove import prove_keccak  # noqa: F401
from .verify import verify_keccak_seal  # noqa: F401

KECCAK_DEFAULT_PO2 = 17  # reference keccak/src/lib.rs:27
KECCAK_PO2_RANGE = range(14, 19)
KECCAK_PERMUTE_CYCLES = 200  # cycles per preimage (preflight structure)


def compute_keccak_digest(inputs) -> np.ndarray:
    """Host-side prediction of the batch claim digest the keccak circuit
    commits (reference keccak/src/lib.rs:49-92): SHA-256 transcript over
    each input state before and after keccak-f, each state zero-padded to
    32 u64s.  `inputs` is a list of 25-element u64 state lists.  This is
    what the guest-side batcher commits per KECCAK_PROVE flush, so a host
    can build the assumption claim without proving first."""
    words = []
    for state in inputs:
        post = keccak_f(list(state))
        for block in (state, post):  # each zero-padded to 32 u64s
            for x in block:
                words += [int(x) & 0xFFFFFFFF, (int(x) >> 32) & 0xFFFFFFFF]
            words += [0] * 14
    digest = list(SHA_INIT)
    for i in range(0, len(words), 16):
        compute_sha_infos(digest, words[i:i + 16])
    return np.asarray(digest, np.uint32)
