"""rv32im segment seal verification (counterpart of
``risc0_tpu/circuit/rv32im/verify.py``; reference risc0/circuit/rv32im/src/
lib.rs:78-92): strip the seal version word, then run the generic STARK
verifier with the extracted circuit (taps + poly_ext IR)."""

from __future__ import annotations

import numpy as np

from ...hash.suite import POSEIDON2
from ...verify import verifier as V
from .circuit import load_circuit

RV32IM_SEAL_VERSION = 2  # reference circuit/rv32im/src/lib.rs:42


def verify_rv32im_seal(seal, suite=None) -> np.ndarray:
    """Verify an rv32im segment seal under `suite` (default Poseidon2);
    returns the 90 global words."""
    seal = np.asarray(seal, np.uint32)
    if len(seal) == 0 or seal[0] != RV32IM_SEAL_VERSION:
        raise V.VerificationError("bad rv32im seal version")
    return V.verify(load_circuit(), suite or POSEIDON2, seal[1:],
                    lambda po2, root: None)
