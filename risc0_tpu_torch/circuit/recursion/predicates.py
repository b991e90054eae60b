"""The repository's own recursion predicates, as data: the loader half of
``risc0_tpu/circuit/recursion/predicates.py``.

The programs (lift_rv32im_{po2}, join, ...) and their allowed-control-IDs
set were generated with the JAX package's assembler and in-VM verifier
generator (scripts/gen_predicates.py) and are vendored under
``assets.RECURSION_ZKR``; receipts verify against that set's root.  The
generators themselves are not ported.
"""

from __future__ import annotations

import os

import numpy as np

from ...assets import RECURSION_DATA
from .prove import Program, _load_zkr


def load_own_program(name: str) -> Program:
    """Load a vendored predicate by name (e.g. "lift_rv32im_20", "join")."""
    return _load_zkr(name)


def own_control_ids():
    """({name: control_id}, allowed root) of the vendored predicate set."""
    z = np.load(os.path.join(RECURSION_DATA, "own_control_ids.npz"),
                allow_pickle=True)
    ids = {str(n): z["ids"][i] for i, n in enumerate(z["names"])}
    return ids, z["root"]


def identity_p254_control_id():
    """The identity program's code commitment under the Poseidon254 suite
    (reference control_id.rs BN254_IDENTITY_CONTROL_ID), vendored beside
    the Poseidon2 set."""
    z = np.load(os.path.join(RECURSION_DATA, "own_control_ids.npz"),
                allow_pickle=True)
    return z["identity_p254"]
