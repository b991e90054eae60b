"""Keccak batch proving on torch (counterpart of
``risc0_tpu/circuit/keccak/prove.py``; reference keccak/src/prove/
mod.rs:100-182).

Seal flow: proof-system and circuit info commits, globals||po2 header,
code and data commits on `device`, Fiat-Shamir mix, the all-zero
one-column accum commit, then the generic DEEP-ALI/FRI finalize.  No seal
version word, and no randomness: the seal is a function of the inputs.
The witness is generated on the host (``witgen.py``); the constraint
polynomial is evaluated on `device` by the range-plan evaluator
(``circuit/ir_range.py``), which gives the same words as the JAX
package's numpy plan.
"""

from __future__ import annotations

import numpy as np

from ... import field as F
from ...convert import card
from ...hash.suite import POSEIDON2
from ...prove.prover import Prover
from ...taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                     REGISTER_GROUP_DATA)
from ..ir_range import RangePlanHal
from ..rv32im.prove import open_seal
from .circuit import load_circuit
from .witgen import REGCOUNT_ACCUM, REGCOUNT_MIX, witgen_keccak

# eval_check rows per chunk on an 80 GB card: the keccak plan collapses
# to 85 op groups whose register files take 30,298 x T x 4 B + 65 x T x
# 16 B = 8.0 GB at T = 2^16, and 8 chunks cover the po2 17 domain
EVAL_CHUNK = 1 << 16


def prove_keccak(inputs, po2, device="cuda", eval_chunk: int = EVAL_CHUNK):
    """Prove a batch of keccak-f permutations on `device` (the card unless
    the caller names another); returns the seal (u32)."""
    device = card(device)
    suite = POSEIDON2
    circuit = load_circuit()
    res = witgen_keccak(inputs, po2)
    cycles = res["rows"]

    global_m = F.encode_np(res["global"])
    prover = Prover(suite, circuit.taps, device)
    open_seal(prover, suite, circuit.CIRCUIT_INFO, global_m, po2)

    prover.commit_group(REGISTER_GROUP_CODE, np.zeros((1, cycles), np.uint32))
    prover.commit_group(REGISTER_GROUP_DATA, res["data"], encode=True)
    mix_m = np.array([prover.iop.random_elem()
                      for _ in range(REGCOUNT_MIX)], np.uint32)
    prover.commit_group(REGISTER_GROUP_ACCUM,
                        np.zeros((REGCOUNT_ACCUM, cycles), np.uint32))
    return prover.finalize([mix_m, global_m],
                           RangePlanHal(circuit, chunk=eval_chunk))
