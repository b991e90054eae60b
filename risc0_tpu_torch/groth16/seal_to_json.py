"""Seal-to-JSON for the stark_verify circom witness generator (counterpart of
``risc0_tpu/groth16/seal_to_json.py``).

Mirrors reference risc0/groth16/src/prove/seal_to_json.rs: the
identity_p254 recursion seal is emitted as a JSON `iop` array where each
BabyBear field element becomes its decimal standard-form value and each
digest becomes the decimal BN254 Fr element obtained by reading its 32
bytes little-endian (poseidon_254 digest_to_fr).

The reference ships an autogenerated 25,749-entry type table
(seal_format.rs K_SEAL_TYPES); here the Fp/Digest spans are DERIVED by
replaying the verifier transcript over the seal with a recording ReadIOP
— no table to keep in sync with the circuit.
"""

from __future__ import annotations

import json

import numpy as np

from .. import field as F
from ..hash.poseidon254 import digest_to_fr
from ..verify.verifier import ReadIOP


class _RecordingIOP(ReadIOP):
    """ReadIOP that records (kind, count) for every seal read."""

    spans: list

    def __init__(self, suite, seal):
        super().__init__(suite, seal)
        self.spans = []

    def read_field_elems(self, n: int):
        self.spans.append(("fp", n))
        return super().read_field_elems(n)

    def read_digests(self, n: int):
        self.spans.append(("digest", n))
        # bypass read_field_elems recording: consume words directly
        return ReadIOP.read_u32s(self, n * 8).reshape(n, 8)


def derive_seal_types(seal, suite=None, circuit=None) -> list[str]:
    """Replay the verifier over `seal`, returning one "fp" or "digest"
    entry per transcript element (reference K_SEAL_TYPES).  Defaults to
    the recursion circuit under poseidon254 (identity_p254 receipts)."""
    from ..hash.suite import POSEIDON254
    from ..verify import verifier as V

    suite = suite or POSEIDON254
    if circuit is None:
        from ..circuit.recursion.circuit import load_circuit

        circuit = load_circuit()
    spans: list = []

    class Rec(_RecordingIOP):
        def __init__(self, st, sl):
            super().__init__(st, sl)
            self.spans = spans

    V.verify(circuit, suite, np.asarray(seal, np.uint32),
             lambda po2, root: None, iop_cls=Rec)
    out: list[str] = []
    for kind, n in spans:
        out.extend([kind] * n)
    return out


def to_json(seal, types: list[str] | None = None, suite=None,
            circuit=None) -> str:
    """JSON for the circom stark_verify witness generator (reference
    seal_to_json.rs to_json)."""
    seal = np.asarray(seal, np.uint32)
    if types is None:
        types = derive_seal_types(seal, suite=suite, circuit=circuit)
    values = []
    pos = 0
    for kind in types:
        if kind == "fp":
            values.append(str(F.s_decode(int(seal[pos]))))
            pos += 1
        else:
            values.append(str(digest_to_fr(seal[pos : pos + 8])))
            pos += 8
    if pos != len(seal):
        raise ValueError(f"seal length mismatch: consumed {pos} of "
                         f"{len(seal)} words")
    return json.dumps({"iop": values}, indent=2)
