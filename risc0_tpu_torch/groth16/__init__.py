"""Groth16 over BN254: verification, seal formats and the in-process
stark-to-snark prover (counterpart of ``risc0_tpu/groth16``; reference
risc0/groth16/src/{lib,types,verifier}.rs and prove/).

The verifying key constants are the public risc0-ethereum
Groth16Verifier.sol ceremony values (verifier.rs:34-75).  Everything here
runs on the host: Python big-int pairing checks, and the host C++ of
csrc/bn254.cpp for the prover's MSMs and NTTs.
"""

from .verifier import (GROTH16_VERIFIER_KEY, Verifier, VerifyingKey,
                       digest_as_fr_pair, fr_digest, split_digest,
                       verifying_key_from_json)

__all__ = [
    "Verifier", "VerifyingKey", "GROTH16_VERIFIER_KEY", "split_digest",
    "digest_as_fr_pair", "fr_digest", "verifying_key_from_json",
]
