"""Paths of the repository's non-Python assets that the port reads.

They are data, not code: the extracted circuit tables and witgen programs,
the recursion programs (zkr) and control IDs, the Poseidon254 constants,
the v1compat kernel ELF, the released bigint2 programs, and the C++
executor's sources (built into ``csrc/libr0vm.so``).  They live beside
the JAX package in the repository and are found here by a path from the
repository root, in one place.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "csrc")
RV32IM_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "rv32im", "data")
KECCAK_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "keccak", "data")
RECURSION_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "recursion",
                              "data")
# the recursion programs (zkr): the released keccak lifts and the
# repository's own predicates, xz-compressed code words
RECURSION_ZKR = os.path.join(RECURSION_DATA, "zkr")
# the Poseidon254 suite's round constants and MDS matrix
P254_CONSTS = os.path.join(ROOT, "risc0_tpu", "hash", "poseidon254_consts.json")
V1COMPAT_ELF = os.path.join(ROOT, "risc0_tpu", "zkvm", "data", "v1compat.elf")
# the released bigint2 (bibc) program blobs
BIGINT2_DATA = os.path.join(ROOT, "risc0_tpu", "zkvm", "data", "bigint2")
