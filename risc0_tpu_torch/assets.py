"""Paths of the repository's non-Python assets that the port reads.

They are data, not code: the extracted circuit tables and witgen programs,
the v1compat kernel ELF, and the C++ executor's sources (built into
``csrc/libr0vm.so``).  They live beside the JAX package in the repository
and are found here by a path from the repository root, in one place.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "csrc")
RV32IM_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "rv32im", "data")
KECCAK_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "keccak", "data")
V1COMPAT_ELF = os.path.join(ROOT, "risc0_tpu", "zkvm", "data", "v1compat.elf")
