"""Keccak circuit object: the extracted taps and constraint-polynomial IR
(counterpart of ``risc0_tpu/circuit/keccak/circuit.py``).

The rv32im circuit class serves it: the zirgen-generated SSA has the same
shape, only the taps, sizes and info differ.  Reference:
keccak-sys/kernels/cuda/eval_check_*.cu, keccak/src/zirgen/{taps.rs,info.rs}.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ...assets import KECCAK_DATA
from ..rv32im.circuit import Rv32imCircuit, _taps_to_tapset

CIRCUIT_INFO = b"KECCAK:v1_______"  # reference zirgen/info.rs:23
OUTPUT_SIZE = 17
MIX_SIZE = 4


@lru_cache(maxsize=1)
def load_circuit() -> Rv32imCircuit:
    tz = np.load(os.path.join(KECCAK_DATA, "taps.npz"))
    ir = np.load(os.path.join(KECCAK_DATA, "poly_fp_ir.npz"),
                 allow_pickle=True)
    c = Rv32imCircuit(
        _taps_to_tapset(tz), ir["opcode"], ir["operands"], ir["n_f"],
        ir["n_e"], ir["fscr_size"], ir["escr_size"], ir["ret"],
        ir["mix_powers"] if "mix_powers" in ir.files else None)
    c.CIRCUIT_INFO = CIRCUIT_INFO
    c.OUTPUT_SIZE = OUTPUT_SIZE
    c.MIX_SIZE = MIX_SIZE
    return c
