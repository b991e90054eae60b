"""The loop guest (``guests/loop.bin``) executed into one segment: the main
path that ``chip_smoke.py`` and ``scripts/torch_prove_ab.py`` prove."""

from __future__ import annotations

import os

from .assets import ROOT
from .zkvm.exec import ExecutorEnv, ExecutorImpl

ELF = os.path.join(ROOT, "guests", "loop.bin")
# a fixed challenge for the witness (the circuit's `rng` global), so every
# run gives the same seal
RAND_Z = (1, 2, 3, 4)


def count_for_po2(po2: int) -> int:
    """Loop count that fills about 70% of a 2^po2 segment (bench.py:44-46):
    about 2.02 cycles an iteration plus about 13k fixed."""
    return max(1, int((0.70 * (1 << po2) - 13000) / 2.02))


def segment(po2: int):
    """Execute the loop guest at segment po2 `po2`; its first segment."""
    with open(ELF, "rb") as f:
        elf = f.read()
    env = ExecutorEnv(segment_po2=po2).write_slice(
        count_for_po2(po2).to_bytes(4, "little"))
    return ExecutorImpl(env, elf).run().segments[0]
