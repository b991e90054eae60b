"""The loop guest (guests/loop.bin): it reads a loop count and runs about
2.02 cycles a loop iteration plus about 13,000 fixed cycles."""

import os

import numpy as np

# cycles of a segment the guest cannot use: the executor reserves 25,000
# and paging takes up to about 6,000 more
SEGMENT_OVERHEAD = 31_000


def elf(root: str, config) -> bytes:
    with open(os.path.join(root, config["elf"]), "rb") as f:
        return f.read()


def loop_count(config, mix, rng: np.random.Generator) -> int:
    """A loop count, drawn from `rng`, that fills `mix["segments"]` whole
    segments of 2^segment_po2 cycles and a share of one more drawn from
    `mix["last_fill"]`."""
    room = (1 << config["segment_po2"]) - SEGMENT_OVERHEAD
    lo, hi = mix["last_fill"]
    cycles = (mix["segments"] + rng.uniform(lo, hi)) * room
    return max(1, int((cycles - 13000) / 2.02))


def stdin(count: int) -> bytes:
    return count.to_bytes(4, "little")
