"""The loop guest (``guests/loop.bin``) executed into segments: the main
path that ``chip_smoke.py`` and ``scripts/torch_prove_ab.py`` prove, and
the sessions its recursion phase compresses."""

from __future__ import annotations

import os

from .assets import ROOT
from .zkvm.exec import ExecutorEnv, ExecutorImpl

ELF = os.path.join(ROOT, "guests", "loop.bin")
# a fixed challenge for the witness (the circuit's `rng` global), so every
# run gives the same seal
RAND_Z = (1, 2, 3, 4)


def _count(cycles: float) -> int:
    """Loop count that runs about `cycles` guest cycles: about 2.02 cycles
    an iteration plus about 13k fixed (bench.py:44-46)."""
    return max(1, int((cycles - 13000) / 2.02))


def count_for_po2(po2: int) -> int:
    """Loop count that fills about 70% of a 2^po2 segment."""
    return _count(0.70 * (1 << po2))


# cycles of a segment the guest cannot use: the executor reserves 25,000
# and paging takes up to about 6,000 more (measured on this guest)
_SEGMENT_OVERHEAD = 31_000


def elf() -> bytes:
    with open(ELF, "rb") as f:
        return f.read()


def _env(po2: int, count: int, povw_job_id=None) -> ExecutorEnv:
    return ExecutorEnv(segment_po2=po2, povw_job_id=povw_job_id).write_slice(
        count.to_bytes(4, "little"))


def segment(po2: int):
    """Execute the loop guest at segment po2 `po2`; its first segment."""
    session = ExecutorImpl(_env(po2, count_for_po2(po2)), elf()).run()
    return session.segments[0]


def session_env(po2: int, segments: int, povw_job_id=None) -> ExecutorEnv:
    """The env that splits the loop guest into `segments` segments of po2
    `po2`: 0.70 + 0.95 * (segments - 1) segments' worth of loop
    iterations (the fill of scripts/record_succinct20.py), counted in the
    cycles a segment leaves the guest, which at po2 16 are about half of
    its 2^16.  With `povw_job_id` (a zkvm.povw.PovwJobId) segment i
    carries the PoVW nonce job.nonce(i)."""
    room = (1 << po2) - _SEGMENT_OVERHEAD
    return _env(po2, _count((0.70 + 0.95 * (segments - 1)) * room),
                povw_job_id)


def session(po2: int, segments: int, povw_job_id=None):
    """Execute the loop guest in the env of ``session_env``."""
    return ExecutorImpl(session_env(po2, segments, povw_job_id), elf()).run()
