# The port's own copy of risc0_tpu/zkvm/trace.py.
"""Execution trace events (reference risc0/circuit/rv32im/src/trace.rs
TraceEvent + host/client/env.rs trace_callback).

`trace_execution(elf, ...)` single-steps the guest on the debug machine
and yields `TraceEvent`s: InstructionStart per user-mode instruction
(cycle, pc, encoded insn) and RegisterSet diffs after each step.  This is
the debugging/analysis channel; for cycle attribution use the profiler
(zkvm/profiler.py), which has no per-step Python overhead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class InstructionStart:
    cycle: int
    pc: int
    insn: int


@dataclass(frozen=True)
class RegisterSet:
    idx: int
    value: int


def trace_execution(user_elf: bytes, input_data: bytes = b"",
                    kernel_elf: bytes | None = None,
                    max_insns: int = 1 << 24) -> Iterator[object]:
    """Yield TraceEvents while executing the guest (user-mode view)."""
    from .gdb import DebugMachine

    m = DebugMachine(user_elf, input_data, kernel_elf)
    try:
        prev_regs = m.regs()
        cycle = 0
        while not m.halted() and cycle < max_insns:
            if m.lib.r0_debug_mode(m.h) == 0:  # user mode
                pc = m.pc()
                insn = int.from_bytes(m.read_mem(pc, 4), "little")
                yield InstructionStart(cycle=cycle, pc=pc, insn=insn)
            status, _ = m.step(1)
            cycle += 1
            if status == 1:
                break
            regs = m.regs()
            if not np.array_equal(regs, prev_regs):
                for idx in np.nonzero(regs != prev_regs)[0]:
                    yield RegisterSet(idx=int(idx), value=int(regs[idx]))
                prev_regs = regs
    finally:
        m.close()
