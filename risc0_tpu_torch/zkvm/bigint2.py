# The port's own copy of risc0_tpu/zkvm/bigint2.py.
"""bigint2 program registry + host-side evaluator.

The reference's `bigint2` guest crate (risc0/bigint2/src/lib.rs) embeds
released bibc program blobs (field/EC/RSA ops) and invokes them through the
BigInt accelerator ecall.  Here the same released blobs, vendored as data
under `risc0_tpu/zkvm/data/bigint2/` (found through `assets.py`), are
exposed by name and evaluable host-side through the C++ bibc VM (csrc/bigint.inc, reference
circuit/rv32im/src/execute/bibc.rs) — used by tests and by
run-unconstrained host code.

Blob layout: [u32 program_len] [u32 nondet/verify/consts sizes] ++ bibc
byte-code (zkvm/platform/src/syscall.rs:1044-1049).
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

from ..assets import BIGINT2_DATA as _DATA


def program_names() -> list[str]:
    out = []
    for root, _dirs, files in os.walk(_DATA):
        for f in sorted(files):
            if f.endswith(".blob"):
                rel = os.path.relpath(os.path.join(root, f), _DATA)
                out.append(rel[: -len(".blob")])
    return sorted(out)


def program(name: str) -> np.ndarray:
    """bibc byte-code for `name` (e.g. "field/modmul_256") as uint8."""
    path = os.path.join(_DATA, name + ".blob")
    with open(path, "rb") as f:
        w = np.frombuffer(f.read(), np.uint32)
    return np.frombuffer(w[4 : 4 + w[0]].tobytes(), np.uint8).copy()


class BigIntVM:
    """Host-side bibc evaluation: a scratch rv32im memory + registers, the
    same entry the emulator's BigInt ecall uses (csrc/bigint.inc)."""

    def __init__(self):
        from . import native

        self.lib = native.lib()
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        self.lib.r0_bibc_eval.argtypes = [
            u8p, C.c_uint64, u32p, C.c_uint64, u32p, C.c_uint32]
        self.mem = np.zeros(1 << 17, np.uint32)
        self.regs = np.zeros(32, np.uint32)
        self.regs[2] = 0x40000  # sp -> bibc temp arena

    def put(self, reg: int, addr: int, val: int | None = None,
            words: int = 8) -> None:
        self.regs[reg] = addr
        if val is not None:
            self.mem[addr // 4 : addr // 4 + words] = np.frombuffer(
                int(val).to_bytes(words * 4, "little"), np.uint32)

    def get(self, addr: int, words: int = 8) -> int:
        return int.from_bytes(
            self.mem[addr // 4 : addr // 4 + words].tobytes(), "little")

    def run(self, name: str) -> None:
        prog = program(name)
        rc = self.lib.r0_bibc_eval(prog, len(prog), self.mem, len(self.mem),
                                   self.regs, 0)
        if rc != 0:
            raise RuntimeError(self.lib.r0_last_error().decode())


def modmul(a: int, b: int, modulus: int, width: int = 256) -> int:
    """a*b mod modulus via the released blob (reference bigint2 field API)."""
    words = width // 32
    vm = BigIntVM()
    vm.put(11, 0x1000, a, words)
    vm.put(12, 0x2000, b, words)
    vm.put(13, 0x3000, modulus, words)
    vm.put(14, 0x4000, words=words)
    vm.run(f"field/modmul_{width}")
    return vm.get(0x4000, words)
