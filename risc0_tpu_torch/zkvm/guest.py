# The port's own copy of risc0_tpu/zkvm/guest.py.
"""Guest authoring: a minimal rv32im assembler + ELF writer so new test
guests can be built without a RISC-V toolchain (the framework's equivalent
of risc0-build's guest compilation, reference risc0/build/src/lib.rs —
scoped to hand-written test/benchmark guests).

The emitted ELFs follow the zkOS user ABI (reference
risc0/zkvm/platform/src/syscall.rs):
  - software syscalls: ecall with t0=SOFTWARE, t6=class, a0/a1 host buffer,
    a2 = NUL-terminated syscall name, a3.. args; returns (a0, a1)
  - halt/pause: ecall t0=HALT, a0 = kind | user_exit<<8, a1 = out digest
  - bigint2: ecall t0=BIGINT2, t1/t2/t3 program section pointers, a0 blob

Text is placed at TEXT_START (0x200800), data after it; the v1compat
kernel (zkOS) handles the trap side.
"""

from __future__ import annotations

import hashlib
import struct

TEXT_START = 0x0020_0800
STACK_TOP = 0x0020_0400

# ecall classes (platform syscall.rs:24-33)
ECALL_HALT = 0
ECALL_SOFTWARE = 2
ECALL_BIGINT2 = 6
HALT_TERMINATE = 0
HALT_PAUSE = 1

# Syscall class numbers the v1compat kernel routes on via t6
# (platform syscall.rs:176-196)
SYSCALL_CLASS = {
    "SYS_ARGC": 1, "SYS_ARGV": 2, "SYS_CYCLE_COUNT": 3, "SYS_EXIT": 4,
    "SYS_FORK": 5, "SYS_GETENV": 6, "SYS_KECCAK": 7, "SYS_LOG": 8,
    "SYS_PANIC": 9, "SYS_PIPE": 10, "SYS_RANDOM": 11, "SYS_READ": 12,
    "SYS_USER": 13, "SYS_VERIFY_INTEGRITY": 14, "SYS_VERIFY_INTEGRITY2": 15,
    "SYS_WRITE": 16, "SYS_PROVE_ZKR": 17,
}

REG = {name: i for i, name in enumerate(
    "zero ra sp gp tp t0 t1 t2 s0 s1 a0 a1 a2 a3 a4 a5 a6 a7 "
    "s2 s3 s4 s5 s6 s7 s8 s9 s10 s11 t3 t4 t5 t6".split())}


def _r(rd, rs1, rs2, f3, f7, op):
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def _i(rd, rs1, imm, f3, op):
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def _s(rs1, rs2, imm, f3):
    imm &= 0xFFF
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        ((imm & 0x1F) << 7) | 0x23


def _b(rs1, rs2, imm, f3):
    imm &= 0x1FFF
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) | \
        (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (((imm >> 1) & 0xF) << 8) | \
        (((imm >> 11) & 1) << 7) | 0x63


def _u(rd, imm, op):
    return (imm & 0xFFFFF000) | (rd << 7) | op


def _j(rd, imm):
    imm &= 0x1FFFFF
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) | \
        (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) | \
        (rd << 7) | 0x6F


class Asm:
    """Two-pass rv32im assembler over a flat text+data layout."""

    def __init__(self, base=TEXT_START):
        self.base = base
        self.insns: list = []       # ints or ("label-use", fixup)
        self.labels: dict[str, int] = {}
        self.data = bytearray()
        self.data_base = None       # set at link time

    # -- labels / layout ------------------------------------------------------
    def label(self, name):
        self.labels[name] = len(self.insns) * 4

    def pc(self):
        return self.base + len(self.insns) * 4

    def put_data(self, blob: bytes, align=4) -> int:
        """Append to the data section; returns a token resolved at link."""
        while len(self.data) % align:
            self.data.append(0)
        off = len(self.data)
        self.data += blob
        return ("data", off)

    # -- instructions ---------------------------------------------------------
    def emit(self, word):
        self.insns.append(word)

    def addi(self, rd, rs1, imm):
        self.emit(_i(REG[rd], REG[rs1], imm, 0, 0x13))

    def add(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 0, 0, 0x33))

    def sub(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 0, 0x20, 0x33))

    def lui(self, rd, imm20):
        self.emit(_u(REG[rd], imm20 << 12, 0x37))

    def lw(self, rd, rs1, imm):
        self.emit(_i(REG[rd], REG[rs1], imm, 2, 0x03))

    def sw(self, rs1, rs2, imm):
        """mem[rs1+imm] <- rs2"""
        self.emit(_s(REG[rs1], REG[rs2], imm, 2))

    def and_(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 7, 0, 0x33))

    def or_(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 6, 0, 0x33))

    def xor(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 4, 0, 0x33))

    def sll(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 1, 0, 0x33))

    def srl(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 5, 0, 0x33))

    def andi(self, rd, rs1, imm):
        self.emit(_i(REG[rd], REG[rs1], imm, 7, 0x13))

    def slli(self, rd, rs1, sh):
        self.emit(_i(REG[rd], REG[rs1], sh & 31, 1, 0x13))

    def srli(self, rd, rs1, sh):
        self.emit(_i(REG[rd], REG[rs1], sh & 31, 5, 0x13))

    def sltu(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 3, 0, 0x33))

    # M extension (funct7=1)
    def mul(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 0, 1, 0x33))

    def mulhu(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 3, 1, 0x33))

    def divu(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 5, 1, 0x33))

    def remu(self, rd, rs1, rs2):
        self.emit(_r(REG[rd], REG[rs1], REG[rs2], 7, 1, 0x33))

    def lbu(self, rd, rs1, imm):
        self.emit(_i(REG[rd], REG[rs1], imm, 4, 0x03))

    def sb(self, rs1, rs2, imm):
        """mem[rs1+imm] <- low byte of rs2"""
        self.emit(_s(REG[rs1], REG[rs2], imm, 0))

    def ecall(self):
        self.emit(0x73)

    def jal(self, rd, label):
        self.emit(("jal", REG[rd], label, len(self.insns)))

    def jalr(self, rd, rs1, imm=0):
        """rd <- pc+4; pc <- rs1+imm (subroutine call/return)."""
        self.emit(_i(REG[rd], REG[rs1], imm, 0, 0x67))

    def beq(self, rs1, rs2, label):
        self.emit(("beq", REG[rs1], REG[rs2], label, len(self.insns), 0))

    def bne(self, rs1, rs2, label):
        self.emit(("beq", REG[rs1], REG[rs2], label, len(self.insns), 1))

    def li(self, rd, value):
        """Load a 32-bit constant (or a ("data", off) token)."""
        if isinstance(value, tuple):
            self.emit(("li-data", REG[rd], value[1], len(self.insns)))
            self.emit(0x13)  # placeholder (becomes the paired addi)
            return
        value &= 0xFFFFFFFF
        hi = (value + 0x800) >> 12
        lo = value - (hi << 12)
        self.lui(rd, hi & 0xFFFFF)
        self.addi(rd, rd, ((lo + 0x800) & 0xFFF) - 0x800)

    # -- zkvm ABI helpers -----------------------------------------------------
    def syscall(self, short_name, name_token, from_host_ptr=0,
                from_host_words=0, args=()):
        """Software ecall: t6 carries the class number the kernel routes
        on, a2 the NUL-terminated full name (dispatched by the host).
        `short_name` like "SYS_WRITE"; name_token from put_data."""
        self.li("t0", ECALL_SOFTWARE)
        self.li("t6", SYSCALL_CLASS[short_name])
        self.li("a0", from_host_ptr)
        self.li("a1", from_host_words)
        self.li("a2", name_token)
        for i, arg in enumerate(args):
            self.li(f"a{3 + i}", arg)
        self.ecall()

    def halt(self, user_exit=0, out_digest_token=None, kind=HALT_TERMINATE):
        self.li("t0", ECALL_HALT)
        self.li("a0", kind | (user_exit << 8))
        if out_digest_token is None:
            out_digest_token = self.put_data(b"\0" * 32)
        self.li("a1", out_digest_token)
        self.ecall()

    # -- link -----------------------------------------------------------------
    def link(self) -> bytes:
        text_len = len(self.insns) * 4
        self.data_base = self.base + ((text_len + 7) & ~3)
        resolved = []
        i = 0
        while i < len(self.insns):
            ins = self.insns[i]
            if isinstance(ins, int):
                resolved.append(ins)
                i += 1
            elif ins[0] == "li-data":
                _, rd, off, at = ins
                addr = self.data_base + off
                hi = (addr + 0x800) >> 12
                lo = addr - (hi << 12)
                resolved.append(_u(rd, (hi & 0xFFFFF) << 12, 0x37))
                resolved.append(_i(rd, rd, ((lo + 0x800) & 0xFFF) - 0x800,
                                   0, 0x13))
                i += 2  # consume the placeholder
            elif ins[0] == "jal":
                _, rd, label, at = ins
                off = self.labels[label] - at * 4
                resolved.append(_j(rd, off))
                i += 1
            elif ins[0] == "beq":
                _, rs1, rs2, label, at, inv = ins
                off = self.labels[label] - at * 4
                resolved.append(_b(rs1, rs2, off, 1 if inv else 0))
                i += 1
            else:
                raise ValueError(ins)
        text = b"".join(struct.pack("<I", wd & 0xFFFFFFFF) for wd in resolved)
        blob = text
        pad = self.data_base - (self.base + len(text))
        blob += b"\0" * pad + bytes(self.data)
        return elf32(self.base, blob, entry=self.base)


def elf32(vaddr: int, blob: bytes, entry: int) -> bytes:
    """Minimal ET_EXEC ELF32 for EM_RISCV with one PT_LOAD segment."""
    ehsize, phentsize = 52, 32
    off = ehsize + phentsize
    eh = struct.pack(
        "<4sBBBBB7xHHIIIIIHHHHHH",
        b"\x7fELF", 1, 1, 1, 0, 0,
        2, 243, 1,          # ET_EXEC, EM_RISCV, EV_CURRENT
        entry, ehsize, 0,   # e_entry, e_phoff, e_shoff
        0,                  # e_flags
        ehsize, phentsize, 1, 0, 0, 0)
    ph = struct.pack("<IIIIIIII", 1, off, vaddr, vaddr, len(blob),
                     len(blob), 7, 4)
    return eh + ph + blob


def output_digest(journal: bytes) -> bytes:
    """risc0.Output tagged digest of (journal, empty assumptions) — the
    out_state a halting guest commits (binfmt receipt_claim semantics)."""
    def tag(t, downs, data=b""):
        h = hashlib.sha256(t.encode()).digest()
        for d in downs:
            h += d
        h += data
        h += len(downs).to_bytes(2, "little")
        return hashlib.sha256(h).digest()

    journal_digest = hashlib.sha256(journal).digest()
    assumptions = b"\0" * 32
    return tag("risc0.Output", [journal_digest, assumptions])
