# The port's own copy of risc0_tpu/zkvm/methods.py.
"""Test-guest methods — the framework's analog of the reference's
`risc0/zkvm/methods` crate, centered on a multi_test-style scenario ELF
(reference zkvm/methods/src/multi_test.rs:25-65): ONE guest binary whose
behavior is selected by the input, so host-side tests can drive many
scenarios without one ELF per test.

Input layout (little-endian words via ExecutorEnv.write_slice):
  word0 = spec (MultiTestSpec), word1.. = per-spec arguments.

Specs:
  BUSY_LOOP(iters)      — ALU spin, then commit the iteration count
  ECHO(8 words)         — journal exactly 32 input bytes (in-guest
                          output digest; Receipt.verify-compatible)
  FAULT()               — load from the null page (session Fault)
  OUT_OF_BOUNDS()       — store to kernel space from user mode
  SYS_CYCLE_COUNT()     — journal the cycle counter delta of 16 nops
  KECCAK_UPDATE(perms)  — sys_keccak permutes (coprocessor pending queue)
  SYS_VERIFY_INTEGRITY2 — read (claim_digest, control_root) from input,
                          register the assumption (composition path)
  PAUSE()               — env::pause then resume to Halted(0)
"""

from __future__ import annotations

from .guest_env import GuestEnv

BUSY_LOOP = 0
ECHO = 1
FAULT = 2
OUT_OF_BOUNDS = 3
SYS_CYCLE_COUNT = 4
KECCAK_UPDATE = 5
VERIFY_INTEGRITY2 = 6
PAUSE = 7

_SPECS = ["busy_loop", "echo", "fault", "oob", "cycle_count",
          "keccak", "verify2", "pause"]


def multi_test_elf() -> bytes:
    g = GuestEnv()
    a = g.a

    # header: spec word + up to 72 arg bytes (covers verify2's 64)
    hdr = g.read_slice(4)
    args = g.read_slice(72)

    a.li("t2", hdr)
    a.lw("s0", "t2", 0)                   # s0 = spec
    for i, name in enumerate(_SPECS):
        a.li("t1", i)
        a.beq("s0", "t1", name)
    a.halt(1)                             # unknown spec

    # -- busy_loop(iters): spin, then commit the count -------------------
    a.label("busy_loop")
    a.li("t3", args)
    a.lw("s1", "t3", 0)
    a.add("t4", "s1", "zero")
    a.label("busy_spin")
    a.addi("t4", "t4", -1)
    a.bne("t4", "zero", "busy_spin")
    cnt_msg, _, _ = g.sha256_buf(4)       # padded 4-byte journal buffer
    a.li("t3", args)
    a.lw("t5", "t3", 0)
    a.li("t4", cnt_msg)
    a.sw("t4", "t5", 0)
    dig = g.commit(cnt_msg, 4)
    g.exit(0, dig)

    # -- echo: journal 32 input bytes ------------------------------------
    a.label("echo")
    echo_msg, _, _ = g.sha256_buf(32)
    g.copy_words(echo_msg, args, 8)
    dig = g.commit(echo_msg, 32)
    g.exit(0, dig)

    # -- fault: load through a null pointer ------------------------------
    a.label("fault")
    a.li("t1", 0)
    a.lw("t2", "t1", 0)
    a.halt(0)

    # -- out_of_bounds: store into kernel space from user mode -----------
    a.label("oob")
    a.li("t1", 0xC0000000)    # first kernel-space word (user map ends here)
    a.sw("t1", "t1", 0)
    a.halt(0)

    # -- cycle_count: journal the delta across 16 nops -------------------
    a.label("cycle_count")
    cc_msg, _, _ = g.sha256_buf(4)
    # cycle count comes back in the (a0, a1) syscall return pair
    a.syscall("SYS_CYCLE_COUNT", g._tok("SYS_CYCLE_COUNT"), 0, 0)
    a.add("s1", "a1", "zero")
    for _ in range(16):
        a.addi("zero", "zero", 0)
    a.syscall("SYS_CYCLE_COUNT", g._tok("SYS_CYCLE_COUNT"), 0, 0)
    a.sub("t4", "a1", "s1")
    a.li("t3", cc_msg)
    a.sw("t3", "t4", 0)
    dig = g.commit(cc_msg, 4)
    g.exit(0, dig)

    # -- keccak: args = [perms, claim(32B), root(32B)]; permute then
    # flush the batch as a coprocessor proof request (KECCAK_PROVE) -----
    a.label("keccak")
    state = a.put_data(b"\x07" * 200, align=8)
    a.li("t3", args)
    a.lw("s1", "t3", 0)
    a.label("keccak_loop")
    a.syscall("SYS_KECCAK", g._tok("SYS_KECCAK"), state, 50,
              args=[0, state, state])
    a.addi("s1", "s1", -1)
    a.bne("s1", "zero", "keccak_loop")
    a.syscall("SYS_KECCAK", g._tok("SYS_KECCAK"), 0, 0,
              args=[1, (args[0], args[1] + 4), (args[0], args[1] + 36)])
    a.halt(0)

    # -- verify2: args = claim_digest(32) ++ control_root(32) ------------
    a.label("verify2")
    g.verify_integrity2(args, (args[0], args[1] + 32))
    a.halt(0)

    # -- pause once, then halt clean --------------------------------------
    a.label("pause")
    flag = a.put_data(b"\0" * 4)
    a.li("t1", flag)
    a.lw("t2", "t1", 0)
    a.bne("t2", "zero", "pause_done")
    a.li("t2", 1)
    a.sw("t1", "t2", 0)
    from .guest import HALT_PAUSE
    a.halt(0, kind=HALT_PAUSE)
    a.label("pause_done")
    a.halt(0)

    return g.link()


def encode_input(spec: int, *words: int, raw: bytes = b"") -> bytes:
    out = spec.to_bytes(4, "little")
    for w in words:
        out += int(w).to_bytes(4, "little")
    out += raw
    # header read is 4 bytes, args read is 72 — pad so SYS_READ never
    # starves (reader returns short reads otherwise)
    body = out[4:].ljust(72, b"\0")
    return out[:4] + body
