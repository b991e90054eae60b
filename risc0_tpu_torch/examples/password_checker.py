"""Password-policy example (reference examples/password-checker): the
guest reads a password, enforces the policy in the zkVM (length >= 8, at
least one digit, at least one letter), and commits only the SHA-256
digest: the verifier learns that the password met the policy without
seeing it.  A policy violation halts with a nonzero user exit code.

    python -m risc0_tpu_torch.examples.password_checker [password]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.password_checker
"""

from __future__ import annotations

import hashlib

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx


def build_guest(pw_len: int) -> bytes:
    """Policy loop in rv32im: walk the bytes once, tracking has_digit /
    has_letter flags; reject short passwords up front."""
    g = GuestEnv()
    a = g.a
    msg, out, nblocks = g.sha256_buf(pw_len)
    g.a.syscall("SYS_READ", g._tok("SYS_READ"), msg, pw_len,
                args=[0, pw_len])

    if pw_len < 8:
        g.exit(1)    # too short: constant-fail guest
        return g.link()

    a.li("s1", msg)                   # ptr
    a.li("s2", (msg[0], msg[1] + pw_len))   # end
    a.li("s3", 0)                     # has_digit
    a.li("s4", 0)                     # has_letter
    a.label("loop")
    a.beq("s1", "s2", "done")
    a.lbu("t0", "s1", 0)              # byte
    # digit: '0' <= b <= '9'
    a.addi("t1", "t0", -ord("0"))
    a.li("t2", 10)
    a.sltu("t1", "t1", "t2")          # (b - '0') < 10  (unsigned)
    a.or_("s3", "s3", "t1")
    # letter: lowercase the byte (set bit 0x20), 'a' <= b <= 'z'
    a.li("t2", 0x20)
    a.or_("t1", "t0", "t2")
    a.addi("t1", "t1", -ord("a"))
    a.li("t2", 26)
    a.sltu("t1", "t1", "t2")
    a.or_("s4", "s4", "t1")
    a.addi("s1", "s1", 1)
    a.jal("zero", "loop")
    a.label("done")
    a.and_("t0", "s3", "s4")          # both flags set?
    a.bne("t0", "zero", "ok")
    g.exit(1)
    a.label("ok")
    g.sha256_emit(out, msg, nblocks)
    jbuf, _, _ = g.sha256_buf(32)
    g.copy_words(jbuf, out, 8)
    dig = g.commit(jbuf, 32)
    g.exit(0, dig)
    return g.link()


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, lambda ap: ap.add_argument(
        "password", nargs="?", default="s3cret-passphrase"))
    password = args.password
    elf = build_guest(len(password))

    env = ExecutorEnv(segment_po2=16).write_slice(password.encode())
    executor = ExecutorImpl(env, elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    out = {"elf": elf, "image_id": image_id, "session": session,
           "receipt": None}
    if session.exit_code != ("Halted", 0):
        print(f"password REJECTED by in-guest policy: {session.exit_code}")
        return out
    digest = bytes(session.journal)
    assert digest == hashlib.sha256(password.encode()).digest()
    print(f"policy ok; committed digest {digest.hex()[:32]}…")

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt verified (kind={info.receipt.inner.kind}): the "
          "password satisfied the policy, and only its hash is public")
    out["receipt"] = info.receipt
    return out


if __name__ == "__main__":
    main()
