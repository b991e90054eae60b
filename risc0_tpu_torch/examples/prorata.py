"""Pro-rata allocation example (reference examples/prorata): the guest
computes a recipient's share of an airdrop, allocation =
amount * balance / total_supply, inside the zkVM and commits
(recipient_id, allocation) to the journal, so the distribution math is
publicly verifiable without re-running it.  The guest checks that the
32-bit product does not overflow (mulhu must be zero) and halts with
exit 1 otherwise.

    python -m risc0_tpu_torch.examples.prorata [amount balance total]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.prorata
"""

from __future__ import annotations

import struct

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx

RECIPIENT = 0xA11CE


def build_guest() -> bytes:
    """stdin: recipient_id, amount, balance, total (4 u32 LE words).
    journal: recipient_id, allocation (2 u32 words)."""
    g = GuestEnv()
    a = g.a
    inp = g.read_slice(16)
    out = a.put_data(b"\0" * 8)

    a.li("s1", inp)
    a.lw("a0", "s1", 0)               # recipient id
    a.lw("t0", "s1", 4)               # amount
    a.lw("t1", "s1", 8)               # balance
    a.lw("t2", "s1", 12)              # total supply
    # refuse a zero denominator or a 64-bit product (no silent wrap)
    a.beq("t2", "zero", "bad")
    a.mulhu("t3", "t0", "t1")
    a.bne("t3", "zero", "bad")
    a.mul("t3", "t0", "t1")
    a.divu("t4", "t3", "t2")          # allocation
    a.li("s2", out)
    a.sw("s2", "a0", 0)
    a.sw("s2", "t4", 4)
    jdig = g.commit(out, 8)
    g.exit(0, jdig)
    a.label("bad")
    g.exit(1)
    return g.link()


def _amounts(ap):
    ap.add_argument("amounts", nargs="*", type=int,
                    help="amount balance total (default 50000 137 10000)")


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, _amounts)
    amount, balance, total = (args.amounts[:3] if len(args.amounts) >= 3
                              else (50_000, 137, 10_000))
    elf = build_guest()

    env = ExecutorEnv(segment_po2=16).write_slice(
        struct.pack("<IIII", RECIPIENT, amount, balance, total))
    executor = ExecutorImpl(env, elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    out = {"elf": elf, "image_id": image_id, "session": session,
           "receipt": None}
    if session.exit_code != ("Halted", 0):
        print(f"guest rejected the inputs: {session.exit_code}")
        return out
    rid, alloc = struct.unpack("<II", bytes(session.journal))
    assert rid == RECIPIENT and alloc == amount * balance // total
    print(f"recipient {rid:#x}: allocation {alloc} "
          f"(= {amount} * {balance} / {total})")

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt verified (kind={info.receipt.inner.kind}); the journal "
          "binds the allocation to the public distribution math")
    out["receipt"] = info.receipt
    return out


if __name__ == "__main__":
    main()
