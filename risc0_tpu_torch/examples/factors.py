"""Factors example (reference examples/factors/methods/guest/src/main.rs):
the guest reads two secret factors, asserts both are nontrivial, and
commits only their product: the receipt proves "I know a factorization
of n" without revealing the factors.  The multiply runs as a 64-bit
product (mul + mulhu), so claimed factors cannot wrap around 2^32.

    python -m risc0_tpu_torch.examples.factors [a b] [--device cpu]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.factors
"""

from __future__ import annotations

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx


def build_guest() -> bytes:
    """Guest: read (a, b) as u32 words; require a > 1 and b > 1; commit
    the u64 product a*b to the journal."""
    g = GuestEnv()
    a = g.a
    a.li("sp", 0x200400)
    inp = g.read_slice(8)

    a.li("t3", inp)
    a.lw("s2", "t3", 0)   # a
    a.lw("s3", "t3", 4)   # b
    # nontrivial factors: a > 1 and b > 1  (unsigned: fail if x < 2)
    a.li("t4", 2)
    a.sltu("t5", "s2", "t4")
    a.bne("t5", "zero", "fail")
    a.sltu("t5", "s3", "t4")
    a.bne("t5", "zero", "fail")

    # n = a * b as u64 (lo via mul, hi via mulhu)
    prod = a.put_data(b"\0" * 8, align=8)
    a.li("t3", prod)
    a.mul("t4", "s2", "s3")
    a.sw("t3", "t4", 0)
    a.mulhu("t4", "s2", "s3")
    a.sw("t3", "t4", 4)

    dig = g.commit(prod, 8)
    g.exit(0, dig)
    a.label("fail")
    g.exit(1)
    return g.link()


def _input(fa: int, fb: int) -> bytes:
    return fa.to_bytes(4, "little") + fb.to_bytes(4, "little")


def _factors(ap):
    ap.add_argument("a", nargs="?", type=int, default=3141592653)
    ap.add_argument("b", nargs="?", type=int, default=2718281829)


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, _factors)
    fa, fb = args.a, args.b
    elf = build_guest()

    executor = ExecutorImpl(ExecutorEnv(segment_po2=16).write_slice(
        _input(fa, fb)), elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    assert session.exit_code == ("Halted", 0), session.exit_code
    n = int.from_bytes(bytes(session.journal), "little")
    assert n == fa * fb
    print(f"journal: n = {n} (factors stay private)")

    # trivial factorizations are rejected in-guest
    bad = ExecutorImpl(ExecutorEnv(segment_po2=16).write_slice(
        _input(1, fb)), elf).run()
    assert bad.exit_code == ("Halted", 1)
    print("guest rejected a trivial factor (a = 1)")

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt verified (kind={info.receipt.inner.kind}); journal "
          f"binds n = {n}")
    return {"elf": elf, "image_id": image_id, "session": session,
            "rejected": bad, "receipt": info.receipt}


if __name__ == "__main__":
    main()
