"""Proof composition example (reference examples/composition): guest A
commits a value; guest B verifies guest A's receipt inside the zkVM
(env::verify_integrity) and commits its own result conditioned on it.
The host adds A's receipt as an assumption; the prover attaches it to
the composite receipt, so B's claim is unconditional once resolved.

The port's GuestEnv folds B's verify_integrity into the assumptions
digest that B commits, as the reference guest env does, so guest B's
ELF and image ID differ from the JAX example's (ROADMAP.md queue 3).

    python -m risc0_tpu_torch.examples.composition [--device cpu]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.composition
"""

from __future__ import annotations

import numpy as np

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest import REG, _r
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx

VALUE = 17


def build_committer(value: int) -> bytes:
    """Guest A: journal.commit(value) with an in-guest output digest."""
    g = GuestEnv()
    msg, _, _ = g.sha256_buf(4)
    g._patch_data(msg, 0, value.to_bytes(4, "little"))
    dig = g.commit(msg, 4)
    g.exit(0, dig)
    return g.link()


def build_composer() -> bytes:
    """Guest B: read (claim_digest, control_root) of A's receipt, verify
    it as an assumption, then commit the squared input value."""
    g = GuestEnv()
    a = g.a
    args = g.read_slice(68)  # claim(32) || root(32) || value(4)
    g.verify_integrity(args, (args[0], args[1] + 32))
    msg, _, _ = g.sha256_buf(4)
    a.li("t1", (args[0], args[1] + 64))
    a.lw("t2", "t1", 0)
    # value * value via mul (rv32im M-extension)
    a.emit(_r(REG["t3"], REG["t2"], REG["t2"], 0, 1, 0x33))  # mul t3,t2,t2
    a.li("t4", msg)
    a.sw("t4", "t3", 0)
    dig = g.commit(msg, 4)
    g.exit(0, dig)
    return g.link()


def composer_input(claim_digest, value: int) -> bytes:
    """Guest B's input: A's claim digest, the zero control root ("same
    verifier context") and the value."""
    root = np.zeros(8, np.uint32)
    return (np.asarray(claim_digest, np.uint32).tobytes() + root.tobytes()
            + value.to_bytes(4, "little"))


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    real = real_prove()
    prover = composite_prover(args.device, real)
    ctx = verifier_ctx(real)

    # 1. prove guest A
    elf_a = build_committer(VALUE)
    exec_a = ExecutorImpl(ExecutorEnv(segment_po2=16), elf_a)
    image_a = exec_a.compute_image_id()
    info_a = prover.prove_session(exec_a.run())
    info_a.receipt.verify(image_a, ctx)
    print(f"guest A: committed {VALUE}, receipt verified "
          f"(kind={info_a.receipt.inner.kind})")

    # 2. guest B verifies A's claim in-VM and squares the value
    elf_b = build_composer()
    env = (ExecutorEnv(segment_po2=16)
           .write_slice(composer_input(info_a.receipt.claim().digest(),
                                       VALUE))
           .add_assumption(info_a.receipt))
    exec_b = ExecutorImpl(env, elf_b)
    image_b = exec_b.compute_image_id()
    session = exec_b.run()
    out = int.from_bytes(bytes(session.journal), "little")
    print(f"guest B: verified A's claim in-VM, committed {out}")
    assert out == VALUE * VALUE

    info_b = prover.prove_session(session)
    info_b.receipt.verify(image_b, ctx)
    n_assume = len(getattr(info_b.receipt.inner.value,
                           "assumption_receipts", []))
    print(f"composed receipt verified (kind={info_b.receipt.inner.kind}"
          + (f", {n_assume} assumption receipt attached)" if n_assume
             else ")"))
    return {"elf_a": elf_a, "image_a": image_a, "receipt_a": info_a.receipt,
            "elf_b": elf_b, "image_b": image_b, "session": session,
            "receipt": info_b.receipt}


if __name__ == "__main__":
    main()
