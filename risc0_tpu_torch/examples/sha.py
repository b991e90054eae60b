"""SHA-256 example (reference examples/sha): the guest hashes a message
with the SHA-256 accelerator ecall and commits the digest to the
journal; the host verifies the receipt and checks the digest against
hashlib.

    python -m risc0_tpu_torch.examples.sha [message] [--device cpu]
"""

from __future__ import annotations

import hashlib

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx


def build_guest(msg_len: int) -> bytes:
    """Guest: read msg_len bytes, digest = sha256(msg) via the
    accelerator, journal.commit(digest)."""
    g = GuestEnv()
    msg, out, nblocks = g.sha256_buf(msg_len)
    # read the message straight into the padded hash buffer
    g.a.syscall("SYS_READ", g._tok("SYS_READ"), msg, msg_len,
                args=[0, msg_len])
    g.sha256_emit(out, msg, nblocks)
    jbuf, _, _ = g.sha256_buf(32)
    g.copy_words(jbuf, out, 8)
    dig = g.commit(jbuf, 32)
    g.exit(0, dig)
    return g.link()


def main(argv=None) -> dict:
    # the JAX example's default message, so that the two journals compare
    args = parse_args(argv, __doc__, lambda ap: ap.add_argument(
        "message", nargs="?", default="proving hashes on the MXU's watch"))
    message = args.message.encode()
    elf = build_guest(len(message))

    executor = ExecutorImpl(ExecutorEnv(segment_po2=16).write_slice(message),
                            elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    digest = bytes(session.journal)
    print(f"guest digest: {digest.hex()}")
    assert digest == hashlib.sha256(message).digest(), "digest mismatch"

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt verified (kind={info.receipt.inner.kind}); journal "
          f"binds sha256({message!r})")
    return {"elf": elf, "image_id": image_id, "session": session,
            "receipt": info.receipt}


if __name__ == "__main__":
    main()
