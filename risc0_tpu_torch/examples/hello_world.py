"""Hello-world example (reference examples/hello-world): author a guest
that commits a message to the journal, execute it, prove it (dev mode by
default; RISC0_REAL_PROVE=1 for the cryptographic prover), and verify
the receipt against the image ID.

    python -m risc0_tpu_torch.examples.hello_world [--device cpu]
"""

from __future__ import annotations

from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest import Asm, output_digest
from .common import composite_prover, parse_args, real_prove, verifier_ctx

NR = "risc0_zkvm_platform::syscall::nr::"
# the JAX example's message, so that the two journals compare
MESSAGE = b"Hello, world! (proved on a TPU framework)"


def build_guest(message: bytes) -> bytes:
    """Guest: journal.commit(message); env::exit(0)."""
    a = Asm()
    write_tok = a.put_data((NR + "SYS_WRITE").encode() + b"\0")
    jdata = a.put_data(message)
    odig = a.put_data(output_digest(message))
    a.syscall("SYS_WRITE", write_tok, 0, 0, args=[3, jdata, len(message)])
    a.halt(user_exit=0, out_digest_token=odig)
    return a.link()


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    elf = build_guest(MESSAGE)

    executor = ExecutorImpl(ExecutorEnv(segment_po2=16), elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    print(f"executed: {session.user_cycles} user cycles, "
          f"journal = {bytes(session.journal)!r}")

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt kind = {info.receipt.inner.kind}; verified against "
          f"image id")
    return {"elf": elf, "image_id": image_id, "session": session,
            "receipt": info.receipt}


if __name__ == "__main__":
    main()
