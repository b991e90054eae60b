"""External-prover API example (reference examples/prover, ApiClient
usage): the host process talks to an r0vm-style prover server over the
length-framed IPC protocol instead of proving in-process: execute for
the journal first, then prove.  The server here runs in-process
(spawn=True); ``python -m risc0_tpu_torch.cli port`` serves the same
protocol to a client's listener (see zkvm/ipc.py).

    python -m risc0_tpu_torch.examples.prover_api [--device cpu]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.prover_api
"""

from __future__ import annotations

from .. import loop_guest
from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.ipc import ApiClient
from ..zkvm.prover import DevModeProver, ProverImpl, ProverOpts
from .common import parse_args, real_prove, verifier_ctx

LOOP_COUNT = 25


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    real = real_prove()

    elf = loop_guest.elf()
    env = ExecutorEnv(segment_po2=16).write_slice(
        LOOP_COUNT.to_bytes(4, "little"))
    image_id = ExecutorImpl(env, elf).compute_image_id()

    prover = ProverImpl(device=args.device) if real else DevModeProver()
    client = ApiClient(spawn=True, prover=prover, device=args.device)
    try:
        session, segments = client.execute(env, elf)
        print(f"execute: {getattr(session, 'user_cycles', '?')} user "
              f"cycles, {len(segments)} segment(s)")

        info = client.prove(env, elf, ProverOpts(receipt_kind="composite",
                                                 dev_mode=not real))
        receipt = info.receipt if hasattr(info, "receipt") else info
        receipt.verify(image_id, verifier_ctx(real))
        print(f"prove over IPC ok (kind={receipt.inner.kind}); receipt "
              "verified locally against the image id")
    finally:
        client.close()
    return {"elf": elf, "image_id": image_id, "session": session,
            "segments": segments, "receipt": receipt}


if __name__ == "__main__":
    main()
