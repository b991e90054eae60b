"""Keccak coprocessor example (reference examples + the zkvm keccak
batcher flow): a guest permutes keccak states through the accelerator
syscall, flushes the batch with KECCAK_PROVE, and assumes the batch claim
through sys_verify_integrity2; the proof DAG proves the coprocessor
request, unions the receipts, and resolves the assumption, so the final
receipt is unconditional.  The job runs on the DevModeProver, as the JAX
example's does; with one batch the port's union claim is the JAX one.

    python -m risc0_tpu_torch.examples.keccak_coprocessor          # queued
    python -m risc0_tpu_torch.examples.keccak_coprocessor --stream # streamed
"""

from __future__ import annotations

import numpy as np

from ..circuit.keccak import compute_keccak_digest
from ..parallel.scheduler import Factory, ProofJob, make_local_pools
from ..zkvm.claims import Assumption, Assumptions, MaybePruned, Output
from ..zkvm.exec import ExecutorEnv
from ..zkvm.guest import Asm
from ..zkvm.prover import DevModeProver
from .common import parse_args

NR = "risc0_zkvm_platform::syscall::nr::"


def build_guest():
    """Permute one state, flush the batch, assume the batch claim, commit
    a journal: the shape that the reference guest keccak batcher emits."""
    state0 = [int(i * 0x9E3779B9 + 1) % (1 << 64) for i in range(25)]
    claim = compute_keccak_digest([state0])
    root = np.zeros(8, np.uint32)  # zero root = same verifier context
    journal = b"keccak-accelerated!"
    out = Output.of(journal, Assumptions(
        [MaybePruned.of(Assumption(claim, root))]))

    a = Asm()
    ktok = a.put_data((NR + "SYS_KECCAK").encode() + b"\0")
    vtok = a.put_data((NR + "SYS_VERIFY_INTEGRITY2").encode() + b"\0")
    wtok = a.put_data((NR + "SYS_WRITE").encode() + b"\0")
    state = a.put_data(b"".join(int(x).to_bytes(8, "little")
                                for x in state0), align=8)
    cr = a.put_data(claim.tobytes())
    rootptr = a.put_data(root.tobytes())
    jdata = a.put_data(journal)
    odig = a.put_data(np.asarray(out.digest(), np.uint32).tobytes())
    a.syscall("SYS_KECCAK", ktok, state, 50, args=[0, state, state])
    a.syscall("SYS_KECCAK", ktok, 0, 0, args=[1, cr, rootptr])
    a.syscall("SYS_VERIFY_INTEGRITY2", vtok, 0, 0, args=[cr, 64])
    a.syscall("SYS_WRITE", wtok, 0, 0, args=[3, jdata, len(journal)])
    a.halt(0, out_digest_token=odig)
    return a.link(), claim


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, lambda ap: ap.add_argument(
        "--stream", action="store_true",
        help="prove the coprocessor requests while the guest executes"))
    elf, claim = build_guest()

    factory = Factory()
    prover = DevModeProver()
    workers = make_local_pools(factory, prover, num_cpu=1, num_accel=2,
                               device=args.device)
    try:
        job = ProofJob(factory, prover, ExecutorEnv(segment_po2=15), elf,
                       stream_keccak=args.stream)
        session, receipt = job.run()
    finally:
        for w in workers:
            w.stop()

    union = np.asarray(job.union_receipt.claim.digest(), np.uint32)
    mode = "streamed during execution" if args.stream else \
        "queued on session"
    print(f"coprocessor requests: {mode}")
    print(f"journal: {session.journal.decode()}")
    print(f"batch claim:  {np.asarray(claim, np.uint32).tobytes().hex()}")
    print(f"union claim:  {union.tobytes().hex()}")
    left = receipt.claim.output.value.assumptions.value.items
    print(f"assumptions left on the final receipt: {len(left)} (resolved "
          "by the union receipt)")
    assert left == []
    print("OK")
    return {"elf": elf, "batch_claim": claim, "union_claim": union,
            "session": session, "receipt": receipt}


if __name__ == "__main__":
    main()
