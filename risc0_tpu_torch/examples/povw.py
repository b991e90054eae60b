"""Proof-of-verifiable-work example (reference risc0/povw): run a guest
under a PoVW job id so that every segment proof consumes a unique nonce,
then inspect the accumulated Work and update a prover-side WorkLog.

Dev mode by default (fake receipts, instant); RISC0_DEV_MODE=0 proves on
`--device` for the cryptographic WorkClaim chain.

    python -m risc0_tpu_torch.examples.povw [--device cpu]
"""

from __future__ import annotations

from .. import loop_guest
from ..parallel.scheduler import Factory, ProofJob, make_local_pools
from ..zkvm.exec import ExecutorEnv
from ..zkvm.povw import PovwJobId, WorkLog
from ..zkvm.povw_tree import WorkSet
from ..zkvm.prover import ProverOpts, get_prover_server
from .common import dev_mode_default_on, parse_args

JOB_ID = PovwJobId(log=0x1234_5678_9ABC_DEF0, job=1)
LOOP_COUNT = 1024 * 494 + 818  # enough for several segments at po2 16


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    elf = loop_guest.elf()
    env = ExecutorEnv(segment_po2=16, povw_job_id=JOB_ID).write_slice(
        LOOP_COUNT.to_bytes(4, "little"))

    factory = Factory()
    prover = get_prover_server(ProverOpts(dev_mode=dev_mode_default_on()),
                               args.device)
    workers = make_local_pools(factory, prover, num_cpu=1, num_accel=2,
                               device=args.device)
    try:
        proof_job = ProofJob(factory, prover, env, elf)
        session, receipt = proof_job.run()
    finally:
        for w in workers:
            w.stop()

    work = proof_job.work
    print(f"segments proved : {len(session.segments)}")
    print(f"nonce range     : segment {work.nonce_min.segment}"
          f" .. {work.nonce_max.segment} (job {work.nonce_min.job})")
    print(f"work value      : {work.value} cycles")
    print(f"final claim     : {receipt.claim.exit_code.kind}")

    # record the consumed nonce range in this prover's work log (reuse of
    # a nonce would raise; reference povw/src/tree.rs)
    log = WorkLog(log_id=JOB_ID.log)
    log.record(work)
    print(f"work log commit : {bytes(log.commit().tobytes()).hex()[:16]}…")

    # export to the reference's on-chain sparse-tree layout and prove a
    # nonce was consumed (povw_tree.py; reference povw/src/tree.rs)
    ws = WorkSet({JOB_ID.log: log.to_tree()})
    nonce = JOB_ID.nonce(0).to_u256()
    opening = ws.prove_opening(nonce)
    opening.verify_inclusion(ws.commit(), nonce)
    print(f"on-chain root   : {ws.commit().hex()[:16]}… "
          f"(inclusion proof for segment-0 nonce verified)")
    return {"elf": elf, "session": session, "receipt": receipt,
            "work": work, "log_commit": log.commit(),
            "onchain_root": ws.commit()}


if __name__ == "__main__":
    main()
