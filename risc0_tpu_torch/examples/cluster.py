"""Cluster deployment example (reference r0vm actor cluster +
testdata/default.toml): launch an executor and a prover pool from a TOML
config and push a multi-segment proof job through the DAG (execute ->
prove -> lift -> join tree -> resolve).  The cluster is simulated, as
the JAX example's: its pools and the job prove on the DevModeProver with
the latencies of the config's [prover.simulate] table.

    python -m risc0_tpu_torch.examples.cluster [--device cpu]
"""

from __future__ import annotations

from .. import loop_guest
from ..parallel.config import launch_cluster, load_config
from ..parallel.scheduler import ProofJob
from ..zkvm.exec import ExecutorEnv
from ..zkvm.prover import DevModeProver
from .common import parse_args

CONFIG = """
version = 1

[executor]
count = 1

[[prover]]
count = 4
subscribe = ["prove-segment", "lift", "join", "union", "resolve", "unwrap"]

[prover.simulate]
prove_segment_core = 0.05
lift = 0.02
join = 0.02
"""
LOOP_COUNT = 1024 * 494 + 818  # ~1M cycles -> multiple segments


def main(argv=None) -> dict:
    parse_args(argv, __doc__)
    cluster = launch_cluster(load_config(CONFIG))
    try:
        env = ExecutorEnv(segment_po2=16).write_slice(
            LOOP_COUNT.to_bytes(4, "little"))
        job = ProofJob(cluster.factory, DevModeProver(), env,
                       loop_guest.elf())
        session, receipt = job.run()
        print(f"{len(session.segments)} segments -> 1 receipt "
              f"(exit: {receipt.claim.exit_code.kind})")
    finally:
        cluster.stop()
    return {"elf": loop_guest.elf(), "session": session, "receipt": receipt}


if __name__ == "__main__":
    main()
