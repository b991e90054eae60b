"""Guest profiling example (reference examples/profiling): run the loop
guest with the cycle profiler enabled and write a pprof protobuf.

    python -m risc0_tpu_torch.examples.profiling [OUT.pb] [--device cpu]
    # inspect with: go tool pprof -top OUT.pb

OUT.pb defaults to guest.pb in the system's temporary directory.
"""

from __future__ import annotations

import os
import tempfile

from .. import loop_guest
from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from .common import parse_args

LOOP_COUNT = 20000


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, lambda ap: ap.add_argument(
        "out", nargs="?",
        default=os.path.join(tempfile.gettempdir(), "guest.pb")))
    env = ExecutorEnv(segment_po2=16).write_slice(
        LOOP_COUNT.to_bytes(4, "little")).enable_profiler()
    session = ExecutorImpl(env, loop_guest.elf()).run()

    prof = env.profiler
    print(f"{session.user_cycles} user cycles profiled "
          f"({prof.total_cycles()} attributed)")
    for name, cycles in prof.top_functions(10):
        print(f"  {cycles:>10}  {name}")
    pprof = prof.encode_to_vec()
    with open(args.out, "wb") as f:
        f.write(pprof)
    print(f"pprof profile written to {args.out}")
    return {"session": session, "pprof": pprof, "out": args.out}


if __name__ == "__main__":
    main()
