"""The control of `correct`: a cell run with one guarantee of its
configuration broken, which the reference has to find.

    python zkbench/control.py --workload <cell> --seeds <n> [<n> ...]

The guarantee broken is the soundness of the seals: the program proves
with 25 FRI queries where the configuration states 50, the step that
would make FRI cheaper.  In a segment cell every seal is proved so.  In a
receipt cell the recursion proves are (the lift program verifies a
segment seal of 50 queries and no other), and the prover's self-check,
which would refuse such a receipt before returning it, is skipped, the
step that would save its seconds.  Each seed's run prints its result
line, and the control holds only if every one reads `correct` false.
The benchmark's own runs never plant it.
"""

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

QUERIES = 25


@contextmanager
def fewer_queries(n=QUERIES):
    from risc0_tpu_torch.prove import fri, prover
    from risc0_tpu_torch.verify import verifier

    saved = [(m, m.QUERIES) for m in (fri, prover, verifier)]
    for m, _ in saved:
        m.QUERIES = n
    try:
        yield
    finally:
        for m, q in saved:
            m.QUERIES = q


def plant(kind: str):
    """Plant the control for a cell of this traffic kind; returns an
    undo."""
    if kind == "segment":
        ctx = fewer_queries()
        ctx.__enter__()
        return lambda: ctx.__exit__(None, None, None)
    from risc0_tpu_torch.zkvm import receipt, recursion_driver

    lift = recursion_driver.lift
    self_check = receipt.Receipt.verify_integrity

    def lift_fewer(*args, **kw):
        with fewer_queries():
            return lift(*args, **kw)

    recursion_driver.lift = lift_fewer
    receipt.Receipt.verify_integrity = lambda self, ctx=None: None

    def undo():
        recursion_driver.lift = lift
        receipt.Receipt.verify_integrity = self_check

    return undo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from zkbench import harness, manifest

    root = os.path.dirname(manifest.HERE)
    cell = manifest.Cell(root, args.workload)
    seconds = cell.bench["run_seconds"]
    held = True
    for seed in args.seeds:
        undo = plant(cell.mix["kind"])
        try:
            result, lines = harness.run(args.workload, seed, seconds, 0, root,
                                        time.perf_counter())
        finally:
            undo()
        held &= not result["correct"]
        print(json.dumps({"seed": seed, "control": f"fri_queries_{QUERIES}",
                          **result}), flush=True)
    print(json.dumps({"control_held": held}), flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
