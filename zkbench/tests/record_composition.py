"""Record a keccak.composition item on the card, for the CPU tests of its
judge (an item takes minutes of card time, so the tests replay it):

    python zkbench/tests/record_composition.py --seed 7 \\
        --out zkbench/tests/data/keccak_composition.npz

Item 0 is made exactly as a run's warm-up makes it (its start state drawn
from (seed, 1, 0)); the file keeps its segment seals, its succinct seal,
journal and exit code, each keccak batch the prover proved (its size,
po2, claim digest and the output words of its lift's seal), and the seal
of the segment's lift, whose claim still holds the root assumption.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from zkbench import harness, manifest  # noqa: E402

CELL = "keccak.composition"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(manifest.HERE)
    cell = manifest.Cell(root, CELL)
    device = harness.card(cell.chips)
    traffic = cell.traffic_module().Traffic(
        harness.Context(cell, args.seed, device))

    from risc0_tpu_torch.zkvm import recursion_driver

    lift, lifts = recursion_driver.lift, []

    def kept(*a, **kw):
        out = lift(*a, **kw)
        lifts.append(np.asarray(out.seal, np.uint32))
        return out

    recursion_driver.lift = kept
    try:
        traffic.setup()
    finally:
        recursion_driver.lift = lift
    rec = traffic.warm
    if "error" in rec:
        raise RuntimeError(rec["error"])
    out = {"seed": np.array(args.seed, np.int64),
           "journal": np.frombuffer(rec["journal"], np.uint8),
           "exit": np.array([rec["exit"][1]], np.int64),
           "seal": rec["seal"], "lift_seal": lifts[-1]}
    for j, (po2, seal) in enumerate(rec["segments"]):
        out[f"seg{j}_po2"] = np.array(po2, np.int64)
        out[f"seg{j}"] = seal
    for j, k in enumerate(rec["keccak"]):
        out[f"keccak{j}_n"] = np.array(k["n"], np.int64)
        out[f"keccak{j}_po2"] = np.array(k["po2"], np.int64)
        out[f"keccak{j}_claim"] = np.frombuffer(k["claim"], np.uint8)
        out[f"keccak{j}_out"] = k["out"]
    np.savez(args.out, **out)
    traffic.free()
    print({k: v for k, v in traffic.judge([]).items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
