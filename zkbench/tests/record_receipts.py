"""Record receipt items of a cell on the card, for the CPU test of its
judge (a receipt takes minutes of CPU, so the test replays them):

    python zkbench/tests/record_receipts.py --workload ecdsa.succinct \\
        --seed 7 --items 2 --out zkbench/tests/data/ecdsa_succinct.npz

Item k is made exactly as a run makes it (inputs drawn from (seed, k));
the file keeps each item's segment seals, succinct seal, journal and exit
code.  With --control the items are made with the control planted.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from zkbench import harness, manifest  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--items", type=int, default=2)
    ap.add_argument("--out", required=True)
    ap.add_argument("--control", action="store_true",
                    help="plant zkbench/control.py's control first")
    args = ap.parse_args(argv)
    root = os.path.dirname(manifest.HERE)
    cell = manifest.Cell(root, args.workload)
    device = harness.card(cell.chips)
    ctx = harness.Context(cell, args.seed, device)
    traffic = cell.traffic_module().Traffic(ctx)
    if args.control:
        from zkbench import control

        control.plant(cell.mix["kind"])
    traffic.setup()
    recs = [traffic.warm] + [traffic.item(i) for i in range(args.items - 1)]
    out = {"seed": np.array(args.seed, np.int64)}
    for rec in recs:
        k = rec["k"]
        if "error" in rec:
            raise RuntimeError(rec["error"])
        out[f"k{k}_journal"] = np.frombuffer(rec["journal"], np.uint8)
        out[f"k{k}_exit"] = np.array([rec["exit"][1]], np.int64)
        out[f"k{k}_seal"] = rec["seal"]
        for j, (po2, seal) in enumerate(rec["segments"]):
            out[f"k{k}_seg{j}_po2"] = np.array(po2, np.int64)
            out[f"k{k}_seg{j}"] = seal
    np.savez(args.out, **out)
    checks = traffic.judge(recs[1:])
    print({k: v for k, v in checks.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
