#!/usr/bin/env python3
"""Time the rv32im prove of risc0_tpu_torch from two source trees on one
CUDA card, in turns (A B B A by default):

    python3 scripts/torch_prove_ab.py TREE_A TREE_B [--order ABBA] [--po2 20]

Each turn is one subprocess that imports the port from its tree, builds the
kernels, executes the loop guest at segment po2 `--po2`, proves the
segment twice and prints one JSON line with both proves' seconds, the
second (warm) prove's stage table and peak device memory, and the seal's
SHA-256.  Every turn must give the same seal.  The last line is a JSON
summary: the warm prove seconds of each tree in turn order.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def turn(tree: str, po2: int) -> dict:
    sys.path.insert(0, tree)
    import torch
    from risc0_tpu_torch import loop_guest, perf
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.hal.cuda import build

    build.library()
    seg = loop_guest.segment(po2)
    times, seal = [], None
    for _ in range(2):
        perf.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seal = prove_segment(seg, rand_z=loop_guest.RAND_Z,
                             device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stages = {k: round(v[1], 6) for k, v in perf.report().items()
              if "." not in k or k.startswith("commit_group.")}
    return {"tree": tree, "prove_s": times, "po2": seg.po2,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "stages_s": stages,
            "seal_sha256": hashlib.sha256(seal.tobytes()).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--po2", type=int, default=20)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(turn(os.path.abspath(a.turn), a.po2)), flush=True)
        return 0
    if len(a.trees) != 2:
        ap.error("give two trees")
    trees = {"A": os.path.abspath(a.trees[0]),
             "B": os.path.abspath(a.trees[1])}
    results = []
    for key in a.order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[key],
             "--po2", str(a.po2)], cwd=trees[key], capture_output=True,
            text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["key"] = key
        print(json.dumps(rec), flush=True)
        results.append(rec)
    seals = {r["seal_sha256"] for r in results}
    summary = {"seals_equal": len(seals) == 1,
               "warm_prove_s": [[r["key"], r["prove_s"][1]] for r in results]}
    print(json.dumps(summary), flush=True)
    return 0 if len(seals) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
