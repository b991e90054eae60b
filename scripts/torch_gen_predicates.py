#!/usr/bin/env python3
"""Generate the repository's own recursion predicates with the PyTorch port
(risc0_tpu_torch.circuit.recursion.predicates.generate) and their
allowed-control-IDs set, the control IDs committed on --device.

    python scripts/torch_gen_predicates.py --po2s 14,20 --join --union --check
    python scripts/torch_gen_predicates.py --device cpu --po2s 14 --check

Writes OUT/<name>.zkr.xz for each program and OUT/own_control_ids.npz
(names, ids, root and, with --identity, identity_p254): the set found in
OUT before, else the vendored one, with the generated IDs in their places.
--check compares every program word for word and its ID with the vendored
ones, rebuilds the allowed root from the vendored ID list with the
generated IDs in their places and compares it with the vendored root, and
exits 1 on any difference.  On the CPU each control ID (a commit of a
(23, 2^18) code group) takes a minute or two.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from risc0_tpu_torch.circuit.recursion import predicates as pr  # noqa: E402

FLAGS = (
    ("join", ("join",)),
    ("resolve", ("resolve",)),
    ("identity", ("identity",)),
    ("union", ("union",)),
    ("povw", ("join_povw", "join_unwrap_povw", "unwrap_povw",
              "resolve_povw", "resolve_unwrap_povw")),
    ("keccak", tuple(f"keccak_lift_{po2}" for po2 in range(14, 19))),
)


def _po2s(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--po2s", default="",
                    help="lift_rv32im_{po2} programs, comma-separated")
    ap.add_argument("--povw-po2s", default="",
                    help="lift_rv32im_povw_{po2} programs")
    ap.add_argument("--join", action="store_true")
    ap.add_argument("--resolve", action="store_true")
    ap.add_argument("--identity", action="store_true",
                    help="identity, and its Poseidon254 control ID")
    ap.add_argument("--union", action="store_true")
    ap.add_argument("--povw", action="store_true",
                    help="join_povw, join_unwrap_povw, unwrap_povw, "
                         "resolve_povw and resolve_unwrap_povw")
    ap.add_argument("--keccak", action="store_true",
                    help="the released keccak_lift_{14..18} IDs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=pr.DEFAULT_OUT)
    ap.add_argument("--check", action="store_true",
                    help="compare with the vendored programs, IDs and root")
    a = ap.parse_args(argv)

    names = [f"lift_rv32im_{p}" for p in _po2s(a.po2s)]
    names += [f"lift_rv32im_povw_{p}" for p in _po2s(a.povw_po2s)]
    for flag, progs in FLAGS:
        if getattr(a, flag):
            names += progs
    if not names:
        ap.error("no program named")

    def log(r):
        print(f"  {r['name']}: {r['rows']} rows, emitted in "
              f"{r['emit_s']:.2f} s, control ID "
              f"{r['control_id'].tobytes().hex()} committed in "
              f"{r['commit_s']:.2f} s; SHA-256 {r['sha256']}", flush=True)

    t0 = time.perf_counter()
    result = pr.generate(names, device=a.device, out_dir=a.out,
                         identity_p254=a.identity, log=log)
    if result["identity_p254"] is not None:
        print(f"  identity_p254 control ID "
              f"{result['identity_p254'].tobytes().hex()}")
    print(f"wrote {len(names)} programs and own_control_ids.npz to {a.out}; "
          f"allowed root {result['root'].tobytes().hex()} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not a.check:
        return 0
    diffs = pr.compare_vendored(result)
    for d in diffs:
        print(f"check: {d}")
    print("check: FAILED" if diffs else
          "check: every program, ID and the root equal the vendored ones")
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
