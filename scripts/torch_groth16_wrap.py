#!/usr/bin/env python3
"""The whole stark-to-snark chain of risc0_tpu_torch on one CUDA card:

    python3 scripts/torch_groth16_wrap.py [--po2 20] [--crs-dir DIR]

ProverImpl(ProverOpts(receipt_kind="groth16", snark_prover="builtin"))
.prove of the loop guest at segment po2 `--po2` (one segment): the
segment proved on the card, lifted (lift_rv32im_<po2>), re-proved under
Poseidon254 with identity_p254 on the card, then shrink_wrap's host
Groth16 prove of the stark_verify circuit over the p254 seal (R1CS build,
CRS set-up or load, prove), the self-check, and Receipt.verify(image_id)
with the CRS's verifier parameters.  Each part is timed by wrapping the
function that does it; the p254 prove also prints its stage table and its
host Poseidon254 share.  The CRS of the builtin prover is made on first
use and kept in `--crs-dir` (default build/crs under the repository, which
git ignores; several GB).  The last two lines are the card's name and
power limit, and one JSON object with every time.  Fails without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(module, name, log, key, sync=None):
    """Wrap module.name so each call appends (key, seconds) to log."""
    inner = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            if sync is not None:
                sync()
            log.append((key, time.perf_counter() - t0))

    setattr(module, name, timed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--po2", type=int, default=20)
    ap.add_argument("--crs-dir", default=os.path.join(ROOT, "build", "crs"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_groth16_wrap: torch sees no CUDA device", file=sys.stderr)
        return 1
    os.environ["RISC0_TPU_CRS_DIR"] = args.crs_dir
    sys.path.insert(0, ROOT)
    from risc0_tpu_torch import loop_guest, perf
    from risc0_tpu_torch.groth16 import wrap as g16wrap
    from risc0_tpu_torch.hal.cuda import build
    from risc0_tpu_torch.zkvm import recursion_driver as drv
    from risc0_tpu_torch.zkvm import receipt as R
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    build.library()

    log = []
    sync = torch.cuda.synchronize
    _timed(ProverImpl, "prove_segment", log, "segment_prove", sync)
    _timed(drv, "lift", log, "lift", sync)
    _timed(g16wrap, "build_circuit", log, "r1cs_build")
    _timed(g16wrap, "ensure_crs", log, "crs")
    _timed(g16wrap, "prove", log, "groth16_prove")
    _timed(R.Groth16Receipt, "verify_integrity", log, "groth16_verify")

    # identity_p254 with its own stage table
    p254_stages, p254_peak = {}, []
    inner_id = drv.identity_p254

    def identity_p254(*a, **kw):
        perf.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = inner_id(*a, **kw)
        sync()
        log.append(("identity_p254", time.perf_counter() - t0))
        p254_stages.update(perf.report())
        p254_peak.append(torch.cuda.max_memory_allocated() / 2**30)
        return out

    drv.identity_p254 = identity_p254

    with open(loop_guest.ELF, "rb") as f:
        elf = f.read()
    count = loop_guest.count_for_po2(args.po2)
    env = ExecutorEnv(segment_po2=args.po2).write_slice(
        count.to_bytes(4, "little"))
    image_id = ExecutorImpl(env, elf).compute_image_id()
    prover = ProverImpl(ProverOpts(receipt_kind="groth16",
                                   snark_prover="builtin"), device="cuda")
    t0 = time.perf_counter()
    info = prover.prove(env, elf)
    total_s = time.perf_counter() - t0
    segs = [s.po2 for s in info.session.segments]
    if segs != [args.po2]:
        raise AssertionError(f"the session's segments are of po2 {segs}")

    t0 = time.perf_counter()
    params = g16wrap.verifier_parameters()
    info.receipt.verify(image_id, R.VerifierContext(groth16_params=params))
    verify_s = time.perf_counter() - t0
    g = info.receipt.inner.value
    if info.receipt.inner.kind != "groth16" or len(g.seal) != 256:
        raise AssertionError("the receipt is not a Groth16 receipt")

    parts = {}
    for key, secs in log:
        parts.setdefault(key, []).append(round(secs, 3))
    host = {}
    for path, (_calls, secs) in p254_stages.items():
        leaf = path.split(".")[-1]
        if leaf.startswith("poseidon254_"):
            host[leaf] = host.get(leaf, 0.0) + secs
    top = {k: round(v[1], 3) for k, v in p254_stages.items()
           if "." not in k or (k.startswith("commit_group.")
                               and k.count(".") == 1)}
    for key, secs in log:
        print(f"wrap: {key} {secs:.3f} s", flush=True)
    print(f"wrap: identity_p254 stages {json.dumps(top)}; host Poseidon254 "
          f"{json.dumps({k: round(v, 3) for k, v in host.items()})}; peak "
          f"device memory {p254_peak[0]:.2f} GiB", flush=True)
    print(f"wrap: ProverImpl(groth16).prove {total_s:.3f} s; "
          f"Receipt.verify(image_id) passed in {verify_s:.3f} s; seal "
          f"{bytes(g.seal).hex()[:32]}...", flush=True)
    print(card, flush=True)
    print(json.dumps({"po2": args.po2, "prove_s": round(total_s, 3),
                      "parts_s": parts, "p254_stages_s": top,
                      "p254_host_s": {k: round(v, 3)
                                      for k, v in host.items()},
                      "p254_peak_gib": round(p254_peak[0], 3),
                      "receipt_verify_s": round(verify_s, 3),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
