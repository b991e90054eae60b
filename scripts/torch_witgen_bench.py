#!/usr/bin/env python3
"""Time the rv32im witness generation of risc0_tpu_torch on one CUDA card:
the host C++ (witgen.witgen_exec, witgen.witgen_accum) against the device
witgens (exec_device, accum_device) at several chunk sizes.

    python3 scripts/torch_witgen_bench.py [--po2 20] [--reps 2]
        [--p2-chunk 16 17] [--full-chunk 16 17] [--profile]

Executes the loop guest at segment po2 `--po2`, runs each side `--reps`
times (the device side synchronised; the first device run also uploads
its plans) and checks every device result against the host's, bit for
bit.  Chunks are given as log2 rows.  --profile adds one run of each
device witgen under torch.profiler and counts its kernels.  One JSON line
a measurement; the last line is the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from risc0_tpu_torch import field as F  # noqa: E402
from risc0_tpu_torch import loop_guest  # noqa: E402
from risc0_tpu_torch.circuit.rv32im import accum_device as AD  # noqa: E402
from risc0_tpu_torch.circuit.rv32im import exec_device as ED  # noqa: E402
from risc0_tpu_torch.circuit.rv32im import witgen  # noqa: E402
from risc0_tpu_torch.convert import to_numpy  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def kernels(fn) -> dict:
    """Device events of one run of fn under torch.profiler, by class."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"kernels": 0, "memcpy": 0, "memset": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = ("memcpy" if "memcpy" in name else
               "memset" if "memset" in name else "kernels")
        counts[key] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--po2", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--p2-chunk", type=int, nargs="+", default=[16])
    ap.add_argument("--full-chunk", type=int, nargs="+", default=[16])
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    seg = loop_guest.segment(a.po2)
    rz = loop_guest.RAND_Z
    mix = np.random.default_rng(7).integers(0, F.P, 36).astype(np.uint32)

    host_s = []
    for _ in range(a.reps):
        s, host = timed(lambda: witgen.witgen_exec(seg, rand_z=rz))
        host_s.append(s)
    acc_s = []
    for _ in range(a.reps):
        s, host_acc = timed(lambda: witgen.witgen_accum(host, mix))
        acc_s.append(s)
    print(json.dumps({"side": "host", "rows": host["rows"],
                      "exec_s": host_s, "accum_s": acc_s}), flush=True)

    pf = host["preflight"]
    for p2 in a.p2_chunk:
        times, res = [], None
        for _ in range(a.reps):
            res = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            s, res = timed(lambda: ED.witgen_exec_device(
                seg, rand_z=rz, pf=dict(pf), device=dev,
                p2_chunk=1 << p2))
            times.append(s)
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = (np.array_equal(to_numpy(res["data"]), host["data"]) and
                all(np.array_equal(res[k], host[k]) for k in
                    ("global", "tables_u8", "tables_u16")))
        rec = {"side": "device", "witgen": "exec", "p2_chunk_log2": p2,
               "s": times, "peak_gib": peak, "equal": same}
        if a.profile:
            rec["launches"] = kernels(lambda: ED.witgen_exec_device(
                seg, rand_z=rz, pf=dict(pf), device=dev, p2_chunk=1 << p2))
        print(json.dumps(rec), flush=True)
        if not same:
            return 1
    res = None
    for full in a.full_chunk:
        times, got = [], None
        for _ in range(a.reps):
            got = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            s, got = timed(lambda: AD.witgen_accum_device(
                host, mix, device=dev, chunk=1 << full))
            times.append(s)
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = np.array_equal(F.decode_np(to_numpy(got)), host_acc)
        rec = {"side": "device", "witgen": "accum", "full_chunk_log2": full,
               "s": times, "peak_gib": peak, "equal": same}
        if a.profile:
            rec["launches"] = kernels(lambda: AD.witgen_accum_device(
                host, mix, device=dev, chunk=1 << full))
        print(json.dumps(rec), flush=True)
        if not same:
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
