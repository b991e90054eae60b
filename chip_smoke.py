#!/usr/bin/env python3
"""Smoke run of risc0_tpu_torch on one CUDA card: python3 chip_smoke.py

Phases, one printed line or block each; any failure raises and exits
non-zero:

  1. device  - the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   - nvcc builds the kernels from risc0_tpu_torch/csrc
  3. kernels - every CUDA kernel against its plain torch version on the same
               CUDA inputs at main-path shapes, bit for bit (torch.equal),
               with both times
  4. check   - the fib seal at po2 6 proved on the card must equal the JAX
               package's seal (tests/data/fib_seal_po2_6_seed_0.npy)
  5. prove   - the main path: the loop guest executed at segment po2 20,
               proved on the card, verified by the port's verifier, a
               corrupted seal rejected; prove time, cycles/s, the stage
               table, peak device memory and each kernel's launch count
               (every count must be > 0)

The last two lines are a JSON object {"kernels": [...]} and
{"ok": true, "device": {...}}.  Imports nothing of jax.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PO2 = 20
RAND_Z = (1, 2, 3, 4)
TIMED_REPS = 3


def _count_for_po2(po2: int) -> int:
    # loop guest: ~2.02 cycles/iter + ~13k fixed; ~70% fill (bench.py:44-46)
    return max(1, int((0.70 * (1 << po2) - 13000) / 2.02))


def _sync_ms(fn, reps: int = 1):
    """Mean ms of `reps` calls timed with CUDA events; returns (ms, out)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _words(rng, shape, dev):
    return torch.from_numpy(
        rng.integers(0, 2013265921, shape, dtype=np.uint32).view(np.int32)
    ).to(dev)


def _max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_kernels(dev, kntt, kp2, ntt_mod):
    """Kernel vs plain at main-path shapes; returns {kernel: record}."""
    rng = np.random.default_rng(20)
    rec = {}

    def compare(name, shape_s, kernel, plain):
        kernel()  # warm-up: first launch, tables, allocator
        ms, got = _sync_ms(kernel, TIMED_REPS)
        plain_ms, want = _sync_ms(plain)
        err = _max_abs_err(got, want)
        equal = torch.equal(got, want)
        print(f"kernel {name} {shape_s}: equal={equal} max_abs_err={err} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
        if not equal:
            raise AssertionError(f"{name} {shape_s} differs from its plain "
                                 f"version (max abs err {err})")
        r = rec.setdefault(name, {"max_abs_err": 0, "ms": ms,
                                  "plain_ms": plain_ms, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(shape_s)
        del got, want
        torch.cuda.empty_cache()

    n22, n20 = 1 << 22, 1 << 20
    for cols in (211, 16):
        m = _words(rng, (cols, n22), dev)
        compare("hash_rows", f"({cols}, 2^22)", lambda: kp2.hash_rows(m),
                lambda: kp2.hash_rows_plain(m))
        del m
    layer = _words(rng, (2 * (n22 // 2), 8), dev)
    left, right = layer[0::2], layer[1::2]
    compare("hash_pairs", "(2^21, 8)", lambda: kp2.hash_pairs(left, right),
            lambda: kp2.hash_pairs_plain(left, right))
    del layer, left, right
    c = _words(rng, (211, n20), dev)
    x = ntt_mod.expand(c, 2)
    del c
    compare("evaluate_ntt", "expand((211, 2^20), 2)",
            lambda: kntt.evaluate_ntt(x, 2),
            lambda: kntt.evaluate_ntt_plain(x, 2))
    del x
    for rows, n in ((211, n20), (4, n22)):
        x = _words(rng, (rows, n), dev)
        compare("interpolate_ntt", f"({rows}, 2^{n.bit_length() - 1})",
                lambda: kntt.interpolate_ntt(x),
                lambda: kntt.interpolate_ntt_plain(x))
        del x
    return rec


def phase_check(dev):
    """The fib seal on the card equals the JAX package's seal."""
    from risc0_tpu_torch.circuit import fib

    want = np.load(os.path.join(ROOT, "tests", "data",
                                "fib_seal_po2_6_seed_0.npy"))
    t0 = time.perf_counter()
    got = fib.prove(po2=6, seed=0, device=dev)
    fib.verify(got, device=dev)
    same = np.array_equal(got, want)
    print(f"check fib po2 6 seal == JAX seal: {same} "
          f"({len(got)} words, {time.perf_counter() - t0:.2f} s)", flush=True)
    if not same:
        raise AssertionError("fib seal on the card differs from the JAX seal")


def phase_prove(dev, counters):
    from risc0_tpu import perf
    from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.verify.verifier import VerificationError

    with open(os.path.join(ROOT, "guests", "loop.bin"), "rb") as f:
        elf = f.read()
    t0 = time.perf_counter()
    env = ExecutorEnv(segment_po2=PO2).write_slice(
        _count_for_po2(PO2).to_bytes(4, "little"))
    seg = ExecutorImpl(env, elf).run().segments[0]
    print(f"prove: executed loop guest, segment po2 {seg.po2} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if seg.po2 != PO2:
        raise AssertionError(f"segment po2 {seg.po2} != {PO2}")

    for fn in counters:
        fn.launches = 0
    perf.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seal = prove_segment(seg, rand_z=RAND_Z, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    stages = perf.report()

    t0 = time.perf_counter()
    out = verify_rv32im_seal(seal)
    verify_s = time.perf_counter() - t0
    if len(out) != 90:
        raise AssertionError(f"verifier returned {len(out)} globals")
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    try:
        verify_rv32im_seal(bad)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted seal was accepted")

    cycles = 1 << seg.po2
    print(f"prove: po2 {seg.po2}, {cycles} cycles in {prove_s:.3f} s = "
          f"{cycles / prove_s:.1f} cycles/s; seal {len(seal)} words", flush=True)
    print(f"prove: verified in {verify_s:.2f} s; corrupted seal rejected "
          f"({rejected})", flush=True)
    print(f"prove: peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print("prove: stage table (s, calls)", flush=True)
    for path, (calls, secs) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        if "." not in path or path.startswith("commit_group."):
            print(f"  {secs:9.3f}  x{calls:<3d} {path}", flush=True)
    print(f"prove: launches {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from risc0_tpu_torch.core import ntt as ntt_mod
    from risc0_tpu_torch.hal.cuda import build
    from risc0_tpu_torch.hal.cuda import ntt as kntt
    from risc0_tpu_torch.hal.cuda import poseidon2 as kp2

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"build: {build.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rec = phase_kernels(dev, kntt, kp2, ntt_mod)
    phase_check(dev)
    counters = [kp2.hash_rows, kp2.hash_pairs, kntt.evaluate_ntt,
                kntt.interpolate_ntt]
    launches = phase_prove(dev, counters)

    meta = {
        "hash_rows": ("poseidon2.cu", "risc0_tpu/hal/pallas/poseidon2.py:121"),
        "hash_pairs": ("poseidon2.cu", "risc0_tpu/hal/pallas/poseidon2.py:149"),
        "evaluate_ntt": ("ntt.cu", "risc0_tpu/hal/pallas/ntt.py:124"),
        "interpolate_ntt": ("ntt.cu", "risc0_tpu/hal/pallas/ntt.py:186"),
    }
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"risc0_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches[name], "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        "shape": rec[name]["shapes"][0],
    } for name, (src, replaces) in meta.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
