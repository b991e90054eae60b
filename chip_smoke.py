#!/usr/bin/env python3
"""Smoke run of risc0_tpu_torch on one CUDA card: python3 chip_smoke.py

Phases, one printed line or block each; any failure raises and exits
non-zero:

  1. device  - the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   - nvcc builds the kernels from risc0_tpu_torch/csrc
  3. kernels - every CUDA kernel against its plain torch version on the same
               CUDA inputs at every shape the prove gives it, bit for bit
               (torch.equal), with the kernel's time (CUDA events, warm,
               mean of TIMED_REPS), the plain version's, and the bound:
               the larger of the bytes over 3.35 TB/s and the 32-bit
               multiplies (3 per Montgomery product) over 132 SMs x 64 a
               clock x 1.98 GHz.  The pair kernel runs as the Merkle fold
               of each tree of the prove and as one layer; both Poseidon2
               kernels also meet words at the edges of their lazy bounds
  4. check   - the fib seal at po2 6 proved on the card must equal the JAX
               package's seal (tests/data/fib_seal_po2_6_seed_0.npy)
  5. prove   - the main path: the loop guest executed at segment po2 20,
               proved on the card, verified by the port's verifier, a
               corrupted seal rejected; prove time, cycles/s, the stage
               table (device times: every top-level scope synchronises
               the card), peak device memory and each kernel's launch
               count (every count must be > 0)

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
TIMED_REPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit integer
# multiplies/s (132 SMs x 64 IMAD lanes x 1.98 GHz boost clock)
P = 2013265921  # BabyBear
HBM_BYTES_S = 3.35e12
MUL32_S = 132 * 64 * 1.98e9
MUL32_PER_PRODUCT = 3  # Montgomery product: a*b (lo, hi), M*low, red*P
P2_PRODUCTS = 8 * 24 * 4 + 21 * (4 + 24)  # one Poseidon2 permutation: 1356


def _bound(bytes_moved: float, products: float):
    """(bound_ms, bound_by): the least time for these bytes and products."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = products * MUL32_PER_PRODUCT / MUL32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ntt_bound(batch: int, n_bits: int, stages: int, scale: bool):
    n = 1 << n_bits
    products = batch * (n // 2) * stages + (batch * n if scale else 0)
    return _bound(2 * 4 * batch * n, products)


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
    """Kernel vs plain at the prove's shapes; returns {kernel: record of its
    first (main-path) shape}.  A record holds the largest error over all
    of the kernel's shapes."""
    rng = np.random.default_rng(20)
    rec = {}

    def compare(name, shape_s, kernel, plain, bound, reps=TIMED_REPS):
        kernel()  # warm-up: first launch, tables, allocator
        ms, got = _sync_ms(kernel, reps)
        plain_ms, want = _sync_ms(plain)
        if isinstance(got, list):  # the fold's layers
            got, want = torch.cat(got), torch.cat(want)
        err = _max_abs_err(got, want)
        equal = torch.equal(got, want)
        bound_ms, bound_by = bound
        print(f"kernel {name} {shape_s}: equal={equal} max_abs_err={err} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) "
              f"share={bound_ms / ms:.1%}", flush=True)
        if not equal:
            raise AssertionError(f"{name} {shape_s} differs from its plain "
                                 f"version (max abs err {err})")
        r = rec.setdefault(name, {"max_abs_err": 0, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by, "shape": shape_s})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del got, want
        torch.cuda.empty_cache()

    # hash_rows at every shape of the prove: data, accum, check and code
    # groups, the FRI rounds, the final FRI digest (prove/fri.py)
    n22 = 1 << 22
    big = _words(rng, (211, n22), dev)
    for cols, bits in ((211, 22), (103, 22), (16, 22), (1, 22), (64, 18),
                       (64, 14), (64, 10), (1024, 0)):
        m = big[:cols] if bits == 22 else _words(rng, (cols, 1 << bits), dev)
        perms = (1 << bits) * max(1, -(-cols // 16))
        compare("hash_rows", f"({cols}, 2^{bits})", lambda: kp2.hash_rows(m),
                lambda: kp2.hash_rows_plain(m),
                _bound(4 * (cols + 8) * (1 << bits), perms * P2_PRODUCTS),
                TIMED_REPS if bits >= 18 else 20)
        del m
    del big
    # the Merkle fold above the leaves of each tree of the prove: 2^n - 1
    # compressions, the leaves read once and every layer written once
    for bits in (22, 18, 14, 10):
        leaves = _words(rng, (1 << bits, 8), dev)
        compare("hash_pairs", f"fold 2^{bits} leaves",
                lambda: kp2.merkle_fold(leaves),
                lambda: kp2.merkle_fold_plain(leaves),
                _bound(32 * ((1 << bits) + (1 << bits) - 1),
                       ((1 << bits) - 1) * P2_PRODUCTS),
                TIMED_REPS if bits >= 18 else 20)
        del leaves
    # one layer of the pair kernel: hash_pairs(left, right)
    layer = _words(rng, (n22, 8), dev)
    left, right = layer[0::2], layer[1::2]
    compare("hash_pairs", "(2^21, 8)", lambda: kp2.hash_pairs(left, right),
            lambda: kp2.hash_pairs_plain(left, right),
            _bound(4 * 3 * 8 * (n22 // 2), (n22 // 2) * P2_PRODUCTS))
    del layer, left, right
    # words at the edges of the kernels' lazy bounds: all 0, all P - 1, and
    # those mixed with 1, P - 2 and the Montgomery one
    edge = np.array([0, 1, P - 1, P - 2, (1 << 32) % P], np.uint32)
    for label, fill in (("all 0", 0), ("all P-1", P - 1), ("mixed", None)):
        words = (np.full((64, 1 << 12), fill, np.uint32) if fill is not None
                 else rng.choice(edge, (64, 1 << 12)))
        m = torch.from_numpy(words.view(np.int32)).to(dev)
        leaves = m.reshape(-1, 8)[: 1 << 12]
        for name, kernel, plain in (
                ("hash_rows", kp2.hash_rows(m), kp2.hash_rows_plain(m)),
                ("hash_pairs", torch.cat(kp2.merkle_fold(leaves)),
                 torch.cat(kp2.merkle_fold_plain(leaves)))):
            equal = torch.equal(kernel, plain)
            print(f"kernel {name} edge words {label}: equal={equal}",
                  flush=True)
            if not equal:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"on edge words ({label})")

    # evaluate: the commit LDEs (data chunks of 32, accum 103, one data
    # group at once), 2^23 and 2^24, and an expand at or above k1
    k1_22 = kntt.split(22)[0]
    cases = [(211, 20, 2), (32, 20, 2), (103, 20, 2), (2, 21, 2), (2, 22, 2),
             (2, 22 - k1_22 - 1, k1_22 + 1)]
    for rows, c_bits, eb in cases:
        c = _words(rng, (rows, 1 << c_bits), dev)
        x = ntt_mod.expand(c, eb)
        del c
        n_bits = c_bits + eb
        shape_s = (f"expand(({rows}, 2^{c_bits}), {eb})" if eb == 2 else
                   f"({rows}, 2^{n_bits}) expand_bits {eb}")
        compare("evaluate_ntt", shape_s, lambda: kntt.evaluate_ntt(x, eb),
                lambda: kntt.evaluate_ntt_plain(x, eb),
                _ntt_bound(rows, n_bits, n_bits - eb, False))
        del x
    # interpolate: the commit iNTTs, the check poly, 2^23 and 2^24
    for rows, n_bits in ((211, 20), (32, 20), (103, 20), (4, 22), (2, 23),
                         (2, 24)):
        x = _words(rng, (rows, 1 << n_bits), dev)
        compare("interpolate_ntt", f"({rows}, 2^{n_bits})",
                lambda: kntt.interpolate_ntt(x),
                lambda: kntt.interpolate_ntt_plain(x),
                _ntt_bound(rows, n_bits, n_bits, True))
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
    from risc0_tpu_torch import loop_guest, perf
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.verify.verifier import VerificationError

    t0 = time.perf_counter()
    seg = loop_guest.segment(PO2)
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
    seal = prove_segment(seg, rand_z=loop_guest.RAND_Z, device=dev)
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
    print("prove: stage table (s, calls; each top-level scope ends in a "
          "device sync)", flush=True)
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
        "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
        "library_ms": None,  # no PyTorch call computes these functions
        "shape": rec[name]["shape"],
    } for name, (src, replaces) in meta.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
