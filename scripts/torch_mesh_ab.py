#!/usr/bin/env python3
"""The sharded path over every card of the machine, against one card.

    python3 scripts/torch_mesh_ab.py

Proves the po2 20 loop segment on the first card and under mesh_context
over every card (the card twice when there is one), in turns (one, mesh,
mesh, one): every seal must be the same bytes, and it must verify.  Then
times a warm commit of a card-resident seeded (211, 2^20) witness on one
card and over the mesh in the same turns (mean of REPS commits each, every
card synchronised); the two commits must be equal layer for layer.  Prints
each prove's time and each card's peak memory under the mesh.  Needs at
least one CUDA card; meant for several.
"""

import contextlib
import hashlib
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

PO2 = 20
REPS = 5
P = 2013265921


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _wall_s(fn):
    _sync_all()
    t0 = time.perf_counter()
    out = fn()
    _sync_all()
    return time.perf_counter() - t0, out


def _mean_ms(fn) -> float:
    fn()
    secs, _ = _wall_s(lambda: [fn() for _ in range(REPS)])
    return secs / REPS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.hal import torch_hal as hal
    from risc0_tpu_torch.hal.cuda import build
    from risc0_tpu_torch.parallel.sharded import commit_sharded, mesh_context

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    count = torch.cuda.device_count()
    names = ([f"cuda:{i}" for i in range(count)] if count > 1
             else ["cuda:0", "cuda:0"])
    dev = torch.device("cuda", 0)
    print(f"mesh: {names}", flush=True)
    build.library()
    seg = loop_guest.segment(PO2)

    def prove():
        return prove_segment(seg, rand_z=loop_guest.RAND_Z, device=dev)

    for c in range(count):  # the memory stats of a card need its allocator
        torch.zeros(1, device=torch.device("cuda", c))
    seal, peaks, times = None, None, {"one": [], "mesh": []}
    for label in ("one", "mesh", "mesh", "one"):
        for c in range(count):
            torch.cuda.reset_peak_memory_stats(c)
        with mesh_context(names) if label == "mesh" else \
                contextlib.nullcontext():
            secs, got = _wall_s(prove)
        times[label].append(secs)
        if label == "mesh" and peaks is None:
            peaks = [torch.cuda.max_memory_allocated(c) / 2**30
                     for c in range(count)]
        if seal is None:
            seal = got
        elif not np.array_equal(seal, got):
            raise AssertionError(f"the {label} seal differs from the first")
    verify_rv32im_seal(seal)
    print(f"po2 {seg.po2} prove (one, mesh, mesh, one): one card "
          + ", ".join(f"{t:.3f}" for t in times["one"]) + " s, the mesh "
          + ", ".join(f"{t:.3f}" for t in times["mesh"]) + " s (peak "
          + ", ".join(f"cuda:{c} {p:.2f} GiB" for c, p in enumerate(peaks))
          + f"); every seal SHA-256 "
          f"{hashlib.sha256(seal.tobytes()).hexdigest()}, verified",
          flush=True)

    shape = (211, 1 << PO2)
    witness = torch.from_numpy(np.random.default_rng(13).integers(
        0, P, shape, dtype=np.uint32).view(np.int32)).to(dev)
    runs = {"one": lambda: hal.commit_pipeline(witness, device=dev),
            "mesh": lambda: commit_sharded(witness, names)}
    want, got = runs["one"](), runs["mesh"]()
    equal = all(torch.equal(a, b) for a, b in zip(want[:2], got[:2])) and \
        len(want[2]) == len(got[2]) and \
        all(torch.equal(a, b) for a, b in zip(want[2], got[2]))
    print(f"commit of {shape}: the mesh's equal to one card's, every "
          f"layer: {equal}", flush=True)
    if not equal:
        raise AssertionError("the mesh commit differs from one card's")
    del want, got
    for label in ("one", "mesh", "mesh", "one"):
        print(f"warm commit of a card-resident {shape} witness, {label}: "
              f"{_mean_ms(runs[label]):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
