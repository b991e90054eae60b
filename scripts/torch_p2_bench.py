#!/usr/bin/env python3
"""Time the Poseidon2 kernels of risc0_tpu_torch from one or more source
trees on one CUDA card, in turns, and count their SASS instructions:

    python3 scripts/torch_p2_bench.py TREE [TREE ...] [--order ABBA]
                                      [--sass] [--pipes]

Each turn is one subprocess that imports the port from its tree, builds
the kernels and prints one JSON line: the mean kernel ms (CUDA events,
warm) of `hash_rows` at every shape a po2 20 prove gives it, of the
Merkle fold above the leaves of the prove's trees (the tree's
`merkle_fold` where it has one, else its loop of `hash_pairs` over the
layers) and of one `hash_pairs` layer of 2^21 digests.  `--order` picks
the trees by letter (A = first tree); the default runs each tree once.

`--sass` adds, per tree, the `-Xptxas -v` lines of the Poseidon2 kernels
and the opcode classes of each kernel and of each loop in it (a region
closed by a backward branch), from `cuobjdump -sass` of the built library.
`--pipes` runs a probe of the card's integer pipes first: warp
instructions per SM and clock of dependent chains of each kind.
"""

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

ALU = {"IADD3", "IMNMX", "VIMNMX", "ISETP", "SEL", "LOP3", "SHF", "LEA",
       "IADD", "IABS", "PRMT", "PLOP3", "FLO", "POPC", "BMSK", "SGXT",
       "VIADD", "VIADDMNMX", "IMNMX3"}
FMA = {"IMAD", "IMUL", "IMUL32I", "IMAD32I"}
FP64 = {"DADD", "DFMA", "DMUL", "DSETP", "DMNMX"}

ROWS_SHAPES = [(211, 22), (103, 22), (16, 22), (1, 22), (64, 18), (64, 14),
               (64, 10), (1024, 0)]
TREE_BITS = [22, 18, 14, 10]


def _tool(name: str) -> str:
    path = os.path.join("/usr/local/cuda/bin", name)
    return path if os.path.exists(path) else name


def opclass(op: str) -> str:
    base = op.split(".")[0]
    if base in FMA:
        return "fma"
    if base in ALU:
        return "alu"
    if base in FP64:
        return "fp64"
    if base.startswith(("LD", "ST", "ATOM", "RED")):
        return "mem"
    if base in ("MOV", "S2R", "CS2R", "S2UR", "R2UR", "UMOV", "MOV32I"):
        return "move"
    if base.startswith("U"):
        return "uniform"
    return "other"


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_report(so: str, names) -> dict:
    """Opcode classes of each kernel whose name holds one of `names`, and
    of every loop (backward-branch region) in it."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = max((n for n in names if n in m.group(1)), key=len,
                      default=None)
            if cur:
                funcs[cur] = []
            continue
        m = _INSN.search(line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2),
                               m.group(3)))
    rep = {}
    for name, insns in funcs.items():
        insns = [i for i in insns if i[1] != "NOP"]
        total = Counter(opclass(op) for _, op, _ in insns)
        loops = []
        for addr, op, args in insns:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                body = [o for a, o, _ in insns if lo <= a <= addr]
                loops.append({"from": hex(lo), "to": hex(addr),
                              "classes": dict(Counter(map(opclass, body))),
                              "ops": dict(Counter(body))})
        rep[name] = {"total": dict(total),
                     "ops": dict(Counter(op for _, op, _ in insns)),
                     "loops": loops}
    return rep


PROBE = r"""
#include <cstdint>
#define CHAINS 8
#define BODY(expr) \
  long long t0 = clock64(); \
  _Pragma("unroll 1") for (int i = 0; i < iters; ++i) { _Pragma("unroll") \
    for (int k = 0; k < CHAINS; ++k) { expr; } } \
  long long t1 = clock64(); \
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
extern "C" __global__ void probe_alu(uint32_t* o, uint32_t b, uint32_t c,
                                     int iters, long long* cyc) {
  uint32_t x[CHAINS];
  for (int k = 0; k < CHAINS; ++k) x[k] = threadIdx.x * 7 + k;
  BODY(x[k] = min(x[k] + b, x[k] - c))
  uint32_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= x[k];
  o[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void probe_imad(uint32_t* o, uint32_t b, uint32_t c,
                                      int iters, long long* cyc) {
  uint32_t x[CHAINS];
  for (int k = 0; k < CHAINS; ++k) x[k] = threadIdx.x * 7 + k;
  BODY(x[k] = x[k] * b + c)
  uint32_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= x[k];
  o[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void probe_imad_wide(uint32_t* o, uint32_t b,
                                           uint32_t c, int iters,
                                           long long* cyc) {
  uint64_t x[CHAINS];
  for (int k = 0; k < CHAINS; ++k) x[k] = threadIdx.x * 7 + k + c;
  BODY(x[k] = (uint64_t)(uint32_t)x[k] * b + x[k])
  uint64_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= x[k];
  o[blockIdx.x * blockDim.x + threadIdx.x] = (uint32_t)(s ^ (s >> 32));
}
extern "C" __global__ void probe_imad_hi(uint32_t* o, uint32_t b, uint32_t c,
                                         int iters, long long* cyc) {
  uint32_t x[CHAINS];
  for (int k = 0; k < CHAINS; ++k) x[k] = threadIdx.x * 7 + k;
  BODY(x[k] = __umulhi(x[k], b) + c)
  uint32_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= x[k];
  o[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void probe_dfma(uint32_t* o, uint32_t b, uint32_t c,
                                      int iters, long long* cyc) {
  double x[CHAINS];
  const double db = 1.0 + b * 1e-12, dc = c * 1e-3;
  for (int k = 0; k < CHAINS; ++k) x[k] = threadIdx.x * 7 + k;
  BODY(x[k] = __fma_rn(x[k], db, dc))
  double s = 0;
  for (int k = 0; k < CHAINS; ++k) s += x[k];
  o[blockIdx.x * blockDim.x + threadIdx.x] = (uint32_t)s;
}
extern "C" int probe(int which, uint32_t* o, int iters, long long* cyc,
                     int blocks, int threads) {
  void (*k[])(uint32_t*, uint32_t, uint32_t, int, long long*) = {
      probe_alu, probe_imad, probe_imad_wide, probe_imad_hi, probe_dfma};
  k[which]<<<blocks, threads>>>(o, 0x9e3779b9u, 12345u, iters, cyc);
  return (int)cudaGetLastError();
}
"""


def pipes(build_dir: str) -> dict:
    """Warp instructions per SM and clock of each probe's loop body (from
    its SASS), one 1024-thread block per SM."""
    import ctypes as C
    import torch

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "pipe_probe.cu")
    so = os.path.join(build_dir, "pipe_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True)
    lib = C.CDLL(so)
    lib.probe.argtypes = [C.c_int, C.c_void_p, C.c_int, C.c_void_p, C.c_int,
                          C.c_int]
    names = ["probe_alu", "probe_imad", "probe_imad_wide", "probe_imad_hi",
             "probe_dfma"]
    sass = sass_report(so, names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 1024, 4096
    o = torch.empty(sms * threads, dtype=torch.int32, device="cuda")
    cyc = torch.empty(sms, dtype=torch.int64, device="cuda")
    res = {}
    for i, name in enumerate(names):
        for _ in range(2):
            assert lib.probe(i, o.data_ptr(), iters, cyc.data_ptr(), sms,
                             threads) == 0
        torch.cuda.synchronize()
        loop = min(sass[name]["loops"], key=lambda l: len(l["ops"]))
        cycles = int(cyc.max())
        res[name] = {"loop_ops": loop["ops"], "sm_cycles": cycles,
                     "warp_insns_per_sm_clock": {
                         k: (threads // 32) * iters * v / cycles
                         for k, v in loop["classes"].items()}}
    return res


def _ms(torch, fn, reps):
    fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def turn(tree: str, sass: bool) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from risc0_tpu_torch.hal.cuda import build
    from risc0_tpu_torch.hal.cuda import poseidon2 as kp2

    so = str(build.build())
    build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)

    def words(shape):
        return torch.from_numpy(rng.integers(0, 2013265921, shape,
                                             dtype=np.uint32).view(np.int32)
                                ).to(dev)

    fold = getattr(kp2, "merkle_fold", None)
    if fold is None:
        def fold(cur):
            layers = []
            while cur.shape[0] > 1:
                cur = kp2.hash_pairs(cur[0::2], cur[1::2])
                layers.append(cur)
            return layers

    rec = {"tree": tree, "hash_rows_ms": {}, "fold_ms": {}}
    for cols, bits in ROWS_SHAPES:
        m = words((cols, 1 << bits))
        reps = 5 if cols * (1 << bits) >= 1 << 26 else 20
        rec["hash_rows_ms"][f"({cols}, 2^{bits})"] = _ms(
            torch, lambda: kp2.hash_rows(m), reps)
        del m
    for bits in TREE_BITS:
        leaves = words((1 << bits, 8))
        launches = kp2.hash_pairs.launches
        fold(leaves)
        rec.setdefault("fold_launches", {})[f"2^{bits}"] = \
            kp2.hash_pairs.launches - launches
        rec["fold_ms"][f"2^{bits}"] = _ms(torch, lambda: fold(leaves),
                                          5 if bits >= 18 else 20)
        del leaves
    layer = words((1 << 22, 8))
    left, right = layer[0::2], layer[1::2]
    rec["hash_pairs_ms"] = {"(2^21, 8)": _ms(
        torch, lambda: kp2.hash_pairs(left, right), 10)}
    if sass:
        names = ["hash_rows_kernel", "hash_pairs_kernel", "merkle_fold"]
        rec["sass"] = sass_report(so, names)
        log = os.path.splitext(so)[0] + ".log"
        with open(log) as f:
            text = f.read()
        section = text.split("== poseidon2.cu", 1)[-1].split("\n== ", 1)[0]
        rec["ptxas"] = [l.strip() for l in section.splitlines()
                        if "Compiling entry" in l or "Used" in l
                        or "spill" in l]
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default=None)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--pipes", action="store_true")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(turn(os.path.abspath(a.turn), a.sass)), flush=True)
        return 0
    if not a.trees:
        ap.error("give at least one tree")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if a.pipes:
        print(json.dumps({"pipes": pipes(os.path.join(
            here, "risc0_tpu_torch", "build"))}), flush=True)
    keys = a.order or "".join(chr(65 + i) for i in range(len(a.trees)))
    for key in keys:
        tree = os.path.abspath(a.trees[ord(key) - 65])
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", tree]
            + (["--sass"] if a.sass else []), cwd=tree, capture_output=True,
            text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["key"] = key
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
