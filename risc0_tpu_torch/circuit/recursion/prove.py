"""Recursion circuit prover on torch: run a recursion program (zkr) and
seal it (counterpart of ``risc0_tpu/circuit/recursion/prove.py``).

Mirrors the reference driver (risc0/circuit/recursion/src/prove/mod.rs:
160-252 prove + witgen.rs): preflight the program on the host, generate
the witness (step_exec + WOM argument sort/inject/verify via the host C++
of csrc/witgen.cpp), add zk noise, then the standard seal flow on
`device`: info commits, globals||po2 header (no seal version word, unlike
an rv32im seal), code and data commits, mix, accum, finalize.
"""

from __future__ import annotations

import ctypes as C
import json
import lzma
import os
import re
import struct

import numpy as np

from ... import field as F
from ... import perf
from ...assets import RECURSION_DATA as _DATA_DIR
from ...assets import RECURSION_ZKR
from ...convert import card
from ...hash.suite import POSEIDON2
from ...prove.prover import PolyGroup, Prover
from ...taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                     REGISTER_GROUP_DATA)
from ...zkvm import native
from ..ir_range import RangePlanHal
from ..rv32im.prove import open_seal
from .circuit import RECURSION_PO2, load_prover_circuit
from .preflight import RecursionPreflight

RECURSION_CODE_SIZE = 23   # reference prove/mod.rs:55
ZK_CYCLES = 1024
REGCOUNT_DATA = 128
REGCOUNT_ACCUM = 12
INVALID = np.uint32(0xFFFFFFFF)
_ALL_CORES = 0  # n_threads of the C++ witgen: 0 runs one thread per core

# eval_check rows per chunk on an 80 GB card: the register files take
# 8275 x T x 4 B + 130 x T x 16 B = 2.3 GB at T = 2^16, and 16 chunks
# cover the po2 18 domain
EVAL_CHUNK = 1 << 16


class Program:
    """A recursion program: raw code rows (reference prove/program.rs)."""

    def __init__(self, encoded, po2):
        encoded = np.asarray(encoded, np.uint32)
        if len(encoded) % RECURSION_CODE_SIZE:
            raise ValueError("code words are not whole rows")
        self.code = encoded.reshape(-1, RECURSION_CODE_SIZE)
        self.po2 = po2
        if len(self.code) > (1 << po2) - ZK_CYCLES:
            raise ValueError(f"{len(self.code)} code rows do not fit po2 {po2}")

    @property
    def code_rows(self):
        return len(self.code)

    def ctrl_buffer(self):
        """Column-major (23, 2^po2) code group, zero padded."""
        buf = np.zeros((RECURSION_CODE_SIZE, 1 << self.po2), np.uint32)
        buf[:, :self.code_rows] = self.code.T
        return buf

    def control_id(self, device="cuda", suite=POSEIDON2):
        """Merkle root of the committed code group (zk shifted, as every
        commit) under `suite`, computed on `device`."""
        device = card(device)
        enc = F.encode_np(self.ctrl_buffer() % F.P)
        return PolyGroup.commit_witness(enc, device,
                                        suite=suite).merkle.root


def _load_zkr(name, po2=RECURSION_PO2):
    raw = lzma.open(os.path.join(RECURSION_ZKR, name + ".zkr.xz")).read()
    return Program(np.frombuffer(raw, np.uint32), po2)


def load_keccak_lift(po2):
    """The released keccak_lift recursion program for a keccak po2 (the
    reference ships it as data too: risc0/circuit/keccak/src/prove/
    *.zkr.xz)."""
    return _load_zkr(f"keccak_lift_{po2}")


def _load_prog_bin(name):
    with open(os.path.join(_DATA_DIR, name), "rb") as f:
        magic, n_ops, n_slots, _n_ext, _ = struct.unpack("<4sIIII",
                                                         f.read(20))
        if magic != b"WGN1":
            raise ValueError(f"{name}: not a witgen program")
        ops = np.frombuffer(f.read(n_ops * 20), np.uint32).reshape(n_ops, 5)
    return np.ascontiguousarray(ops), n_slots


_cache = {}


def _progs():
    if not _cache:
        for k, fname in (("exec", "rec_step_exec.bin"),
                         ("vmem", "rec_step_verify_mem.bin"),
                         ("comp", "rec_step_compute_accum.bin"),
                         ("ver", "rec_step_verify_accum.bin")):
            _cache[k] = _load_prog_bin(fname)
        with open(os.path.join(_DATA_DIR, "rec_witgen_meta.json")) as f:
            _cache["meta"] = json.load(f)
        lib = native.lib()
        U32P = C.POINTER(C.c_uint32)
        lib.r0_rec_witgen.restype = C.c_int
        lib.r0_rec_witgen.argtypes = [
            U32P, C.c_uint64, C.c_uint32, U32P, C.c_uint64, C.c_uint32,
            U32P, C.c_uint32, U32P, C.c_uint32,
            U32P, U32P, C.c_uint32,
            U32P, U32P, U32P, C.c_uint64, C.c_uint32]
        lib.r0_rec_accum.restype = C.c_int
        lib.r0_rec_accum.argtypes = [
            U32P, C.c_uint64, C.c_uint32, U32P, C.c_uint64, C.c_uint32,
            U32P, U32P, C.c_uint32,
            U32P, U32P, U32P, U32P, U32P, C.c_uint64, C.c_uint32]
        lib.r0_witgen_error.restype = C.c_char_p
        _cache["lib"] = lib
    return _cache


def _u32p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint32))


def _rows4(items):
    return np.array([list(w) for w in items], np.uint32).reshape(-1, 4) \
        if items else np.zeros((1, 4), np.uint32)


def witgen_recursion(program: Program, pf: RecursionPreflight, rng=None):
    """Generate the ctrl/data/global witness buffers (standard form) on
    the host; draws the data group's (128, 1024) zk noise from `rng`."""
    progs = _progs()
    lib = progs["lib"]
    rng = rng or np.random.default_rng()
    steps = 1 << program.po2
    work = program.code_rows
    if len(pf.cycles) != work:
        raise ValueError("preflight did not run this program")

    with perf.scope("rec_witgen"):
        ctrl = np.ascontiguousarray(program.ctrl_buffer())
        data = np.full((REGCOUNT_DATA, steps), INVALID, np.uint32)
        glob = np.full(32, INVALID, np.uint32)
        wom, iops = _rows4(pf.wom), _rows4(pf.iops)
        iop_idx = np.array([c[0] for c in pf.cycles], np.uint32)
        par_safe = np.array([c[1] for c in pf.cycles], np.uint32)

        ex_ops, ex_slots = progs["exec"]
        vm_ops, vm_slots = progs["vmem"]
        rc = lib.r0_rec_witgen(
            _u32p(ex_ops), len(ex_ops), ex_slots,
            _u32p(vm_ops), len(vm_ops), vm_slots,
            _u32p(wom), len(wom), _u32p(iops), len(iops),
            _u32p(iop_idx), _u32p(par_safe), work,
            _u32p(ctrl), _u32p(glob), _u32p(data), steps, _ALL_CORES)
        if rc != 0:
            raise RuntimeError(_loc(lib.r0_witgen_error().decode(),
                                    progs["meta"]))
        # zk noise rows, then zeroize (reference witgen.rs:96-121)
        data[:, steps - ZK_CYCLES:] = rng.integers(
            0, F.P, (REGCOUNT_DATA, ZK_CYCLES), dtype=np.uint32)
        data[data == INVALID] = 0
        glob[glob == INVALID] = 0
    return {"ctrl": ctrl, "data": data, "global": glob, "steps": steps,
            "work": work, "iop_idx": iop_idx, "par_safe": par_safe}


def accum_recursion(res, mix_std, rng=None):
    """The (12, steps) accum witness (standard form) on the host, for the
    standard-form mix; draws its zk noise from `rng` before the C++ runs."""
    progs = _progs()
    lib = progs["lib"]
    rng = rng or np.random.default_rng()
    steps = res["steps"]
    with perf.scope("rec_accum"):
        accum = np.full((REGCOUNT_ACCUM, steps), INVALID, np.uint32)
        accum[:, steps - ZK_CYCLES:] = rng.integers(
            0, F.P, (REGCOUNT_ACCUM, ZK_CYCLES), dtype=np.uint32)
        mix = np.ascontiguousarray(np.asarray(mix_std, np.uint32))
        cp_ops, cp_slots = progs["comp"]
        vr_ops, vr_slots = progs["ver"]
        rc = lib.r0_rec_accum(
            _u32p(cp_ops), len(cp_ops), cp_slots,
            _u32p(vr_ops), len(vr_ops), vr_slots,
            _u32p(res["iop_idx"]), _u32p(res["par_safe"]), res["work"],
            _u32p(res["ctrl"]), _u32p(res["global"]), _u32p(res["data"]),
            _u32p(mix), _u32p(accum), steps, _ALL_CORES)
        if rc != 0:
            raise RuntimeError(_loc(lib.r0_witgen_error().decode(),
                                    progs["meta"]))
        accum[accum == INVALID] = 0
    return accum


def _loc(msg, meta):
    """Name the witgen step of a failing `loc N` in the C++ message."""
    m = re.search(r"loc (\d+)", msg)
    if m:
        for fn in ("step_exec", "step_verify_mem", "step_compute_accum",
                   "step_verify_accum"):
            locs = meta.get(fn, {}).get("locs", [])
            if int(m.group(1)) < len(locs):
                msg += " [" + locs[int(m.group(1))] + "?]"
                break
    return msg


def prove_program(program: Program, input_words, rng=None, device="cuda",
                  eval_chunk: int = EVAL_CHUNK, suite=None):
    """Run and prove a recursion program on `device` (the card unless the
    caller names another) under `suite` (default Poseidon2); returns
    (seal, output words).  The seal is the reference's word for word for
    the same `rng`."""
    device = card(device)
    suite = suite or POSEIDON2
    rng = rng or np.random.default_rng()
    circuit = load_prover_circuit()

    pf = RecursionPreflight(input_words)
    pf.run(program.code)
    res = witgen_recursion(program, pf, rng=rng)
    global_m = F.encode_np(res["global"])

    prover = Prover(suite, circuit.taps, device)
    open_seal(prover, suite, circuit.CIRCUIT_INFO, global_m, program.po2)

    # code words may exceed int32 range: they encode on the host
    prover.commit_group(REGISTER_GROUP_CODE, F.encode_np(res["ctrl"]))
    prover.commit_group(REGISTER_GROUP_DATA, res["data"], encode=True)

    mix_m = np.array([prover.iop.random_elem()
                      for _ in range(circuit.MIX_SIZE)], np.uint32)
    accum = accum_recursion(res, F.decode_np(mix_m), rng=rng)
    prover.commit_group(REGISTER_GROUP_ACCUM, accum, encode=True)

    hal_obj = RangePlanHal(circuit, chunk=eval_chunk)
    seal = prover.finalize([mix_m, global_m], hal_obj)
    return seal, list(pf.output)


# ---------------------------------------------------------------------------
# Succinct receipts (reference zkvm/src/receipt/merkle.rs + host/recursion/
# prove/mod.rs:393-440 prove_zkr)
# ---------------------------------------------------------------------------

ALLOWED_CODE_MERKLE_DEPTH = 8  # reference receipt/merkle.rs:30


class MerkleGroup:
    """Fixed-depth Merkle set of allowed recursion control IDs, hashed
    under `suite` (default Poseidon2)."""

    def __init__(self, leaves, suite=None):
        if len(leaves) >= 1 << ALLOWED_CODE_MERKLE_DEPTH:
            raise ValueError(f"{len(leaves)} control IDs do not fit the set")
        self.depth = ALLOWED_CODE_MERKLE_DEPTH
        self.leaves = [np.asarray(d, np.uint32) for d in leaves]
        self.suite = suite or POSEIDON2

    def _root(self, start, end):
        if start + 1 == end:
            return self.leaves[start] if start < len(self.leaves) \
                else np.zeros(8, np.uint32)
        mid = (start + end) // 2
        return self.suite.hash_pair(self._root(start, mid),
                                    self._root(mid, end))

    def calc_root(self):
        return self._root(0, 1 << self.depth)

    def get_proof(self, control_id):
        """{index, digests}: the sibling path of `control_id`, leaf to
        root."""
        cid = np.asarray(control_id, np.uint32)
        idx = next(i for i, leaf in enumerate(self.leaves)
                   if np.array_equal(leaf, cid))
        digests = []
        lo, hi = 0, 1 << self.depth
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if idx < mid:
                digests.append(self._root(mid, hi))
                hi = mid
            else:
                digests.append(self._root(lo, mid))
                lo = mid
        digests.reverse()
        return {"index": idx, "digests": digests}


def read_sha_halfs(shorts):
    """16 shorts -> 8 digest words (reference binfmt read_sha_halfs)."""
    shorts = [int(x) for x in shorts]
    return np.array([shorts[2 * i] | (shorts[2 * i + 1] << 16)
                     for i in range(8)], np.uint32)


def prove_zkr(program: Program, control_id, allowed_control_ids,
              input_words, claim=None, suite=None, **kw):
    """Prove a recursion program and wrap it as a SuccinctReceipt
    (reference host/recursion/prove/mod.rs:393-440).  `claim` defaults to
    the pruned claim digest decoded from the seal's output.  `suite` is
    the outer proof's hash suite (Poseidon254 for the BN254 wrap), and the
    allowed-control-IDs set hashes under it too; `kw` goes to
    ``prove_program`` (rng, device, eval_chunk)."""
    from ...zkvm.claims import MaybePruned
    from ...zkvm.receipt import SuccinctReceipt

    suite = suite or POSEIDON2
    seal, _output = prove_program(program, input_words, suite=suite, **kw)
    if claim is None:
        out = F.decode_np(np.asarray(seal[:32], np.uint32))
        claim = MaybePruned.from_digest(read_sha_halfs(out[16:32]))
    group = MerkleGroup(allowed_control_ids, suite)
    return SuccinctReceipt(
        seal=np.asarray(seal, np.uint32),
        control_id=np.asarray(control_id, np.uint32),
        claim=claim,
        control_root=group.calc_root(),
        control_inclusion_proof=group.get_proof(control_id),
        hashfn=suite.name,
    )
