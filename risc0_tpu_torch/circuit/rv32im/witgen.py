"""rv32im witness generation: preflight trace -> data/accum trace columns
(counterpart of risc0_tpu/circuit/rv32im/witgen.py, the same host code over
the same C++ interpreter, csrc/libr0vm.so).

Drives the bytecode interpreter (csrc/witgen.cpp) over the programs
extracted from the reference's generated witgen (scripts/extract_witgen.py).
The host-side orchestration mirrors the reference's witness generator
(risc0/circuit/rv32im/src/prove/witgen/mod.rs): build the global vector,
scatter-inject per-row stateful columns and accelerator back-state, run the
row-parallel exec program, zeroize; the accum phase adds the permutation
argument columns with a prefix-sum + totals pass (kernels/cxx/ffi.cpp
risc0_circuit_rv32im_cpu_accum phases 1-3).
"""

from __future__ import annotations

import ctypes as C
import json
import os
import struct

import numpy as np

import risc0_tpu
from risc0_tpu.zkvm import native
from risc0_tpu.zkvm.exec import preflight_segment

from ...field import P

_DATA_DIR = os.path.join(os.path.dirname(risc0_tpu.__file__), "circuit", "rv32im",
                         "data")
INVALID = np.uint32(0xFFFFFFFF)

REGCOUNT_DATA = 211
REGCOUNT_ACCUM = 103
REGCOUNT_GLOBAL = 90
REGCOUNT_MIX = 36

_ALL_CORES = 0  # n_threads of r0_witgen_run: 0 runs one thread per core

# CycleState (csrc/r0vm.h:69)
_POSEIDON_LOAD_IN = 18
_POSEIDON_EXT_ROUND = 24
_POSEIDON_INT_ROUND = 25
# tx kinds (reference execute/platform.rs:191-195)
_TX_READ, _TX_PAGE_IN, _TX_PAGE_OUT = 0, 1, 2


def _load_meta():
    with open(os.path.join(_DATA_DIR, "witgen_meta.json")) as f:
        return json.load(f)


def _load_program(name):
    with open(os.path.join(_DATA_DIR, name), "rb") as f:
        magic, n_ops, n_slots, n_ext, _ = struct.unpack("<4sIIII",
                                                        f.read(20))
        assert magic == b"WGN1"
        ops = np.frombuffer(f.read(n_ops * 20), np.uint32).reshape(n_ops, 5)
        ext = np.frombuffer(f.read(n_ext * 16), np.uint32).reshape(n_ext, 4)
    return {"ops": np.ascontiguousarray(ops), "n_slots": n_slots,
            "ext": np.ascontiguousarray(ext) if n_ext else
            np.zeros((1, 4), np.uint32)}


_cache = {}


def _programs():
    if not _cache:
        _cache["meta"] = _load_meta()
        _cache["exec"] = _load_program("witgen_exec.bin")
        _cache["accum"] = _load_program("witgen_accum.bin")
        lib = native.lib()
        lib.r0_witgen_run.restype = C.c_int
        lib.r0_witgen_error.restype = C.c_char_p
        _cache["lib"] = lib
    return _cache


def _u32p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint32))


# -- ext field helpers on python ints (standard form) ------------------------

def _eadd(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def _emul(a, b):
    nbeta = P - 11
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return (
        (a0 * b0 + nbeta * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
        (a0 * b1 + a1 * b0 + nbeta * (a2 * b3 + a3 * b2)) % P,
        (a0 * b2 + a1 * b1 + a2 * b0 + nbeta * (a3 * b3)) % P,
        (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P,
    )


def _escale(a, s):
    return tuple(x * s % P for x in a)


class _Checksum:
    """Poseidon2 paging checksum (reference witgen/poseidon2.rs:236-284)."""

    def __init__(self, rand_z):
        self.powers = []
        cur = (1, 0, 0, 0)
        for _ in range(17):
            self.powers.append(cur)
            cur = _emul(cur, rand_z)
        self.zcheck = (0, 0, 0, 0)

    def start(self):
        self.zcheck = _emul(self.zcheck, self.powers[16])

    def clear(self):
        self.zcheck = (0, 0, 0, 0)

    def add(self, tx_kind, idx, txn):
        addr, cycle, word, prev_cycle, prev_word = (int(x) for x in txn)
        if tx_kind == _TX_READ:
            c0, c1 = 0, 1
        elif tx_kind == _TX_PAGE_IN:
            c0, c1 = 0, (cycle - prev_cycle) % P
        else:  # PAGE_OUT
            c0 = ((word & 0xFFFF) - (prev_word & 0xFFFF)) % P
            c1 = ((word >> 16) - (prev_word >> 16)) % P
        self.zcheck = _eadd(self.zcheck, _escale(self.powers[2 * idx], c0))
        self.zcheck = _eadd(self.zcheck,
                            _escale(self.powers[2 * idx + 1], c1))


def _update_p2_zcheck(pf, rand_z):
    """Fill the zcheck slots of Poseidon2 back payloads in-place
    (reference witgen/preflight.rs:234-262 update_p2_zcheck)."""
    cycles = pf["cycles"]
    kinds = pf["back_kind"]
    offs = pf["back_offset"]
    back = pf["back_data"]
    txns = pf["txns"]
    n = len(cycles)
    checksum = _Checksum(rand_z)
    for row in np.nonzero(kinds == 3)[0]:
        # current state from the row's major/minor (cycles[:,0] is the NEXT
        # state); reference preflight.rs:246 CycleState::from_u32((major-7)*8
        # + minor)
        state = (int(cycles[row, 2]) - 7) * 8 + int(cycles[row, 3])
        if state == _POSEIDON_LOAD_IN:
            checksum.start()
            t0 = int(cycles[row, 6])
            t1 = int(cycles[row + 1, 6]) if row + 1 < n else len(txns)
            load_tx_type = int(back[offs[row] + 5])
            for i, ti in enumerate(range(t0, t1)):
                checksum.add(load_tx_type, i, txns[ti])
        if state in (_POSEIDON_LOAD_IN, _POSEIDON_EXT_ROUND,
                     _POSEIDON_INT_ROUND):
            back[offs[row] + 35:offs[row] + 39] = checksum.zcheck
        else:
            checksum.clear()


def build_global(seg, rand_z):
    """reference prove/witgen/mod.rs:269-335 build_global_vec."""
    meta = _programs()["meta"]
    g = np.full(REGCOUNT_GLOBAL, INVALID, np.uint32)
    gm = meta["global"]

    def set_digest(slots, words):
        for (lo, hi), w in zip(slots, words):
            g[lo] = int(w) & 0xFFFF
            g[hi] = int(w) >> 16

    set_digest(gm["state_in"], seg.pre_digest)
    set_digest(gm["input"], seg.input_digest)
    for i in range(4):
        g[gm["rng"] + i] = rand_z[i]
    g[gm["is_terminate"]] = 0 if seg.terminate_state is None else 1
    g[gm["shutdown_cycle"]] = seg.segment_threshold
    nonce = getattr(seg, "povw_nonce", None)
    set_digest(gm["povw_nonce"],
               [0] * 8 if nonce is None else nonce.to_u32s())
    return g


def inject(pf, rows, meta):
    """Scatter per-row stateful columns into a fresh data buffer
    (reference prove/witgen/mod.rs:330-386 Injector + build_injector)."""
    data = np.full((REGCOUNT_DATA, rows), INVALID, np.uint32)
    c = pf["cycles"]
    inj = meta["inject"]
    data[inj["cycle"], :] = np.arange(rows, dtype=np.uint32)
    data[inj["next_pc_low"], :] = c[:, 1] & 0xFFFF
    data[inj["next_pc_high"], :] = c[:, 1] >> 16
    data[inj["next_state"], :] = c[:, 0]
    data[inj["next_machine_mode"], :] = c[:, 4]

    kinds = pf["back_kind"]
    offs = pf["back_offset"]
    back = pf["back_data"]

    ecall_rows = np.nonzero(kinds == 1)[0]
    if len(ecall_rows):
        o = offs[ecall_rows]
        data[inj["ecall_s0"], ecall_rows] = back[o]
        data[inj["ecall_s1"], ecall_rows] = back[o + 1]
        data[inj["ecall_s2"], ecall_rows] = back[o + 2]

    p2_rows = np.nonzero(kinds == 3)[0]
    if len(p2_rows):
        o = offs[p2_rows]
        for i, col in enumerate(inj["p2_state"]):
            data[col, p2_rows] = back[o + i]

    sha_rows = np.nonzero(kinds == 2)[0]
    if len(sha_rows):
        o = offs[sha_rows]
        for i, col in enumerate(inj["sha_fp"]):
            data[col, sha_rows] = back[o + i]
        for i, col in enumerate(inj["sha_u32"]):
            word = back[o + 7 + i]
            for b in range(32):
                data[col + b, sha_rows] = (word >> b) & 1

    bigint_rows = np.nonzero(kinds == 4)[0]
    if len(bigint_rows):
        o = offs[bigint_rows]
        # [isEcall, mode, pc, polyOp, coeff, bytes x16, nextState]
        # (reference witgen/bigint.rs BigIntState::offsets)
        for i, col in enumerate(inj["bigint_state"]):
            data[col, bigint_rows] = back[o + i]
    return data


def witgen_exec(seg, rand_z=(1, 0, 0, 0)):
    """Run preflight + the exec witgen program for a segment.

    Returns dict with: data (REGCOUNT_DATA, rows) u32 standard-form columns,
    global (90,), tables u8/u16 counts, preflight dict, rows.
    """
    progs = _programs()
    meta, lib = progs["meta"], progs["lib"]
    pf = preflight_segment(seg)
    _update_p2_zcheck(pf, rand_z)
    rows = len(pf["cycles"])

    data = inject(pf, rows, meta)
    glob = build_global(seg, rand_z)
    cycles = np.ascontiguousarray(pf["cycles"])
    txns = np.ascontiguousarray(pf["txns"])
    tab8 = np.zeros(256, np.uint32)
    tab16 = np.zeros(65536, np.uint32)
    bigint = np.ascontiguousarray(pf.get(
        "bigint_bytes", np.zeros(0, np.uint32)))
    if len(bigint) == 0:
        bigint = np.zeros(16, np.uint32)
    prog = progs["exec"]
    rc = lib.r0_witgen_run(
        _u32p(prog["ops"]), len(prog["ops"]), prog["n_slots"],
        _u32p(prog["ext"]),
        _u32p(cycles), rows, _u32p(txns), len(txns),
        _u32p(bigint), len(bigint),
        _u32p(data), _u32p(glob), None, None,
        0, pf["table_split_cycle"], _u32p(tab8), _u32p(tab16), _ALL_CORES,
        None, None, 0)
    if rc != 0:
        raise RuntimeError(_resolve_loc(lib.r0_witgen_error().decode(),
                                        meta["exec_locs"]))
    data[data == INVALID] = 0
    glob[glob == INVALID] = 0
    return {"data": data, "global": glob, "tables_u8": tab8,
            "tables_u16": tab16, "preflight": pf, "rows": rows}


def witgen_accum(res, mix):
    """Run the accum program + prefix-sum/totals phases.

    mix: (REGCOUNT_MIX,) u32 standard-form randomness vector.
    Returns accum columns (REGCOUNT_ACCUM, rows) u32.
    """
    progs = _programs()
    meta, lib = progs["meta"], progs["lib"]
    rows = res["rows"]
    split = meta["user_accum_split"]
    accum = np.full((REGCOUNT_ACCUM, rows), INVALID, np.uint32)
    mix = np.ascontiguousarray(np.asarray(mix, np.uint32))
    pf = res["preflight"]
    cycles = np.ascontiguousarray(pf["cycles"])
    txns = np.ascontiguousarray(pf["txns"])
    bigint = np.zeros(16, np.uint32)
    prog = progs["accum"]
    rc = lib.r0_witgen_run(
        _u32p(prog["ops"]), len(prog["ops"]), prog["n_slots"],
        _u32p(prog["ext"]),
        _u32p(cycles), rows, _u32p(txns), len(txns),
        _u32p(bigint), len(bigint),
        _u32p(res["data"]), _u32p(res["global"]), _u32p(accum), _u32p(mix),
        split, pf["table_split_cycle"], None, None, _ALL_CORES,
        None, None, 0)
    if rc != 0:
        raise RuntimeError(_resolve_loc(lib.r0_witgen_error().decode(),
                                        meta["accum_locs"]))
    accum[accum == INVALID] = 0
    # phase 2: prefix-sum the last 4 columns (ffi.cpp:330-339)
    acc = accum.astype(np.uint64)
    for j in range(4):
        col = REGCOUNT_ACCUM - 4 + j
        accum[col] = _prefix_sum_mod(acc[col])
    # phase 3: add prev-row totals to machine columns (ffi.cpp:341-361)
    machine_cols = (REGCOUNT_ACCUM - split) // 4
    prev = np.roll(accum[REGCOUNT_ACCUM - 4:], 1, axis=1).astype(np.uint64)
    for j in range(machine_cols - 1):
        for k in range(4):
            col = split + j * 4 + k
            accum[col] = (accum[col] + prev[k]) % P
    return accum


def _prefix_sum_mod(col_u64):
    # running sum mod P of words < P: a chunk of 2^20 rows sums below 2^52,
    # so u64 never wraps when the carry is reduced after each chunk
    out = np.empty_like(col_u64)
    total = 0
    chunk = 1 << 20
    for i in range(0, len(col_u64), chunk):
        seg = col_u64[i:i + chunk]
        cs = np.cumsum(seg) + total
        cs %= P
        out[i:i + chunk] = cs
        total = int(cs[-1]) if len(cs) else total
    return out.astype(np.uint32)


def _resolve_loc(msg, locs):
    # "witgen: eqz failed, loc N row R ..." -> append source location
    import re
    m = re.search(r"loc (\d+)", msg)
    if m and int(m.group(1)) < len(locs):
        msg += " [" + locs[int(m.group(1))] + "]"
    return msg
