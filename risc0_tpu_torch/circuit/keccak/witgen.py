"""Keccak witness generation on the host: preflight scatter, then the
bytecode interpreter of ``csrc/libr0vm.so`` (counterpart of
``risc0_tpu/circuit/keccak/witgen.py``).

Mirrors the reference keccak prover data path (keccak/src/prove/mod.rs:
scatter_preflight + generate_witness + zeroize); the exec program is the
one extracted from keccak-sys/kernels/cxx/steps_*.cpp.  As in the
reference, this stays on the host.
"""

from __future__ import annotations

import ctypes as C
import json
import os
import struct
from functools import lru_cache

import numpy as np

from ... import perf
from ...assets import KECCAK_DATA
from ...zkvm import native
from .preflight import KeccakPreflight, apply_scatter

INVALID = np.uint32(0xFFFFFFFF)

REGCOUNT_DATA = 1096
REGCOUNT_GLOBAL = 17
REGCOUNT_MIX = 4
REGCOUNT_ACCUM = 1


@lru_cache(maxsize=1)
def global_meta() -> dict:
    """Global column offsets (``total_cycles``, ``final_digest``)."""
    with open(os.path.join(KECCAK_DATA, "witgen_meta.json")) as f:
        return json.load(f)["global"]


@lru_cache(maxsize=1)
def _program():
    with open(os.path.join(KECCAK_DATA, "witgen_exec.bin"), "rb") as f:
        magic, n_ops, n_slots, n_ext, _ = struct.unpack("<4sIIII",
                                                        f.read(20))
        if magic != b"WGN1":
            raise ValueError("witgen_exec.bin: not a witgen program")
        ops = np.frombuffer(f.read(n_ops * 20), np.uint32).reshape(n_ops, 5)
        ext = np.frombuffer(f.read(n_ext * 16), np.uint32).reshape(n_ext, 4) \
            if n_ext else np.zeros((1, 4), np.uint32)
    lib = native.lib()
    lib.r0_witgen_run.restype = C.c_int
    lib.r0_witgen_error.restype = C.c_char_p
    return {"ops": np.ascontiguousarray(ops), "n_slots": n_slots,
            "ext": np.ascontiguousarray(ext), "lib": lib}


def _u32p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint32))


def witgen_keccak(inputs, po2, n_threads=0):
    """The keccak witness of a batch of keccak states.

    inputs: list of 25-element u64 iterables.  Returns a dict with data
    (1096, 2^po2) and global (17,) standard-form u32 columns and the
    preflight object."""
    prog = _program()
    lib = prog["lib"]
    rows = 1 << po2
    with perf.scope("keccak_preflight"):
        pf = KeccakPreflight([list(s) for s in inputs], rows)

    with perf.scope("keccak_witgen"):
        data = np.full((REGCOUNT_DATA, rows), INVALID, np.uint32)
        apply_scatter(data, pf.scatter, pf.data)
        glob = np.full(REGCOUNT_GLOBAL, INVALID, np.uint32)
        glob[global_meta()["total_cycles"]] = rows

        # preimage table: (n, 100) 16-bit chunks (ffi.cpp extern_getPreimage)
        n = len(pf.preimages)
        preimages = np.zeros((max(n, 1), 100), np.uint32)
        if n:
            st = np.array(pf.preimages, np.uint64)               # (n, 25)
            shifts = np.arange(4, dtype=np.uint64) * np.uint64(16)
            preimages[:n] = ((st[:, :, None] >> shifts) & np.uint64(0xFFFF)
                             ).reshape(n, 100)
        cur = np.asarray(pf.cur_preimage, np.uint32)

        rc = lib.r0_witgen_run(
            _u32p(prog["ops"]), len(prog["ops"]), prog["n_slots"],
            _u32p(prog["ext"]),
            None, rows, None, 0, None, 0,
            _u32p(data), _u32p(glob), None, None,
            0, rows, None, None, n_threads,
            _u32p(preimages), _u32p(cur), n)
        if rc != 0:
            raise RuntimeError(lib.r0_witgen_error().decode())
        data[data == INVALID] = 0
        glob[glob == INVALID] = 0
    return {"data": data, "global": glob, "rows": rows, "preflight": pf}
