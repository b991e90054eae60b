"""Build, load and call the host interpreter of the recursion VM.

``risc0_tpu_torch/csrc/rec_preflight.cpp`` is compiled with the host C++
compiler (no CUDA) at first use into ``risc0_tpu_torch/build/``, under a
name keyed by a hash of the source, and loaded with ctypes.  One build a
process under a lock; a build writes a per-pid temporary file and renames
it into place, so processes that build at once leave one whole library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ...hash import poseidon2_consts as PC
from ..keccak.preflight import SHA_INIT, SHA_K

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "rec_preflight.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
CODE_SIZE = 23

# status of a run -> the exception the Python interpreter raises for it
_FAULTS = {1: ValueError, 2: IndexError, 3: AssertionError}

_U32P = C.POINTER(C.c_uint32)


class _Result(C.Structure):
    _fields_ = [
        ("status", C.c_int32),
        ("message", C.c_char * 512),
        ("rows_run", C.c_uint64),
        ("input_used", C.c_uint64),
        ("wom", _U32P), ("n_wom", C.c_uint64),
        ("iops", _U32P), ("n_iops", C.c_uint64),
        ("iop_idx", _U32P),
        ("par_safe", _U32P),
        ("output", _U32P), ("n_output", C.c_uint64),
        ("byte_reads", _U32P), ("n_byte_reads", C.c_uint64),
        ("eq_failures", _U32P), ("n_eq_failures", C.c_uint64),
    ]


_lib = None
_lock = threading.Lock()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"librecpf_{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the recursion "
                       "preflight is host C++")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library if this source hash has not been built into
    `build_dir`; returns its path."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def load(path: Path) -> C.CDLL:
    lib = C.CDLL(str(path))
    lib.r0_rec_preflight.restype = C.POINTER(_Result)
    lib.r0_rec_preflight.argtypes = [
        _U32P, C.c_uint64, _U32P, C.c_uint64, C.c_int32,
        _U32P, _U32P, C.c_uint32, C.c_uint32, _U32P, _U32P]
    lib.r0_rec_preflight_free.restype = None
    lib.r0_rec_preflight_free.argtypes = [C.POINTER(_Result)]
    return lib


def lib() -> C.CDLL:
    """The loaded library, built on the first call of the process;
    concurrent first calls build and load it once."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = load(build())
    return _lib


def _ptr(a):
    return a.ctypes.data_as(_U32P)


def _take(ptr, n, width=None):
    shape = (n,) if width is None else (n, width)
    if n == 0:
        return np.zeros(shape, np.uint32)
    return np.ctypeslib.as_array(ptr, shape=shape).copy()


def run(code, tape, eq_strict=True, library=None) -> dict:
    """Interpret every row of `code` ((rows, 23) u32) over `tape` (u32
    words).  Returns the WOM and IOP rows as (n, 4) u32 arrays, `iop_idx`
    and `par_safe` a row each, `output`, `byte_reads` ((n, 5): cycle and
    the four tape words a checked-bytes row read), `eq_failures` ((n, 9):
    cycle, a, b) and `input_used`; raises the Python interpreter's
    exception class on a fault."""
    code = np.ascontiguousarray(code, np.uint32)
    if code.ndim != 2 or code.shape[1] != CODE_SIZE:
        raise ValueError(f"code rows must be (rows, {CODE_SIZE}) words, "
                         f"not {code.shape}")
    tape = np.ascontiguousarray(tape, np.uint32)
    rc, diag, sha_init, sha_k = (
        np.ascontiguousarray(words, np.uint32) for words in
        (PC.ROUND_CONSTANTS, PC.M_INT_DIAG_HZN, SHA_INIT, SHA_K))
    lib_ = library or lib()
    res = lib_.r0_rec_preflight(
        _ptr(code), len(code), _ptr(tape), len(tape), int(bool(eq_strict)),
        _ptr(rc), _ptr(diag), PC.ROUNDS_HALF_FULL, PC.ROUNDS_PARTIAL,
        _ptr(sha_init), _ptr(sha_k))
    try:
        r = res.contents
        if r.status != 0:
            raise _FAULTS[r.status](r.message.decode())
        rows = r.rows_run
        return {
            "wom": _take(r.wom, r.n_wom, 4),
            "iops": _take(r.iops, r.n_iops, 4),
            "iop_idx": _take(r.iop_idx, rows),
            "par_safe": _take(r.par_safe, rows),
            "output": _take(r.output, r.n_output),
            "byte_reads": _take(r.byte_reads, r.n_byte_reads, 5),
            "eq_failures": _take(r.eq_failures, r.n_eq_failures, 9),
            "input_used": int(r.input_used),
        }
    finally:
        lib_.r0_rec_preflight_free(res)
