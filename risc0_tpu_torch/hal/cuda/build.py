"""Build and load the CUDA kernels of risc0_tpu_torch.

The sources in ``risc0_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first use,
into ``risc0_tpu_torch/build/`` under a name keyed by a hash of the
sources, and loaded with ctypes.  Every entry point takes its pointers and
the stream as ``c_void_p`` and returns a ``cudaError_t`` (0 on success).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("babybear.cuh", "poseidon2.cu", "ntt.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_V, _U32, _U64 = C.c_void_p, C.c_uint32, C.c_uint64
_SIGNATURES = {
    "p2_set_constants": (_V, _V),
    "p2_hash_rows": (_V, _V, _U32, _U64, _V),
    "p2_hash_pairs": (_V, _V, _V, _U64, _U64, _U64, _V),
    "ntt_evaluate": (_V, _V, _V, _U32, _U32, _U32, _V),
    "ntt_interpolate": (_V, _V, _V, _U32, _U32, _U32, _V),
}

_lib = None
build_info: dict = {}


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the library if this source hash has not been built; returns
    its path.  The compiler's -Xptxas -v report is kept beside it."""
    so = BUILD_DIR / f"libr0torch_{_source_hash()}.so"
    log = so.with_suffix(".log")
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES if s.endswith(".cu")]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      cached=False)
    return so


def library() -> C.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = C.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = C.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
