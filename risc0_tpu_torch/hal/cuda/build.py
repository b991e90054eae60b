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
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("babybear.cuh", "poseidon2.cu", "ntt.cu", "eval_plan.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_V, _U32, _U64 = C.c_void_p, C.c_uint32, C.c_uint64
_SIGNATURES = {
    "p2_set_constants": (_V, _V),
    "p2_hash_rows": (_V, _V, _U32, _U64, _V),
    "p2_merkle_fold": (_V, _V, _V, _U64, _U64, _U64, C.c_int, _V),
    "ntt_evaluate": (_V, _V, _V, _V, _V, *[_U32] * 6, _V),
    "ntt_interpolate": (_V, _V, _V, _V, _V, *[_U32] * 6, _V),
    "eval_plan": (_V, _U32, _V, _V, _V, _U32, _V),
}

_lib = None
# one build and one load a process: the first callers of several threads
# (the accelerator workers of a proof-job cluster) wait for it
_lock = threading.RLock()
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


def _run(procs, what):
    """Wait for every (name, Popen); raise with the first failure's output,
    else return the combined output."""
    outs, failed = [], None
    for name, proc in procs:
        out, _ = proc.communicate()
        outs.append(f"== {name}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = f"{what} {name} failed ({proc.returncode}):\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(outs)


def build() -> Path:
    """Compile the library if this source hash has not been built; returns
    its path.  One nvcc per source, all started together, then one link.
    The compiler's -Xptxas -v report is kept beside the library."""
    with _lock:
        return _build()


def _build() -> Path:
    so = BUILD_DIR / f"libr0torch_{_source_hash()}.so"
    log = so.with_suffix(".log")
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in SOURCES if s.endswith(".cu")):
        obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = _run(procs, "nvcc")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    _run([("link", subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))],
        "nvcc")
    for obj in objs:
        obj.unlink()
    log.write_text(report)
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      cached=False)
    return so


def _load(path: Path) -> C.CDLL:
    lib = C.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = C.c_int
    return lib


def library() -> C.CDLL:
    """The loaded kernel library, built on the first call of the process;
    concurrent first calls build and load it once."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load(build())
    return _lib


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
