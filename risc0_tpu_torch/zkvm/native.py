# The port's own copy of risc0_tpu/zkvm/native.py.
"""ctypes binding to the native rv32im executor (csrc/libr0vm.so).

The C++ core mirrors the reference executor behavior (see csrc/r0vm.h for the
file-level provenance map); this module loads it, auto-building if needed.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading

from ..assets import CSRC

_LIB_PATH = os.path.join(CSRC, "libr0vm.so")


def _build():
    subprocess.run(["make", "-C", CSRC], check=True,
                   capture_output=True)


def _load():
    if not os.path.exists(_LIB_PATH):
        _build()
    return C.CDLL(_LIB_PATH)


_lib = None
_lib_lock = threading.Lock()


def lib():
    """The configured library, built and loaded once: the first callers
    of several threads wait for one build."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib_ = _load()
                _configure(lib_)
                _lib = lib_
    return _lib


HOST_READ_FN = C.CFUNCTYPE(C.c_uint32, C.c_void_p, C.c_void_p, C.c_uint32,
                           C.POINTER(C.c_uint8), C.c_uint32)
HOST_WRITE_FN = C.CFUNCTYPE(C.c_uint32, C.c_void_p, C.c_void_p, C.c_uint32,
                            C.POINTER(C.c_uint8), C.c_uint32)


class R0Segment(C.Structure):
    _fields_ = [
        ("index", C.c_uint64),
        ("po2", C.c_uint32),
        ("suspend_cycle", C.c_uint32),
        ("paging_cycles", C.c_uint32),
        ("segment_threshold", C.c_uint32),
        ("has_output", C.c_uint32),
        ("has_terminate", C.c_uint32),
        ("terminate_a0", C.c_uint32),
        ("terminate_a1", C.c_uint32),
        ("pre_digest", C.c_uint32 * 8),
        ("post_digest", C.c_uint32 * 8),
        ("input_digest", C.c_uint32 * 8),
        ("output_digest", C.c_uint32 * 8),
        ("num_pages", C.c_uint64),
        ("page_indexes", C.POINTER(C.c_uint32)),
        ("page_data", C.POINTER(C.c_uint8)),
        ("num_digests", C.c_uint64),
        ("digest_indexes", C.POINTER(C.c_uint32)),
        ("digest_words", C.POINTER(C.c_uint32)),
        ("read_record_len", C.c_uint64),
        ("read_record", C.POINTER(C.c_uint8)),
        ("num_reads", C.c_uint64),
        ("read_lens", C.POINTER(C.c_uint64)),
        ("num_writes", C.c_uint64),
        ("write_lens", C.POINTER(C.c_uint32)),
    ]


SEGMENT_FN = C.CFUNCTYPE(None, C.c_void_p, C.POINTER(R0Segment))


class R0PreflightView(C.Structure):
    _fields_ = [
        ("num_cycles", C.c_uint64),
        ("cycles", C.POINTER(C.c_uint32)),
        ("num_txns", C.c_uint64),
        ("txns", C.POINTER(C.c_uint32)),
        ("back_kind", C.POINTER(C.c_uint8)),
        ("back_offset", C.POINTER(C.c_uint32)),
        ("back_data_len", C.c_uint64),
        ("back_data", C.POINTER(C.c_uint32)),
        ("bigint_bytes_len", C.c_uint64),
        ("bigint_bytes", C.POINTER(C.c_uint32)),
        ("table_split_cycle", C.c_uint32),
    ]


PREFLIGHT_FN = C.CFUNCTYPE(None, C.c_void_p, C.POINTER(R0PreflightView))


class R0ReplayResult(C.Structure):
    _fields_ = [
        ("user_cycles", C.c_uint32),
        ("pager_cycles", C.c_uint32),
        ("has_terminate", C.c_uint32),
        ("terminate_a0", C.c_uint32),
        ("terminate_a1", C.c_uint32),
        ("pre_digest", C.c_uint32 * 8),
        ("post_digest", C.c_uint32 * 8),
    ]


class R0Result(C.Structure):
    _fields_ = [
        ("segments", C.c_uint64),
        ("user_cycles", C.c_uint64),
        ("total_cycles", C.c_uint64),
        ("paging_cycles", C.c_uint64),
        ("reserved_cycles", C.c_uint64),
        ("pre_state", C.c_uint32 * 8),
        ("post_state", C.c_uint32 * 8),
        ("input", C.c_uint32 * 8),
        ("output", C.c_uint32 * 8),
        ("has_output", C.c_uint32),
        ("has_terminate", C.c_uint32),
        ("terminate_a0", C.c_uint32),
        ("terminate_a1", C.c_uint32),
    ]


def _configure(l):
    l.r0_last_error.restype = C.c_char_p
    l.r0_compute_image_id.restype = C.c_int
    l.r0_compute_image_id.argtypes = [
        C.c_char_p, C.c_uint64, C.c_char_p, C.c_uint64, C.POINTER(C.c_uint32)]
    l.r0_execute_elf.restype = C.c_int
    l.r0_execute_elf.argtypes = [
        C.c_char_p, C.c_uint64, C.c_char_p, C.c_uint64,
        C.c_uint32, C.c_uint64, C.POINTER(C.c_uint32),
        C.c_void_p, HOST_READ_FN, HOST_WRITE_FN,
        C.c_void_p, SEGMENT_FN, C.POINTER(R0Result)]
    l.r0_machine_peek.restype = C.c_uint32
    l.r0_machine_peek.argtypes = [C.c_void_p, C.c_uint32]
    l.r0_machine_user_reg.restype = C.c_uint32
    l.r0_machine_user_reg.argtypes = [C.c_void_p, C.c_uint32]
    l.r0_machine_user_cycles.restype = C.c_uint64
    l.r0_machine_user_cycles.argtypes = [C.c_void_p]
    l.r0_machine_peek_region.restype = None
    l.r0_machine_peek_region.argtypes = [
        C.c_void_p, C.c_uint32, C.c_uint32, C.POINTER(C.c_uint8)]
    l.r0_replay_segment.restype = C.c_int
    l.r0_replay_segment.argtypes = [
        C.c_uint64, C.POINTER(C.c_uint32), C.POINTER(C.c_uint8),
        C.c_uint64, C.POINTER(C.c_uint32), C.POINTER(C.c_uint32),
        C.c_uint32, C.c_uint32,
        C.POINTER(C.c_uint8), C.POINTER(C.c_uint64), C.c_uint64,
        C.POINTER(C.c_uint32), C.c_uint64,
        C.POINTER(C.c_uint32), C.POINTER(R0ReplayResult)]
    l.r0_preflight_segment.restype = C.c_int
    l.r0_preflight_segment.argtypes = [
        C.c_uint64, C.POINTER(C.c_uint32), C.POINTER(C.c_uint8),
        C.c_uint64, C.POINTER(C.c_uint32), C.POINTER(C.c_uint32),
        C.c_uint32, C.c_uint32, C.c_uint32, C.c_uint32,
        C.POINTER(C.c_uint8), C.POINTER(C.c_uint64), C.c_uint64,
        C.POINTER(C.c_uint32), C.c_uint64,
        C.POINTER(C.c_uint32), C.POINTER(C.c_uint32), C.c_void_p,
        PREFLIGHT_FN]
    l.r0_machine_fork.restype = C.c_void_p
    l.r0_machine_fork.argtypes = [C.c_void_p, C.c_void_p, HOST_READ_FN,
                                  HOST_WRITE_FN, C.POINTER(C.c_void_p)]
    l.r0_machine_fork_run.restype = C.c_int
    l.r0_machine_fork_run.argtypes = [C.c_void_p, C.c_uint64]
    l.r0_machine_terminate.restype = None
    l.r0_machine_terminate.argtypes = [C.c_void_p, C.c_uint32, C.c_uint32]
    l.r0_machine_fork_free.restype = None
    l.r0_machine_fork_free.argtypes = [C.c_void_p, C.c_void_p]
    l.r0_session_create.restype = C.c_void_p
    l.r0_session_create.argtypes = [C.c_char_p, C.c_uint64, C.c_char_p,
                                    C.c_uint64]
    l.r0_session_run.restype = C.c_int
    l.r0_session_run.argtypes = [
        C.c_void_p, C.c_uint32, C.c_uint64, C.POINTER(C.c_uint32),
        C.c_void_p, HOST_READ_FN, HOST_WRITE_FN,
        C.c_void_p, SEGMENT_FN, C.POINTER(R0Result)]
    l.r0_session_enable_profile.restype = None
    l.r0_session_enable_profile.argtypes = [C.c_void_p]
    l.r0_session_profile_size.restype = C.c_uint64
    l.r0_session_profile_size.argtypes = [C.c_void_p]
    l.r0_session_profile_read.restype = None
    l.r0_session_profile_read.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint32), C.POINTER(C.c_uint64)]
    l.r0_session_free.restype = None
    l.r0_session_free.argtypes = [C.c_void_p]
    l.r0_page_digest.restype = C.c_int
    l.r0_page_digest.argtypes = [C.c_char_p, C.POINTER(C.c_uint32)]
    l.r0_digest_pair.restype = C.c_int
    l.r0_digest_pair.argtypes = [
        C.POINTER(C.c_uint32), C.POINTER(C.c_uint32), C.POINTER(C.c_uint32)]
