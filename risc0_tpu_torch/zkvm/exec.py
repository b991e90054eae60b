# The port's own copy of risc0_tpu/zkvm/exec.py.
"""zkVM host: ExecutorEnv, syscall table, sessions and segments.

Mirrors the reference host layer (risc0/zkvm/src/host/{client/env.rs,
server/exec/executor.rs, server/exec/syscall/*}): the guest's v1 ABI SOFTWARE
ecalls are translated by the embedded v1compat kernel into machine READ/WRITE
host ecalls; `fd` in a host read is either 0 (fetch the cached (a0, a1) return
pair) or a guest pointer to a NUL-terminated syscall name dispatched through
the syscall table.
"""

from __future__ import annotations

import ctypes as C
import io as _io
import os
from dataclasses import dataclass, field

import numpy as np

from .. import telemetry
from ..assets import V1COMPAT_ELF
from . import native

WORD_SIZE = 4
MAX_IO_BYTES = 1024

# fileno (reference platform/src/lib.rs:41-46)
STDIN, STDOUT, STDERR, JOURNAL = 0, 1, 2, 3

_NR = "risc0_zkvm_platform::syscall::nr::"
SYS_ARGC = _NR + "SYS_ARGC"
SYS_ARGV = _NR + "SYS_ARGV"
SYS_CYCLE_COUNT = _NR + "SYS_CYCLE_COUNT"
SYS_GETENV = _NR + "SYS_GETENV"
SYS_LOG = _NR + "SYS_LOG"
SYS_PANIC = _NR + "SYS_PANIC"
SYS_RANDOM = _NR + "SYS_RANDOM"
SYS_READ = _NR + "SYS_READ"
SYS_WRITE = _NR + "SYS_WRITE"
SYS_PIPE = _NR + "SYS_PIPE"
SYS_KECCAK = _NR + "SYS_KECCAK"
SYS_VERIFY_INTEGRITY = _NR + "SYS_VERIFY_INTEGRITY"
SYS_VERIFY_INTEGRITY2 = _NR + "SYS_VERIFY_INTEGRITY2"
SYS_FORK = _NR + "SYS_FORK"
SYS_EXIT = _NR + "SYS_EXIT"

# sys_keccak modes (reference platform syscall.rs:79-80)
KECCAK_PERMUTE, KECCAK_PROVE = 0, 1
KECCAK_DEFAULT_PO2 = 17
KECCAK_PERMUTE_CYCLES = 200

V1COMPAT_ELF_PATH = os.environ.get("RISC0_TPU_V1COMPAT", V1COMPAT_ELF)

REG_A3, REG_A4, REG_A5 = 13, 14, 15


class GuestPanic(Exception):
    pass


@dataclass
class ExecutorEnv:
    """Chainable env (reference host/client/env.rs:40-445)."""

    input: bytes = b""
    env_vars: dict = field(default_factory=dict)
    args: list = field(default_factory=list)
    # (claim_digest bytes, control_root bytes) -> opaque assumption for
    # sys_verify_integrity (reference host/client/env.rs add_assumption)
    assumptions: dict = field(default_factory=dict)
    keccak_max_po2: int = KECCAK_DEFAULT_PO2
    # coprocessor callback (reference env.rs:421-427 coprocessor_callback):
    # when set, each KECCAK_PROVE flush calls coprocessor.prove_keccak(req)
    # immediately — proving streams during execution — instead of queueing
    # on Session.pending_keccaks.  Not picklable: local executors only.
    coprocessor: object | None = None
    segment_po2: int = 20
    session_limit: int | None = None
    fork_max_cycles: int = 1 << 32  # unconstrained-child safety limit
    write_fds: dict = field(default_factory=dict)  # fd -> file-like
    read_fds: dict = field(default_factory=dict)   # fd -> file-like
    # guest cycle profiler (reference host/client/env.rs enable_profiler /
    # trace_callback); set to a zkvm.profiler.Profiler to collect pc->cycles
    profiler: object | None = None
    # when set, segments are written here and Session.segments holds
    # FileSegmentRefs (reference env.rs segment_path + FileSegmentRef)
    segment_path: str | None = None
    # PoVW job id (zkvm.povw.PovwJobId); provers derive one nonce per
    # segment and report joined Work (reference env.rs povw(job_id))
    povw_job_id: object | None = None

    def enable_profiler(self) -> "ExecutorEnv":
        from .profiler import Profiler

        self.profiler = Profiler()
        return self

    def write_slice(self, data: bytes) -> "ExecutorEnv":
        self.input += bytes(data)
        return self

    def write_frame(self, payload: bytes) -> "ExecutorEnv":
        self.input += len(payload).to_bytes(4, "little") + bytes(payload)
        return self

    def add_assumption(self, receipt, control_root=None) -> "ExecutorEnv":
        """Register an assumption receipt for guest env::verify
        (reference host/client/env.rs add_assumption).  Accepts anything
        with claim_digest()/claim.  The guest names it by (claim digest,
        control root): `control_root`, else the receipt's own, else zero
        (meaning "same verifier context" per reference Assumption docs)."""
        import numpy as np

        if hasattr(receipt, "claim_digest"):
            claim = np.asarray(receipt.claim_digest(), np.uint32)
        elif hasattr(receipt, "claim"):
            c = receipt.claim
            c = c() if callable(c) else c
            claim = np.asarray(c.digest() if hasattr(c, "digest") else c,
                               np.uint32)
        else:
            claim = np.asarray(receipt, np.uint32)
        root = (getattr(receipt, "control_root", None)
                if control_root is None else control_root)
        root = (np.zeros(8, np.uint32) if root is None
                else np.asarray(root, np.uint32))
        self.assumptions[(claim.tobytes(), root.tobytes())] = receipt
        return self


@dataclass
class SegmentInfo:
    index: int
    po2: int
    user_cycles: int
    paging_cycles: int
    segment_threshold: int
    pre_digest: np.ndarray
    post_digest: np.ndarray
    input_digest: np.ndarray
    output_digest: np.ndarray | None
    terminate_state: tuple | None
    pages: dict          # page_idx -> bytes(1024)
    page_digests: dict   # node_idx -> np.ndarray(8)
    read_record: list
    write_record: list
    # PoVW nonce (zkvm.povw.PovwNonce) when the env carried a povw_job_id;
    # flows into the circuit globals + the LoadRootAndNonce preflight reads
    # (reference witgen/mod.rs:309-324, preflight.rs:580-587)
    povw_nonce: object | None = None


@dataclass
class FileSegmentRef:
    """Disk-backed segment reference (reference host/server/exec/
    executor.rs:144-151 FileSegmentRef): the executor streams segments to
    `env.segment_path` and the session holds lightweight refs; provers
    call resolve() to load the full SegmentInfo."""

    path: str
    index: int
    po2: int
    user_cycles: int

    def resolve(self) -> "SegmentInfo":
        import pickle

        with open(self.path, "rb") as f:
            return pickle.load(f)


def resolve_segment(seg):
    """SegmentInfo passthrough; FileSegmentRef (or anything with
    resolve()) is loaded."""
    return seg.resolve() if hasattr(seg, "resolve") else seg


@dataclass
class Session:
    segments: list
    journal: bytes
    exit_code: tuple  # (kind, code): ("Halted", c) | ("SessionLimit",)
    user_cycles: int
    total_cycles: int
    paging_cycles: int
    reserved_cycles: int
    pre_state: np.ndarray
    post_state: np.ndarray
    input_digest: np.ndarray
    output_digest: np.ndarray | None
    pending_keccaks: list = field(default_factory=list)
    assumptions_used: list = field(default_factory=list)
    povw_job_id: object | None = None


class _SyscallState:
    """Per-run syscall machinery (reference exec/executor.rs:340-420)."""

    def __init__(self, env: ExecutorEnv, lib):
        self.env = env
        self.lib = lib
        self.return_cache = (0, 0)
        self.stdin = _io.BytesIO(env.input)
        self.journal = _io.BytesIO()
        self.stdout = _io.BytesIO()
        self.stderr = _io.BytesIO()
        self.readers = {STDIN: self.stdin, **env.read_fds}
        self.writers = {
            STDOUT: self.stdout, STDERR: self.stderr, JOURNAL: self.journal,
            **env.write_fds,
        }
        self.error: Exception | None = None
        self.next_fd = 4
        self.keccak_inputs = []
        self.pending_keccaks = []   # ProveKeccakRequest dicts
        self.assumptions_used = []

    # -- machine peeks -------------------------------------------------------
    def peek_string(self, machine, addr: int) -> str:
        out = bytearray()
        while True:
            buf = (C.c_uint8 * 64)()
            self.lib.r0_machine_peek_region(machine, addr, 64, buf)
            chunk = bytes(buf)
            if b"\0" in chunk:
                out += chunk[: chunk.index(b"\0")]
                return out.decode()
            out += chunk
            addr += 64
            if len(out) > 4096:
                raise RuntimeError("unterminated syscall name")

    def peek_region(self, machine, addr: int, length: int) -> bytes:
        buf = (C.c_uint8 * max(length, 1))()
        self.lib.r0_machine_peek_region(machine, addr, length, buf)
        return bytes(buf[:length])

    def user_reg(self, machine, idx: int) -> int:
        return self.lib.r0_machine_user_reg(machine, idx)

    # -- host read/write entry points ---------------------------------------
    def host_read(self, machine, fd: int, buf_len: int) -> bytes:
        if fd == 0:
            a0, a1 = self.return_cache
            return a0.to_bytes(4, "little") + a1.to_bytes(4, "little")
        name = self.peek_string(machine, fd)
        words = (buf_len + WORD_SIZE - 1) // WORD_SIZE
        to_guest = bytearray(words * WORD_SIZE)
        self.return_cache = self.dispatch(machine, name, to_guest)
        return bytes(to_guest[:buf_len])

    def host_write(self, machine, fd: int, data: bytes) -> int:
        # kernel-side log write (reference executor.rs:397-401)
        self.stderr.write(data)
        return len(data)

    # -- syscall table -------------------------------------------------------
    def dispatch(self, machine, name: str, to_guest: bytearray):
        if name == SYS_READ:
            return self._sys_read(machine, to_guest)
        if name == SYS_WRITE:
            return self._sys_write(machine)
        if name == SYS_LOG:
            ptr = self.user_reg(machine, REG_A3)
            ln = self.user_reg(machine, REG_A4)
            msg = self.peek_region(machine, ptr, ln)
            cycle = self.lib.r0_machine_user_cycles(machine)
            self.stdout.write(b"R0VM[%d] " % cycle + msg + b"\n")
            return (0, 0)
        if name == SYS_GETENV:
            ptr = self.user_reg(machine, REG_A3)
            ln = self.user_reg(machine, REG_A4)
            key = self.peek_region(machine, ptr, ln).decode()
            val = self.env_get(key)
            if val is None:
                return (0xFFFFFFFF, 0)
            vb = val.encode()
            n = min(len(to_guest), len(vb))
            to_guest[:n] = vb[:n]
            return (len(vb), 0)
        if name == SYS_CYCLE_COUNT:
            cycle = self.lib.r0_machine_user_cycles(machine)
            return (cycle >> 32, cycle & 0xFFFFFFFF)
        if name == SYS_RANDOM:
            rnd = os.urandom(len(to_guest))
            to_guest[:] = rnd
            return (len(to_guest), 0)
        if name == SYS_PANIC:
            ptr = self.user_reg(machine, REG_A3)
            ln = self.user_reg(machine, REG_A4)
            msg = self.peek_region(machine, ptr, ln).decode(errors="replace")
            raise GuestPanic(msg)
        if name == SYS_PIPE:
            # allocate a connected fd pair (reference syscall/pipe.rs)
            if len(to_guest) != 8:
                raise RuntimeError("invalid sys_pipe call")
            buf = _io.BytesIO()
            read_fd, write_fd = self.next_fd, self.next_fd + 1
            self.next_fd += 2

            class _Pipe:
                def __init__(self):
                    self.data = bytearray()

                def read(self, n):
                    out = bytes(self.data[:n])
                    del self.data[:n]
                    return out

                def write(self, b):
                    self.data.extend(b)
                    return len(b)

            pipe = _Pipe()
            self.readers[read_fd] = pipe
            self.writers[write_fd] = pipe
            to_guest[0:4] = read_fd.to_bytes(4, "little")
            to_guest[4:8] = write_fd.to_bytes(4, "little")
            return (0, 0)
        if name == SYS_KECCAK:
            return self._sys_keccak(machine, to_guest)
        if name == SYS_VERIFY_INTEGRITY:
            ptr = self.user_reg(machine, REG_A3)
            ln = self.user_reg(machine, REG_A4)
            data = self.peek_region(machine, ptr, ln)
            claim, root = bytes(data[:32]), bytes(data[32:64])
            key = (claim, root)
            if key not in self.env.assumptions:
                raise RuntimeError(
                    "sys_verify_integrity: no receipt found to resolve "
                    f"assumption: claim {claim.hex()}")
            from .claims import Assumption

            assumption = Assumption(
                np.frombuffer(claim, np.uint32).copy(),
                np.frombuffer(root, np.uint32).copy())
            self.assumptions_used.insert(
                0, (assumption, self.env.assumptions[key]))
            return (0, 0)
        if name == SYS_VERIFY_INTEGRITY2:
            # Unresolved assumption (reference syscall/verify2.rs): the
            # guest assumes (claim, control_root) WITHOUT a host receipt —
            # the prover must later resolve it (e.g. the keccak batcher
            # assumes the union-MMR root that the coprocessor receipts
            # prove; prover_impl.rs:122-153).
            ptr = self.user_reg(machine, REG_A3)
            ln = self.user_reg(machine, REG_A4)
            data = self.peek_region(machine, ptr, ln)
            claim, root = bytes(data[:32]), bytes(data[32:64])
            from .claims import Assumption

            assumption = Assumption(
                np.frombuffer(claim, np.uint32).copy(),
                np.frombuffer(root, np.uint32).copy())
            self.assumptions_used.insert(0, (assumption, None))
            return (0, 0)
        if name == SYS_FORK:
            return self._sys_fork(machine)
        if name == SYS_ARGC:
            return (len(self.env.args), 0)
        if name == SYS_ARGV:
            idx = self.user_reg(machine, REG_A3)
            arg = self.env.args[idx].encode()
            n = min(len(to_guest), len(arg))
            to_guest[:n] = arg[:n]
            return (len(arg), 0)
        raise RuntimeError(f"Unknown syscall: {name}")

    def env_get(self, key):
        return self.env.env_vars.get(key)

    def _sys_keccak(self, machine, to_guest: bytearray):
        """Keccak coprocessor syscall (reference syscall/keccak.rs)."""
        from ..circuit.keccak.preflight import keccak_f

        mode = self.user_reg(machine, REG_A3)
        if mode == KECCAK_PERMUTE:
            max_inputs = (1 << self.env.keccak_max_po2) // KECCAK_PERMUTE_CYCLES
            if len(self.keccak_inputs) >= max_inputs:
                raise RuntimeError("keccak batch is full, prove must be called")
            ptr = self.user_reg(machine, REG_A4)
            raw = self.peek_region(machine, ptr, 25 * 8)
            state = [int.from_bytes(raw[i * 8:(i + 1) * 8], "little")
                     for i in range(25)]
            self.keccak_inputs.append(list(state))
            out = keccak_f(state)
            for i, x in enumerate(out):
                to_guest[i * 8:(i + 1) * 8] = x.to_bytes(8, "little")
            full = len(self.keccak_inputs) >= max_inputs
            return (1 if full else 0, 0)
        if mode == KECCAK_PROVE:
            claim = bytes(self.peek_region(
                machine, self.user_reg(machine, REG_A4), 32))
            root = bytes(self.peek_region(
                machine, self.user_reg(machine, REG_A5), 32))
            req = {
                "claim_digest": claim, "control_root": root,
                "input": [list(s) for s in self.keccak_inputs],
                "po2": self.env.keccak_max_po2,
            }
            if self.env.coprocessor is not None:
                # stream the proof request out immediately (reference
                # syscall/keccak.rs:115-116 coprocessor path)
                self.env.coprocessor.prove_keccak(req)
            else:
                self.pending_keccaks.append(req)
            self.keccak_inputs = []
            return (0, 0)
        raise RuntimeError(f"sys_keccak: invalid mode: {mode}")

    def _sys_fork(self, machine):
        """Parent side of sys_fork (reference host/server/exec/syscall/
        fork.rs:52-63): deep-fork the machine, run the copy-on-write child
        unconstrained until it exits, discard its memory, return
        PID_PARENT.  The child resumes at the same ecall (pc hasn't
        advanced), re-issues SYS_FORK through its own callbacks, and the
        child dispatch answers PID_CHILD."""
        from . import native

        lib = self.lib
        child_state = _ChildSyscallState(self)

        def on_read(user, mach, fd, buf, length):
            try:
                data = child_state.host_read(mach, fd, length)
                n = min(len(data), length)
                C.memmove(buf, data, n)
                return n
            except Exception as e:
                if child_state.error is None:
                    child_state.error = e
                return 0

        def on_write(user, mach, fd, buf, length):
            try:
                return child_state.host_write(
                    mach, fd, C.string_at(buf, length) if length else b"")
            except Exception as e:
                if child_state.error is None:
                    child_state.error = e
                return 0

        read_cb = native.HOST_READ_FN(on_read)
        write_cb = native.HOST_WRITE_FN(on_write)
        out_io = C.c_void_p()
        child = lib.r0_machine_fork(machine, None, read_cb, write_cb,
                                    C.byref(out_io))
        if not child:
            raise RuntimeError(lib.r0_last_error().decode())
        try:
            rc = lib.r0_machine_fork_run(child, self.env.fork_max_cycles)
            if child_state.error is not None:
                raise child_state.error
            if rc == 1:
                raise RuntimeError(
                    f"fork child failed: {lib.r0_last_error().decode()}")
            if rc == 2:
                raise RuntimeError("fork child exceeded cycle limit")
        finally:
            lib.r0_machine_fork_free(child, out_io)
        return (1, 0)

    def _sys_read(self, machine, to_guest: bytearray):
        fd = self.user_reg(machine, REG_A3)
        nbytes = self.user_reg(machine, REG_A4)
        reader = self.readers.get(fd)
        if reader is None:
            raise RuntimeError(f"Bad read fd: {fd}")
        main = reader.read(len(to_guest))
        main = main or b""
        to_guest[: len(main)] = main
        unaligned_end = nbytes - len(main) if nbytes - len(main) <= WORD_SIZE else 0
        tail = reader.read(unaligned_end) if unaligned_end else b""
        tail_word = int.from_bytes((tail or b"").ljust(4, b"\0"), "little")
        return (len(main) + len(tail or b""), tail_word)

    def _sys_write(self, machine):
        fd = self.user_reg(machine, REG_A3)
        ptr = self.user_reg(machine, REG_A4)
        ln = self.user_reg(machine, REG_A5)
        data = self.peek_region(machine, ptr, ln)
        writer = self.writers.get(fd)
        if writer is None:
            raise RuntimeError(f"Bad write fd: {fd}")
        writer.write(data)
        return (0, 0)


class _ChildSyscallState:
    """Syscall view for a forked (unconstrained) child: nested forks answer
    PID_CHILD, journal writes are rejected, everything else delegates to
    the parent state with shared fd cursors (reference fork.rs:85-95)."""

    def __init__(self, parent: _SyscallState):
        self.parent = parent
        self.return_cache = (0, 0)
        self.error: Exception | None = None

    def host_read(self, machine, fd: int, buf_len: int) -> bytes:
        if fd == 0:
            a0, a1 = self.return_cache
            return a0.to_bytes(4, "little") + a1.to_bytes(4, "little")
        name = self.parent.peek_string(machine, fd)
        words = (buf_len + WORD_SIZE - 1) // WORD_SIZE
        to_guest = bytearray(words * WORD_SIZE)
        self.return_cache = self.dispatch(machine, name, to_guest)
        return bytes(to_guest[:buf_len])

    def host_write(self, machine, fd: int, data: bytes) -> int:
        return self.parent.host_write(machine, fd, data)

    def dispatch(self, machine, name: str, to_guest: bytearray):
        if name == SYS_FORK:
            return (0, 0)  # this execution IS the child
        if name == SYS_EXIT:
            # stop the child run loop after this step (fork.rs:141-144)
            self.parent.lib.r0_machine_terminate(machine, 0, 0)
            return (0, 0)
        if name == SYS_WRITE:
            if self.parent.user_reg(machine, REG_A3) == JOURNAL:
                raise RuntimeError(
                    "journal write from an unconstrained (forked) child")
        return self.parent.dispatch(machine, name, to_guest)


def _digest_np(arr) -> np.ndarray:
    return np.array(list(arr), np.uint32)


def preflight_segment(seg: "SegmentInfo") -> dict:
    """Record the witgen preflight trace for a segment (reference
    prove/witgen/preflight.rs): per-cycle rows, memory transactions, and
    back payloads for the accelerator cycles.

    Returns dict with numpy arrays: cycles (n, 11), txns (m, 5),
    back_kind (n,), back_offset (n,), back_data (k,), table_split_cycle.
    """
    lib = native.lib()
    page_indexes = np.array(sorted(seg.pages), np.uint32)
    page_data = b"".join(seg.pages[i] for i in page_indexes)
    digest_indexes = np.array(sorted(seg.page_digests), np.uint32)
    digest_words = np.concatenate(
        [seg.page_digests[i] for i in digest_indexes]).astype(np.uint32) \
        if len(digest_indexes) else np.zeros(0, np.uint32)
    reads = b"".join(seg.read_record)
    read_lens = np.array([len(r) for r in seg.read_record], np.uint64)
    write_lens = np.array(seg.write_record, np.uint32)
    input_d = np.asarray(seg.input_digest, np.uint32)

    out = {}

    def on_view(user, view_ptr):
        v = view_ptr.contents
        n, m, k = v.num_cycles, v.num_txns, v.back_data_len
        out["cycles"] = np.ctypeslib.as_array(v.cycles, (n, 11)).copy() \
            if n else np.zeros((0, 11), np.uint32)
        out["txns"] = np.ctypeslib.as_array(v.txns, (m, 5)).copy() \
            if m else np.zeros((0, 5), np.uint32)
        out["back_kind"] = np.ctypeslib.as_array(v.back_kind, (n,)).copy()
        out["back_offset"] = np.ctypeslib.as_array(v.back_offset, (n,)).copy()
        out["back_data"] = np.ctypeslib.as_array(v.back_data, (k,)).copy() \
            if k else np.zeros(0, np.uint32)
        bb = v.bigint_bytes_len
        out["bigint_bytes"] = np.ctypeslib.as_array(
            v.bigint_bytes, (bb,)).copy() if bb else np.zeros(0, np.uint32)
        out["table_split_cycle"] = v.table_split_cycle

    cb = native.PREFLIGHT_FN(on_view)
    rc = lib.r0_preflight_segment(
        len(page_indexes),
        page_indexes.ctypes.data_as(C.POINTER(C.c_uint32)),
        C.cast(C.create_string_buffer(page_data, len(page_data)),
               C.POINTER(C.c_uint8)),
        len(digest_indexes),
        digest_indexes.ctypes.data_as(C.POINTER(C.c_uint32)),
        digest_words.ctypes.data_as(C.POINTER(C.c_uint32)),
        seg.user_cycles, seg.po2, getattr(seg, "segment_threshold", 0) or 0,
        1 if seg.terminate_state is not None else 0,
        C.cast(C.create_string_buffer(reads, max(len(reads), 1)),
               C.POINTER(C.c_uint8)),
        read_lens.ctypes.data_as(C.POINTER(C.c_uint64)), len(read_lens),
        write_lens.ctypes.data_as(C.POINTER(C.c_uint32)), len(write_lens),
        input_d.ctypes.data_as(C.POINTER(C.c_uint32)),
        (nonce_np.ctypes.data_as(C.POINTER(C.c_uint32))
         if (nonce_np := _povw_nonce_words(seg)) is not None else None),
        None, cb)
    if rc != 0:
        raise RuntimeError(lib.r0_last_error().decode())
    return out


def _povw_nonce_words(seg) -> "np.ndarray | None":
    """Segment PoVW nonce as 8 LE u32 words (binfmt povw.rs to_u32s), or
    None when PoVW is unused."""
    nonce = getattr(seg, "povw_nonce", None)
    if nonce is None:
        return None
    return np.frombuffer(nonce.to_bytes(), np.uint32).copy()


def replay_segment(seg: "SegmentInfo", input_digest=None) -> dict:
    """Deterministically re-execute one segment standalone from its partial
    pre-image + recorded IO (reference execute/segment.rs:69-84).

    Returns {user_cycles, pager_cycles, terminate_state, pre_digest,
    post_digest}; the digests must reproduce the claim exactly.
    """
    lib = native.lib()
    page_indexes = np.array(sorted(seg.pages), np.uint32)
    page_data = b"".join(seg.pages[i] for i in page_indexes)
    digest_indexes = np.array(sorted(seg.page_digests), np.uint32)
    digest_words = np.concatenate(
        [seg.page_digests[i] for i in digest_indexes]).astype(np.uint32) \
        if len(digest_indexes) else np.zeros(0, np.uint32)
    reads = b"".join(seg.read_record)
    read_lens = np.array([len(r) for r in seg.read_record], np.uint64)
    write_lens = np.array(seg.write_record, np.uint32)
    input_d = np.asarray(
        input_digest if input_digest is not None else seg.input_digest,
        np.uint32)

    res = native.R0ReplayResult()
    rc = lib.r0_replay_segment(
        len(page_indexes),
        page_indexes.ctypes.data_as(C.POINTER(C.c_uint32)),
        C.cast(C.create_string_buffer(page_data, len(page_data)),
               C.POINTER(C.c_uint8)),
        len(digest_indexes),
        digest_indexes.ctypes.data_as(C.POINTER(C.c_uint32)),
        digest_words.ctypes.data_as(C.POINTER(C.c_uint32)),
        seg.user_cycles, seg.po2,
        C.cast(C.create_string_buffer(reads, max(len(reads), 1)),
               C.POINTER(C.c_uint8)),
        read_lens.ctypes.data_as(C.POINTER(C.c_uint64)), len(read_lens),
        write_lens.ctypes.data_as(C.POINTER(C.c_uint32)), len(write_lens),
        input_d.ctypes.data_as(C.POINTER(C.c_uint32)), C.byref(res))
    if rc != 0:
        raise RuntimeError(lib.r0_last_error().decode())
    return {
        "user_cycles": res.user_cycles,
        "pager_cycles": res.pager_cycles,
        "terminate_state": (res.terminate_a0, res.terminate_a1)
        if res.has_terminate else None,
        "pre_digest": _digest_np(res.pre_digest),
        "post_digest": _digest_np(res.post_digest),
    }


class ExecutorImpl:
    """Execute a guest ELF (+kernel) into a Session of segments
    (reference host/server/exec/executor.rs:54-330)."""

    def __init__(self, env: ExecutorEnv, user_elf: bytes,
                 kernel_elf: bytes | None = None):
        self.env = env
        self.user_elf = bytes(user_elf)
        if kernel_elf is None:
            with open(V1COMPAT_ELF_PATH, "rb") as f:
                kernel_elf = f.read()
        self.kernel_elf = bytes(kernel_elf)
        self._session = None  # live r0 session handle (kept across pause)

    @staticmethod
    def from_program_binary(env: ExecutorEnv, blob: bytes) -> "ExecutorImpl":
        from .binfmt import ProgramBinary

        pb = ProgramBinary.decode(blob)
        return ExecutorImpl(env, pb.user_elf, pb.kernel_elf)

    @staticmethod
    def from_kernel_elf(env: ExecutorEnv, elf: bytes) -> "ExecutorImpl":
        """Bare-metal (kernel-only) program, no userspace — e.g. the
        official riscv-tests ISA binaries (reference executor.rs:119-123
        from_kernel_elf / image.rs new_kernel)."""
        return ExecutorImpl(env, b"", kernel_elf=elf)

    def compute_image_id(self) -> np.ndarray:
        """User-facing image ID = SystemState{pc: 0, merkle_root}.digest()
        (reference binfmt/src/elf.rs:403-406), i.e. the digest of the claim
        pre-state — what Receipt.verify(image_id) compares against."""
        from .claims import SystemState

        lib = native.lib()
        out = (C.c_uint32 * 8)()
        rc = lib.r0_compute_image_id(self.user_elf, len(self.user_elf),
                                     self.kernel_elf, len(self.kernel_elf), out)
        if rc != 0:
            raise RuntimeError(lib.r0_last_error().decode())
        return SystemState(0, _digest_np(out)).digest()

    def _dump_for_replay(self) -> None:
        """On execution error, dump everything needed to replay the run
        offline (reference execute/executor.rs:389-425 RISC0_DUMP_PATH)."""
        path = os.environ.get("RISC0_DUMP_PATH")
        if not path:
            return
        import pickle

        try:
            with open(path, "wb") as f:
                pickle.dump({
                    "user_elf": self.user_elf,
                    "kernel_elf": self.kernel_elf,
                    "input": self.env.input,
                    "segment_po2": self.env.segment_po2,
                    "session_limit": self.env.session_limit,
                }, f)
        except OSError:
            pass  # best-effort diagnostic dump

    def run(self, segment_callback=None) -> Session:
        with telemetry.boundary("execute") as sp:
            session = self._execute(segment_callback)
            sp.set(segments=len(session.segments))
            return session

    def _execute(self, segment_callback) -> Session:
        lib = native.lib()
        state = _SyscallState(self.env, lib)
        segments: list[SegmentInfo] = []

        def on_read(user, machine, fd, buf, length):
            try:
                data = state.host_read(machine, fd, length)
                n = min(len(data), length)
                C.memmove(buf, data, n)
                return n
            except Exception as e:  # propagate after native frame unwinds
                if state.error is None:
                    state.error = e
                return 0

        def on_write(user, machine, fd, buf, length):
            try:
                data = C.string_at(buf, length)
                return state.host_write(machine, fd, data)
            except Exception as e:
                if state.error is None:
                    state.error = e
                return 0

        def on_segment(user, seg_ptr):
            seg = seg_ptr.contents
            pages = {}
            for i in range(seg.num_pages):
                idx = seg.page_indexes[i]
                pages[idx] = C.string_at(
                    C.addressof(seg.page_data.contents) + i * 1024, 1024)
            digests = {}
            for i in range(seg.num_digests):
                digests[seg.digest_indexes[i]] = np.array(
                    seg.digest_words[i * 8 : (i + 1) * 8], np.uint32)
            reads, off = [], 0
            raw = C.string_at(seg.read_record, seg.read_record_len) \
                if seg.read_record_len else b""
            for i in range(seg.num_reads):
                ln = seg.read_lens[i]
                reads.append(raw[off : off + ln])
                off += ln
            info = SegmentInfo(
                index=seg.index, po2=seg.po2,
                user_cycles=seg.suspend_cycle, paging_cycles=seg.paging_cycles,
                segment_threshold=seg.segment_threshold,
                pre_digest=_digest_np(seg.pre_digest),
                post_digest=_digest_np(seg.post_digest),
                input_digest=_digest_np(seg.input_digest),
                output_digest=_digest_np(seg.output_digest) if seg.has_output else None,
                terminate_state=(seg.terminate_a0, seg.terminate_a1)
                if seg.has_terminate else None,
                pages=pages, page_digests=digests,
                read_record=reads,
                write_record=[seg.write_lens[i] for i in range(seg.num_writes)],
                povw_nonce=(self.env.povw_job_id.nonce(seg.index)
                            if self.env.povw_job_id is not None else None),
            )
            if self.env.segment_path is not None:
                import pickle

                os.makedirs(self.env.segment_path, exist_ok=True)
                path = os.path.join(self.env.segment_path,
                                    f"{info.index}.seg")
                with open(path, "wb") as f:
                    pickle.dump(info, f)
                segments.append(FileSegmentRef(
                    path=path, index=info.index, po2=info.po2,
                    user_cycles=info.user_cycles))
            else:
                segments.append(info)
            if segment_callback:
                segment_callback(info)

        read_cb = native.HOST_READ_FN(on_read)
        write_cb = native.HOST_WRITE_FN(on_write)
        seg_cb = native.SEGMENT_FN(on_segment)

        # persistent session: a paused run keeps the handle so a subsequent
        # run() resumes after the sys_pause ecall (reference guest env
        # pause/resume, host executor.rs run semantics)
        if self._session is None:
            self._session = lib.r0_session_create(
                self.user_elf, len(self.user_elf),
                self.kernel_elf, len(self.kernel_elf))
            if not self._session:
                raise RuntimeError(lib.r0_last_error().decode())
            if self.env.profiler is not None:
                lib.r0_session_enable_profile(self._session)
                self.env.profiler.elfs.extend(
                    [self.user_elf, self.kernel_elf])

        result = native.R0Result()
        input_digest = (C.c_uint32 * 8)()  # zero digest default
        rc = lib.r0_session_run(
            self._session, self.env.segment_po2,
            self.env.session_limit or 0,
            input_digest, None, read_cb, write_cb, None, seg_cb,
            C.byref(result))
        if state.error is not None or rc != 0:
            self._dump_for_replay()
        if state.error is not None:
            raise state.error
        if rc != 0:
            raise RuntimeError(lib.r0_last_error().decode())

        # terminate a0 = (user_exit << 16) | halt_type
        # (reference claim/receipt.rs:310-324: 0 -> Halted, 1 -> Paused)
        if result.has_terminate:
            user_exit = result.terminate_a0 >> 16
            halt_type = result.terminate_a0 & 0xFFFF
            kind = {0: "Halted", 1: "Paused"}.get(halt_type)
            if kind is None:
                raise RuntimeError(f"illegal halt type {halt_type}")
            exit_code = (kind, user_exit)
        else:
            exit_code = ("SessionLimit",)
        if self.env.profiler is not None:
            from .profiler import read_profile

            pcs, cyc = read_profile(lib, self._session)
            self.env.profiler.samples.clear()
            self.env.profiler.add_samples(pcs, cyc)
        if exit_code[0] != "Paused":
            lib.r0_session_free(self._session)
            self._session = None
        # On Halted the session post state root is zeroed (reference
        # host/server/exec/executor.rs:279-282), making the final claim
        # digest-comparable with ReceiptClaim::ok.
        post_state = (np.zeros(8, np.uint32) if exit_code[0] == "Halted"
                      else _digest_np(result.post_state))
        return Session(
            povw_job_id=self.env.povw_job_id,
            pending_keccaks=state.pending_keccaks,
            assumptions_used=state.assumptions_used,
            segments=segments,
            journal=state.journal.getvalue(),
            exit_code=exit_code,
            user_cycles=result.user_cycles,
            total_cycles=result.total_cycles,
            paging_cycles=result.paging_cycles,
            reserved_cycles=result.reserved_cycles,
            pre_state=_digest_np(result.pre_state),
            post_state=post_state,
            input_digest=_digest_np(result.input),
            output_digest=_digest_np(result.output) if result.has_output else None,
        )
