# The port's own copy of risc0_tpu/zkvm/gdb.py.
"""GDB stub: Remote Serial Protocol server over the debug machine
(reference risc0/circuit/rv32im/src/execute/gdb.rs).

`GdbStub(elf, input=...)` creates a single-stepping guest machine
(csrc r0_debug_* API) and serves the RSP packets gdb's `target remote`
speaks: register/memory reads, software breakpoints (Z0/z0), continue and
single-step with stop replies, kill/detach.  RISC-V rv32 register layout:
32 GPRs + pc, little-endian hex.

    stub = GdbStub(elf, input=data)
    port = stub.listen()        # -> riscv32 gdb: target remote :port
    stub.serve_forever()

The transport is loopback-trust like the reference's stdio stub.
"""

from __future__ import annotations

import ctypes as C
import socket

import numpy as np

from . import native
from .exec import V1COMPAT_ELF_PATH


class DebugMachine:
    """ctypes wrapper over the csrc debug session."""

    def __init__(self, user_elf: bytes, input_data: bytes = b"",
                 kernel_elf: bytes | None = None):
        if kernel_elf is None:
            with open(V1COMPAT_ELF_PATH, "rb") as f:
                kernel_elf = f.read()
        self.lib = native.lib()
        self._configure(self.lib)
        self._stdin = bytearray(input_data)

        def on_read(user, machine, fd, buf, length):
            # fd 0 return-cache reads come as fd==0 with the machine's
            # syscall protocol; serve plain stdin bytes for SYS_READ
            n = min(len(self._stdin), length)
            C.memmove(buf, bytes(self._stdin[:n]), n)
            del self._stdin[:n]
            return n

        def on_write(user, machine, fd, buf, length):
            return length  # journal/stdout sinks

        self._read_cb = native.HOST_READ_FN(on_read)
        self._write_cb = native.HOST_WRITE_FN(on_write)
        self.h = self.lib.r0_debug_create(
            user_elf, len(user_elf), kernel_elf, len(kernel_elf),
            None, self._read_cb, self._write_cb)
        if not self.h:
            raise RuntimeError(self.lib.r0_last_error().decode())

    @staticmethod
    def _configure(l):
        if getattr(l, "_debug_configured", False):
            return
        u32p = C.POINTER(C.c_uint32)
        l.r0_debug_create.restype = C.c_void_p
        l.r0_debug_create.argtypes = [
            C.c_char_p, C.c_uint64, C.c_char_p, C.c_uint64,
            C.c_void_p, native.HOST_READ_FN, native.HOST_WRITE_FN]
        l.r0_debug_step.restype = C.c_int
        l.r0_debug_step.argtypes = [C.c_void_p, C.c_uint64, u32p,
                                    C.c_uint32, u32p]
        for name in ("r0_debug_pc", "r0_debug_mode", "r0_debug_exit_code"):
            fn = getattr(l, name)
            fn.restype = C.c_uint32
            fn.argtypes = [C.c_void_p]
        l.r0_debug_halted.restype = C.c_int
        l.r0_debug_halted.argtypes = [C.c_void_p]
        l.r0_debug_read_regs.restype = None
        l.r0_debug_read_regs.argtypes = [C.c_void_p, u32p]
        l.r0_debug_read_mem.restype = None
        l.r0_debug_read_mem.argtypes = [C.c_void_p, C.c_uint32, C.c_uint32,
                                        C.POINTER(C.c_uint8)]
        l.r0_debug_free.restype = None
        l.r0_debug_free.argtypes = [C.c_void_p]
        l._debug_configured = True

    def step(self, max_steps: int, breakpoints=()) -> tuple[int, int]:
        """Returns (status, stop_pc): 0 budget, 1 halted, 2 breakpoint."""
        n = len(breakpoints)
        bps = (C.c_uint32 * max(n, 1))(*breakpoints)
        stop = C.c_uint32(0)
        rc = self.lib.r0_debug_step(self.h, max_steps, bps, n,
                                    C.byref(stop))
        if rc == 3:
            raise RuntimeError(self.lib.r0_last_error().decode())
        return rc, int(stop.value)

    def pc(self) -> int:
        return int(self.lib.r0_debug_pc(self.h))

    def halted(self) -> bool:
        return bool(self.lib.r0_debug_halted(self.h))

    def exit_code(self) -> int:
        return int(self.lib.r0_debug_exit_code(self.h)) >> 16

    def regs(self) -> np.ndarray:
        out = (C.c_uint32 * 32)()
        self.lib.r0_debug_read_regs(self.h, out)
        return np.array(out, np.uint32)

    def read_mem(self, addr: int, length: int) -> bytes:
        out = (C.c_uint8 * max(length, 1))()
        self.lib.r0_debug_read_mem(self.h, addr, length, out)
        return bytes(out[:length])

    def close(self):
        if self.h:
            self.lib.r0_debug_free(self.h)
            self.h = None


def _checksum(payload: bytes) -> int:
    return sum(payload) % 256


class GdbStub:
    """RSP server for one debug machine."""

    CONTINUE_BUDGET = 1 << 28  # instructions per continue before re-poll

    def __init__(self, user_elf: bytes, input: bytes = b"",
                 kernel_elf: bytes | None = None):
        self.machine = DebugMachine(user_elf, input, kernel_elf)
        self.breakpoints: set[int] = set()
        self._listener = None
        self._conn = None

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._listener = socket.socket()
        self._listener.bind((host, port))
        self._listener.listen(1)
        return self._listener.getsockname()[1]

    def serve_forever(self) -> None:
        self._conn, _ = self._listener.accept()
        buf = b""
        try:
            while True:
                data = self._conn.recv(4096)
                if not data:
                    return
                buf += data
                while True:
                    pkt, buf = self._extract_packet(buf)
                    if pkt is None:
                        break
                    self._conn.sendall(b"+")
                    reply = self.handle(pkt.decode())
                    if reply is None:  # kill/detach
                        return
                    self._send(reply)
        finally:
            self._conn.close()
            self.machine.close()

    @staticmethod
    def _extract_packet(buf: bytes):
        start = buf.find(b"$")
        if start < 0:
            return None, b"" if buf in (b"+", b"-") else buf
        end = buf.find(b"#", start)
        if end < 0 or len(buf) < end + 3:
            return None, buf
        return buf[start + 1 : end], buf[end + 3 :]

    def _send(self, payload: str) -> None:
        raw = payload.encode()
        self._conn.sendall(b"$" + raw + b"#" + b"%02x" % _checksum(raw))

    # -- packet handlers ------------------------------------------------------

    def handle(self, pkt: str) -> str | None:
        m = self.machine
        if pkt.startswith("qSupported"):
            return "PacketSize=4096;swbreak+"
        if pkt == "?":
            return "S05"
        if pkt == "g":
            regs = list(m.regs()) + [m.pc()]
            return "".join(int(r).to_bytes(4, "little").hex() for r in regs)
        if pkt.startswith("p"):
            n = int(pkt[1:], 16)
            val = m.pc() if n == 32 else int(m.regs()[n])
            return val.to_bytes(4, "little").hex()
        if pkt.startswith("m"):
            addr, length = (int(x, 16) for x in pkt[1:].split(","))
            try:
                return m.read_mem(addr, length).hex()
            except Exception:
                return "E01"
        if pkt.startswith("Z0") or pkt.startswith("z0"):
            addr = int(pkt.split(",")[1], 16)
            if pkt[0] == "Z":
                self.breakpoints.add(addr)
            else:
                self.breakpoints.discard(addr)
            return "OK"
        if pkt == "s":
            status, _ = m.step(1)
            return self._stop_reply(status)
        if pkt == "c":
            status, _ = m.step(self.CONTINUE_BUDGET,
                               sorted(self.breakpoints))
            return self._stop_reply(status)
        if pkt in ("k", "D"):
            return None
        if pkt.startswith("qAttached"):
            return "1"
        if pkt.startswith("H") or pkt.startswith("qC"):
            return "OK" if pkt.startswith("H") else ""
        return ""  # unsupported -> empty per RSP

    def _stop_reply(self, status: int) -> str:
        if status == 1 or self.machine.halted():
            return f"W{self.machine.exit_code():02x}"
        if status == 2:
            return "T05swbreak:;"
        return "S05"
