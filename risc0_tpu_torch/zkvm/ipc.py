# The port's own copy of risc0_tpu/zkvm/ipc.py.
"""Protobuf-over-TCP prover IPC (the reference's primary host API).

Mirrors risc0/zkvm/src/host/api/{mod,server,client}.rs + protos/api.proto:

  * frames are [u32-LE length][protobuf bytes] (api/mod.rs:129-148);
  * the CLIENT binds a listener and spawns the server process, which
    connects back (api/client.rs:54-90; `r0vm --port <p>`);
  * every request is a `ServerRequest` oneof (execute=1, prove=2,
    prove_segment=3, lift=4, join=5, identity_p254=6, resolve=7,
    compress=8, verify=9, union=12 — api.proto field numbers kept);
  * large payloads ride `Asset`s: inline bytes (1) or a filesystem path
    (2) — the asset channel (api.proto:259-273);
  * the server answers with reply messages whose oneof is {ok=1,
    error=2(GenericError{reason=1})}; execute streams `segment_done`
    callbacks before `session_done` (api.proto ClientCallback).

Segments/receipts travel as pickled framework objects inside Assets
(the reference uses its own bincode/borsh there).  Trust boundary: like
reference r0vm, this protocol is for LOOPBACK use between a host and a
prover subprocess it spawned — never expose the port to untrusted peers.

The server proves on `device`, the card unless the caller names another
(`python -m risc0_tpu_torch.cli port --device cpu`).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading

import numpy as np

from ..convert import card
from . import proto

# ---------------------------------------------------------------------------
# framing


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes | None:
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    return _read_exact(sock, n)


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# assets (api.proto Asset / AssetRequest)


def asset_encode(obj) -> bytes:
    """Inline asset holding a pickled framework object."""
    return proto.bytes_field(1, pickle.dumps(obj))


def asset_path(path: str) -> bytes:
    return proto.string(2, path)


def asset_decode(buf: bytes):
    d = proto.to_dict(buf)
    if 1 in d:
        return pickle.loads(d[1])
    if 2 in d:
        with open(d[2].decode(), "rb") as f:
            return pickle.loads(f.read())
    raise ValueError("unsupported asset kind")


def _digest_msg(d) -> bytes:
    return proto.packed(1, [int(w) for w in np.asarray(d, np.uint32)])


def _digest_from(buf: bytes) -> np.ndarray:
    d = proto.to_dict(buf)
    return np.array(proto.unpack_varints(d.get(1, b"")), np.uint32)


# ---------------------------------------------------------------------------
# requests (ServerRequest oneof, api.proto field numbers)

EXECUTE, PROVE, PROVE_SEGMENT, LIFT, JOIN, IDENTITY_P254, RESOLVE, \
    COMPRESS, VERIFY, PROVE_KECCAK, UNION = 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12


def _opts_msg(opts) -> bytes:
    kind = {"composite": 0, "succinct": 1, "groth16": 2}[opts.receipt_kind]
    return (proto.string(1, opts.hashfn) + proto.uint(3, kind) +
            proto.uint(6, 1 if opts.dev_mode else 0))


def _opts_from(buf: bytes):
    from .prover import ProverOpts

    d = proto.to_dict(buf)
    kinds = {0: "composite", 1: "succinct", 2: "groth16"}
    return ProverOpts(hashfn=d.get(1, b"poseidon2").decode(),
                      receipt_kind=kinds[d.get(3, 0)],
                      dev_mode=bool(d.get(6, 0)))


def _env_msg(env, elf: bytes) -> bytes:
    """api.proto ExecutorEnv: binary asset=1, segment_limit_po2=6,
    session_limit=7, keccak_max_po2=14; input rides a write_fd... our
    ExecutorEnv carries input bytes directly, shipped as field 16."""
    msg = proto.bytes_field(1, asset_encode(elf))
    msg += proto.uint(6, env.segment_po2)
    msg += proto.uint(7, env.session_limit or 0)
    msg += proto.uint(14, env.keccak_max_po2)
    msg += proto.bytes_field(16, env.input)
    return msg


def _env_from(buf: bytes):
    from .exec import ExecutorEnv

    d = proto.to_dict(buf)
    elf = asset_decode(d[1])
    env = ExecutorEnv(segment_po2=d.get(6, 20),
                      session_limit=d.get(7, 0) or None)
    if 14 in d:
        env.keccak_max_po2 = d[14]
    env.input = bytes(d.get(16, b""))
    return env, elf


# ---------------------------------------------------------------------------
# server


class ApiServer:
    """Serves ServerRequests over one connection until EOF (reference
    api/server.rs:217-530).  Without a `prover`, each request's options
    choose one (get_prover_server) on `device`, which must exist."""

    def __init__(self, prover=None, device="cuda"):
        self._prover = prover
        self.device = device if prover is not None else card(device)

    def _get_prover(self, opts):
        if self._prover is not None:
            return self._prover
        from .prover import get_prover_server

        return get_prover_server(opts, self.device)

    def run_connected(self, sock: socket.socket) -> None:
        while True:
            frame = recv_frame(sock)
            if frame is None:
                return
            try:
                for reply in self._dispatch(frame):
                    send_frame(sock, reply)
            except Exception as e:  # GenericError reply (error=2)
                err = proto.bytes_field(2, proto.string(1, str(e)))
                send_frame(sock, err)

    def connect(self, host: str, port: int) -> None:
        sock = socket.create_connection((host, port))
        try:
            self.run_connected(sock)
        finally:
            sock.close()

    def _dispatch(self, frame: bytes):
        d = proto.to_dict(frame)
        kind = next(iter(d))
        body = proto.to_dict(d[kind])
        if kind == EXECUTE:
            env, elf = _env_from(body[1])
            from .exec import ExecutorImpl

            session = ExecutorImpl(env, elf).run()
            for seg in session.segments:
                seg_info = (proto.uint(1, seg.index) + proto.uint(2, seg.po2)
                            + proto.uint(3, seg.user_cycles)
                            + proto.bytes_field(4, asset_encode(seg)))
                # ClientCallback segment_done (ok=1 / kind=2)
                yield proto.bytes_field(1, proto.bytes_field(2, seg_info))
            yield proto.bytes_field(1, proto.bytes_field(
                3, self._session_info(session)))
        elif kind == PROVE:
            env, elf = _env_from(body[1])
            opts = _opts_from(body.get(2, b""))
            info = self._get_prover(opts).prove(env, elf)
            yield proto.bytes_field(1, proto.bytes_field(
                4, proto.bytes_field(1, asset_encode(info.receipt))))
        elif kind == PROVE_SEGMENT:
            opts = _opts_from(body.get(1, b""))
            seg, claim = asset_decode(body[2])
            receipt = self._get_prover(opts).prove_segment(seg, claim)
            yield proto.bytes_field(1, asset_encode(receipt))
        elif kind in (LIFT, IDENTITY_P254, COMPRESS):
            opts = _opts_from(body.get(1, b""))
            receipt = asset_decode(body[2])
            prover = self._get_prover(opts)
            fn = {LIFT: prover.lift,
                  IDENTITY_P254: getattr(prover, "identity_p254", None),
                  COMPRESS: getattr(prover, "compress", None)}[kind]
            if fn is None:
                raise RuntimeError("operation unsupported by this prover")
            yield proto.bytes_field(1, asset_encode(fn(receipt)))
        elif kind in (JOIN, UNION):
            opts = _opts_from(body.get(1, b""))
            a = asset_decode(body[2])
            b = asset_decode(body[3])
            prover = self._get_prover(opts)
            fn = prover.join if kind == JOIN else prover.union
            yield proto.bytes_field(1, asset_encode(fn(a, b)))
        elif kind == RESOLVE:
            opts = _opts_from(body.get(1, b""))
            conditional = asset_decode(body[2])
            assumption = asset_decode(body[3])
            receipt = self._get_prover(opts).resolve(conditional, assumption)
            yield proto.bytes_field(1, asset_encode(receipt))
        elif kind == PROVE_KECCAK:
            # api.proto ProveKeccakRequest: claim_digest=1, po2=2,
            # control_root=3, input(asset)=4
            request = {
                "claim_digest": _digest_from(body[1]).tobytes(),
                "po2": body.get(2, 17),
                "control_root": _digest_from(body.get(3, b"")).tobytes(),
                "input": asset_decode(body[4]) if 4 in body else [],
            }
            opts = _opts_from(body.get(5, b""))
            receipt = self._get_prover(opts).prove_keccak(request)
            yield proto.bytes_field(1, asset_encode(receipt))
        elif kind == VERIFY:
            receipt = asset_decode(body[1])
            image_id = _digest_from(body[2])
            receipt.verify(image_id)
            yield proto.bytes_field(1, b"")
        else:
            raise ValueError(f"unknown request kind {kind}")

    @staticmethod
    def _session_info(session) -> bytes:
        kind, *rest = session.exit_code
        code_field = {"Halted": 1, "Paused": 2, "SystemSplit": 3,
                      "SessionLimit": 4}[kind]
        exit_msg = (proto.tag(code_field, 0) +
                    proto.varint(rest[0] if rest else 0))
        return (proto.uint(1, len(session.segments)) +
                proto.bytes_field(2, session.journal) +
                proto.bytes_field(3, exit_msg) +
                proto.bytes_field(4, asset_encode(session)))


# ---------------------------------------------------------------------------
# client


class ApiClient:
    """Binds a listener, launches (or accepts) a prover server proving on
    `device`, then issues typed requests (reference api/client.rs)."""

    def __init__(self, spawn: bool = True, prover=None,
                 subprocess_server: bool = False, device="cuda"):
        server = None
        if spawn and not subprocess_server:
            server = ApiServer(prover, device)  # raises without the device
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(1)
        self.port = self._listener.getsockname()[1]
        self._server_thread = None
        self._server_proc = None
        if subprocess_server:  # true `r0vm --port` style child process
            import os
            import subprocess
            import sys

            self._server_proc = subprocess.Popen(
                [sys.executable, "-m", "risc0_tpu_torch.cli", "port",
                 "--port", str(self.port), "--device", str(device)],
                cwd=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))))
        elif server is not None:  # in-process server thread
            self._server_thread = threading.Thread(
                target=server.connect, args=("127.0.0.1", self.port),
                daemon=True)
            self._server_thread.start()
        self.sock = self._accept()

    def _accept(self) -> socket.socket:
        """The server's connection; a child server that exits before it
        connects raises instead of leaving the client waiting."""
        if self._server_proc is None:
            return self._listener.accept()[0]
        self._listener.settimeout(0.5)
        while True:
            try:
                sock = self._listener.accept()[0]
            except socket.timeout:
                rc = self._server_proc.poll()
                if rc is not None:
                    self._listener.close()
                    raise RuntimeError(
                        f"prover server exited ({rc}) before connecting")
                continue
            sock.settimeout(None)
            return sock

    def close(self):
        self.sock.close()
        self._listener.close()
        if self._server_proc is not None:
            self._server_proc.terminate()
            self._server_proc.wait(timeout=10)

    def _request(self, kind: int, body: bytes) -> dict:
        send_frame(self.sock, proto.bytes_field(kind, body))
        frame = recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed connection")
        d = proto.to_dict(frame)
        if 2 in d and 1 not in d:
            reason = proto.to_dict(d[2]).get(1, b"unknown").decode()
            raise RuntimeError(f"server error: {reason}")
        return d

    def execute(self, env, elf: bytes):
        """Returns (session, [segments]) streamed via callbacks."""
        body = proto.bytes_field(1, _env_msg(env, elf))
        send_frame(self.sock, proto.bytes_field(EXECUTE, body))
        segments = []
        while True:
            frame = recv_frame(self.sock)
            if frame is None:
                raise ConnectionError("server closed connection")
            d = proto.to_dict(frame)
            if 2 in d and 1 not in d:
                reason = proto.to_dict(d[2]).get(1, b"unknown").decode()
                raise RuntimeError(f"server error: {reason}")
            cb = proto.to_dict(d[1])
            if 2 in cb:  # segment_done
                seg_info = proto.to_dict(cb[2])
                segments.append(asset_decode(seg_info[4]))
            elif 3 in cb:  # session_done
                info = proto.to_dict(cb[3])
                return asset_decode(info[4]), segments
            else:
                raise ValueError("unexpected callback")

    def prove(self, env, elf: bytes, opts=None):
        from .prover import ProverOpts

        opts = opts or ProverOpts()
        body = (proto.bytes_field(1, _env_msg(env, elf)) +
                proto.bytes_field(2, _opts_msg(opts)))
        d = self._request(PROVE, body)
        done = proto.to_dict(proto.to_dict(d[1])[4])
        return asset_decode(done[1])

    def _unary(self, kind: int, opts, *assets) -> object:
        from .prover import ProverOpts

        body = proto.bytes_field(1, _opts_msg(opts or ProverOpts()))
        for i, a in enumerate(assets):
            body += proto.bytes_field(2 + i, asset_encode(a))
        d = self._request(kind, body)
        return asset_decode(d[1])

    def prove_segment(self, seg, claim, opts=None):
        return self._unary(PROVE_SEGMENT, opts, (seg, claim))

    def lift(self, receipt, opts=None):
        return self._unary(LIFT, opts, receipt)

    def join(self, a, b, opts=None):
        return self._unary(JOIN, opts, a, b)

    def union(self, a, b, opts=None):
        return self._unary(UNION, opts, a, b)

    def resolve(self, conditional, assumption, opts=None):
        return self._unary(RESOLVE, opts, conditional, assumption)

    def compress(self, receipt, opts=None):
        return self._unary(COMPRESS, opts, receipt)

    def prove_keccak(self, claim_digest, po2: int, control_root,
                     input_data, opts=None):
        from .prover import ProverOpts

        body = (proto.bytes_field(1, _digest_msg(claim_digest)) +
                proto.uint(2, po2) +
                proto.bytes_field(3, _digest_msg(control_root)) +
                proto.bytes_field(4, asset_encode(input_data)) +
                proto.bytes_field(5, _opts_msg(opts or ProverOpts())))
        d = self._request(PROVE_KECCAK, body)
        return asset_decode(d[1])

    def verify(self, receipt, image_id) -> None:
        body = (proto.bytes_field(1, asset_encode(receipt)) +
                proto.bytes_field(2, _digest_msg(image_id)))
        self._request(VERIFY, body)
