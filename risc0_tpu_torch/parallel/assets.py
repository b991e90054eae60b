# The port's own copy of risc0_tpu/parallel/assets.py.
"""Content-addressed asset store — multi-host segment/receipt shipping.

The reference ships proving inputs between actors either inline or through
a shared store keyed by digest (r0vm asset channel; Bonsai's upload/dedup
routes).  Here a factory host runs an `AssetServer`; jobs `put` MB-scale
payloads (serialized segments) once and submit lightweight `AssetRef`s in
task payloads.  Workers resolve refs through a local cache, fetching over
TCP only when the bytes aren't already on their host, so a payload
crosses the network at most once per host.

Wire protocol (no pickle — raw, length-prefixed frames):
    request : op(1) | digest(32) | len(u64 LE) | payload
    response: status(1) | len(u64 LE) | payload
ops: 0x01 GET, 0x02 PUT, 0x03 HAS; status: 0x00 ok, 0x01 missing.
Payload integrity is verified against the digest on both put and fetch.
"""

from __future__ import annotations

import hashlib
import os
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass

_GET, _PUT, _HAS = 1, 2, 3
_OK, _MISSING = 0, 1


def digest_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class AssetStore:
    """Digest-keyed blob store; memory-backed with an optional disk spill
    directory (survives process restarts, shared by same-host workers)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._mem: dict[str, bytes] = {}
        self._lock = threading.Lock()
        if path:
            os.makedirs(path, exist_ok=True)

    def _file(self, digest: str) -> str:
        return os.path.join(self.path, digest)

    def put(self, data: bytes) -> str:
        digest = digest_of(data)
        with self._lock:
            if self.path:
                f = self._file(digest)
                if not os.path.exists(f):
                    tmp = f + f".tmp{os.getpid()}"
                    with open(tmp, "wb") as fh:
                        fh.write(data)
                    os.replace(tmp, f)
            else:
                self._mem[digest] = data
        return digest

    def get(self, digest: str) -> bytes | None:
        with self._lock:
            if digest in self._mem:
                return self._mem[digest]
        if self.path and os.path.exists(self._file(digest)):
            with open(self._file(digest), "rb") as fh:
                data = fh.read()
            if digest_of(data) != digest:  # torn/corrupt spill
                return None
            return data
        return None

    def has(self, digest: str) -> bool:
        if self.path:
            return os.path.exists(self._file(digest))
        with self._lock:
            return digest in self._mem


def _read_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return buf


class AssetServer:
    """Serves an AssetStore over TCP (loopback / trusted-network only, the
    same trust model as the factory socket)."""

    def __init__(self, store: AssetStore, host="127.0.0.1", port=0):
        self.store = store
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    hdr = _read_exact(sock, 1 + 32 + 8)
                    if hdr is None:
                        return
                    op = hdr[0]
                    digest = hdr[1:33].hex()
                    (n,) = struct.unpack("<Q", hdr[33:41])
                    payload = _read_exact(sock, n) if n else b""
                    if payload is None:
                        return
                    if op == _PUT:
                        if digest_of(payload) != digest:
                            sock.sendall(bytes([_MISSING]) + struct.pack(
                                "<Q", 0))
                            continue
                        outer.store.put(payload)
                        sock.sendall(bytes([_OK]) + struct.pack("<Q", 0))
                    elif op == _GET:
                        data = outer.store.get(digest)
                        if data is None:
                            sock.sendall(bytes([_MISSING]) + struct.pack(
                                "<Q", 0))
                        else:
                            sock.sendall(bytes([_OK]) + struct.pack(
                                "<Q", len(data)) + data)
                    elif op == _HAS:
                        ok = outer.store.has(digest)
                        sock.sendall(bytes([_OK if ok else _MISSING])
                                     + struct.pack("<Q", 0))
                    else:
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.addr = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="asset-server")
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class AssetClient:
    """Single-connection client; thread-safe via a lock."""

    def __init__(self, addr):
        self.addr = tuple(addr)
        self._sock = None
        self._lock = threading.Lock()

    def _conn(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=30)
        return self._sock

    def _request(self, op: int, digest: str, payload: bytes = b""):
        with self._lock:
            sock = self._conn()
            try:
                sock.sendall(bytes([op]) + bytes.fromhex(digest)
                             + struct.pack("<Q", len(payload)) + payload)
                hdr = _read_exact(sock, 1 + 8)
            except OSError:
                self._sock = None
                raise
            if hdr is None:
                self._sock = None
                raise ConnectionError("asset server closed the connection")
            status = hdr[0]
            (n,) = struct.unpack("<Q", hdr[1:9])
            data = _read_exact(sock, n) if n else b""
            return status, data

    def put(self, data: bytes) -> str:
        digest = digest_of(data)
        status, _ = self._request(_PUT, digest, data)
        if status != _OK:
            raise IOError("asset put rejected (digest mismatch?)")
        return digest

    def get(self, digest: str) -> bytes:
        status, data = self._request(_GET, digest)
        if status != _OK:
            raise KeyError(f"asset {digest[:16]}… not on server")
        if digest_of(data) != digest:
            raise IOError("asset payload failed integrity check")
        return data

    def has(self, digest: str) -> bool:
        status, _ = self._request(_HAS, digest)
        return status == _OK

    def close(self):
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


# process-local resolve cache: same-host workers fetch a shipped asset once
_local = AssetStore()


@dataclass(frozen=True)
class AssetRef:
    """Lightweight handle shipped in task payloads instead of MB-scale
    bytes: (sha256 digest, size, asset-server address)."""

    digest: str
    size: int
    addr: tuple

    @staticmethod
    def store(data: bytes, server_addr, client: AssetClient | None = None):
        """Upload once, return the ref (uses/returns a pooled client)."""
        client = client or AssetClient(server_addr)
        digest = client.put(data)
        _local.put(data)  # origin host resolves from cache, no round-trip
        return AssetRef(digest=digest, size=len(data),
                        addr=tuple(server_addr)), client

    def resolve(self) -> bytes:
        """Local cache first; TCP fetch (+cache) only on a remote host."""
        data = _local.get(self.digest)
        if data is not None:
            return data
        client = AssetClient(self.addr)
        try:
            data = client.get(self.digest)
        finally:
            client.close()
        _local.put(data)
        return data


@dataclass(frozen=True)
class SegmentAssetRef:
    """Segment shipped by reference: pickled SegmentInfo behind an AssetRef
    plus the scheduling metadata the DAG reads without resolving.  Drops
    into any path using zkvm.exec.resolve_segment (same duck type as
    FileSegmentRef).  Pickle caveat: resolve only assets from the same
    trusted network as the factory (see module docstring in remote.py)."""

    ref: AssetRef
    index: int
    po2: int
    user_cycles: int

    @staticmethod
    def store(segment, server_addr, client: AssetClient | None = None):
        import pickle

        data = pickle.dumps(segment)
        ref, client = AssetRef.store(data, server_addr, client)
        return SegmentAssetRef(ref=ref, index=segment.index,
                               po2=segment.po2,
                               user_cycles=segment.user_cycles), client

    def resolve(self):
        import pickle

        return pickle.loads(self.ref.resolve())
