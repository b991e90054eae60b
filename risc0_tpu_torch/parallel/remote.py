# The port's own copy of risc0_tpu/parallel/remote.py.
"""Remote workers over TCP — the cross-host leg of the proving scheduler.

Mirrors the reference's remote factory (r0vm/src/actors/factory.rs:258-355):
a factory host listens for worker connections; remote workers pull tasks by
kind over the socket (GetTask), execute locally, and push TaskDone back.
Payloads are pickled (segments are MB-scale, receipts ~100-300KB).

Protocol frames: 4-byte little-endian length + pickle.

SECURITY / trust boundary: frames are deserialized with pickle, which
executes arbitrary code on load.  The factory and its workers must therefore
only be exposed on loopback or on a fully-trusted private network (the same
trust model as the reference's serde-over-TCP kameo actors).  Never bind the
FactoryServer to an address reachable by untrusted peers.
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading

from .scheduler import Factory, Task, TaskDone, TaskKind


def _send(sock: socket.socket, obj):
    data = pickle.dumps(obj)
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    data = b""
    while len(data) < n:
        chunk = sock.recv(min(1 << 20, n - len(data)))
        if not chunk:
            return None
        data += chunk
    return pickle.loads(data)


class FactoryServer:
    """Exposes a Factory to remote workers (reference RemoteFactoryActor)."""

    def __init__(self, factory: Factory, host="127.0.0.1", port=0):
        self.factory = factory
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    msg = _recv(sock)
                    if msg is None:
                        return
                    if msg["type"] == "get_task":
                        kinds = [TaskKind(k) for k in msg["kinds"]]
                        task = outer.factory.get_task(kinds, timeout=0.25)
                        if task is None:
                            _send(sock, {"type": "no_task"})
                        else:
                            _send(sock, {"type": "task", "task": task})
                    elif msg["type"] == "task_done":
                        outer.factory.task_done(msg["done"])
                        _send(sock, {"type": "ok"})

        self.server = socketserver.ThreadingTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.addr = self.server.server_address
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()


class RemoteWorker:
    """Worker process/thread that pulls tasks from a remote factory
    (reference actors/worker.rs pull loop over TCP)."""

    def __init__(self, addr, kinds, processor, name="remote-worker"):
        self.addr = addr
        self.kinds = kinds
        self.processor = processor
        self.name = name
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self):
        sock = socket.create_connection(self.addr)
        try:
            while not self._stop.is_set():
                _send(sock, {"type": "get_task",
                             "kinds": [k.value for k in self.kinds]})
                msg = _recv(sock)
                if msg is None:
                    return
                if msg["type"] != "task":
                    continue
                task: Task = msg["task"]
                try:
                    result = self.processor(task)
                    done = TaskDone(task, result=result)
                except Exception as e:
                    done = TaskDone(task, error=e)
                _send(sock, {"type": "task_done", "done": done})
                _recv(sock)  # ack
        finally:
            sock.close()
