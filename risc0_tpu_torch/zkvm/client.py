# The port's own copy of risc0_tpu/zkvm/client.py.
"""Prover/Executor client abstraction (reference risc0/zkvm/src/host/client/
prove/{mod,default,local,external}.rs).

`default_prover()` selects the backend from the RISC0_PROVER env var:
  * "local"  — in-process ProverServer (ProverImpl on the card, or the
               DevModeProver under RISC0_DEV_MODE)
  * "ipc"    — protobuf-over-TCP prover server (zkvm/ipc.py, the
               reference's `r0vm` external prover protocol)
  * "bonsai" — REST API with Bonsai-compatible routes (RISC0_API_URL)
Anything else errors, mirroring the reference's named-prover dispatch.
The local and IPC provers prove on `device`, the card unless the caller
names another.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
import uuid

from .exec import ExecutorEnv, ExecutorImpl, Session
from .prover import ProveInfo, ProverOpts, get_prover_server


class LocalProver:
    """reference host/client/prove/local.rs"""

    def __init__(self, opts: ProverOpts | None = None, device="cuda"):
        self.device = device
        self.server = get_prover_server(opts, device)

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        return self.server.prove(env, elf)

    def prove_with_opts(self, env, elf, opts: ProverOpts) -> ProveInfo:
        return get_prover_server(opts, self.device).prove(env, elf)


class ExternalProver:
    """REST-backed prover (the `ipc`/external flavor; reference
    host/client/prove/external.rs proxies to an r0vm subprocess — here we
    proxy to the API service)."""

    def __init__(self, base_url: str | None = None):
        self.base_url = base_url or os.environ.get(
            "RISC0_API_URL", "http://127.0.0.1:8000")

    def _req(self, path, method="GET", data=None):
        req = urllib.request.Request(self.base_url + path, data=data,
                                     method=method)
        with urllib.request.urlopen(req) as r:
            body = r.read()
        try:
            return json.loads(body)
        except ValueError:
            return body

    def prove(self, env: ExecutorEnv, elf: bytes) -> dict:
        image_id = str(uuid.uuid4())
        self._req(f"/images/upload/{image_id}", "PUT", elf)
        up = self._req("/inputs/upload")
        self._req(up["url"], "PUT", env.input)
        res = self._req("/sessions/create", "POST", json.dumps({
            "img": image_id, "input": up["uuid"]}).encode())
        job = res["uuid"]
        while True:
            st = self._req(f"/sessions/status/{job}")
            if st["status"] != "RUNNING":
                break
            time.sleep(0.2)
        if st["status"] != "SUCCEEDED":
            raise RuntimeError(st.get("error_msg", "proving failed"))
        st["receipt"] = self._req(st["receipt_url"])
        return st


class IpcProver:
    """Protobuf-socket prover (reference host/client/prove/external.rs:
    the client spawns an r0vm server and talks api.proto over TCP)."""

    def __init__(self, opts: ProverOpts | None = None, device="cuda"):
        self.opts = opts or ProverOpts()
        self.device = device
        self._client = None

    def _get(self):
        if self._client is None:
            from .ipc import ApiClient

            self._client = ApiClient(spawn=True, device=self.device)
        return self._client

    def prove(self, env: ExecutorEnv, elf: bytes):
        receipt = self._get().prove(env, elf, self.opts)
        return ProveInfo(receipt=receipt, session=None)

    def close(self):
        if self._client is not None:
            self._client.close()
            self._client = None


class LocalExecutor:
    def execute(self, env: ExecutorEnv, elf: bytes) -> Session:
        return ExecutorImpl(env, elf).run()


def default_prover(device="cuda"):
    """reference host/client/prove/mod.rs default_prover + RISC0_PROVER."""
    name = os.environ.get("RISC0_PROVER", "local")
    if name == "local":
        return LocalProver(device=device)
    if name == "ipc":
        return IpcProver(device=device)
    if name == "bonsai":
        return ExternalProver()
    raise ValueError(f"Unknown prover specified: {name}")


def default_executor():
    return LocalExecutor()
