# The port's own copy of risc0_tpu/zkvm/bonsai.py.
"""Bonsai SDK client (reference bonsai/sdk/src/lib.rs blocking Client).

Speaks the same REST shapes as the reference SDK against this framework's
proving service (zkvm/api_server.py): presigned-style uploads with
image-id dedup, session create/status/logs/stop, receipt download,
exec-only journal, version and quota probes.  SNARK endpoints surface the
server's reply (the groth16 wrap is produced via identity_p254 +
an external SNARK prover; see groth16/).

    client = Client.from_parts("http://127.0.0.1:8081", api_key="")
    client.upload_img(image_id, elf_bytes)
    input_id = client.upload_input(input_bytes)
    session = client.create_session(image_id, input_id)
    while (res := session.status(client))["status"] == "RUNNING":
        time.sleep(0.2)
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from dataclasses import dataclass


class SdkErr(Exception):
    pass


@dataclass
class SessionId:
    """reference lib.rs:389-462."""

    uuid: str

    def status(self, client: "Client") -> dict:
        return client._get_json(f"/sessions/status/{self.uuid}")

    def logs(self, client: "Client") -> str:
        return client._get_bytes(f"/sessions/logs/{self.uuid}").decode()

    def stop(self, client: "Client") -> None:
        client._post_json(f"/sessions/stop/{self.uuid}", {})

    def exec_only_journal(self, client: "Client") -> bytes:
        return client._get_bytes(f"/sessions/exec_only_journal/{self.uuid}")


@dataclass
class SnarkId:
    """reference lib.rs:464-518."""

    uuid: str

    def status(self, client: "Client") -> dict:
        return client._get_json(f"/snark/status/{self.uuid}")


class Client:
    """reference lib.rs:520-950."""

    def __init__(self, url: str, api_key: str = "", version: str = "2.0"):
        self.url = url.rstrip("/")
        self.api_key = api_key
        self.version = version

    @staticmethod
    def from_parts(url: str, api_key: str = "",
                   risc0_version: str = "2.0") -> "Client":
        return Client(url, api_key, risc0_version)

    @staticmethod
    def from_env(risc0_version: str = "2.0") -> "Client":
        url = os.environ.get("BONSAI_API_URL")
        key = os.environ.get("BONSAI_API_KEY", "")
        if not url:
            raise SdkErr("missing BONSAI_API_URL env var")
        return Client(url, key, risc0_version)

    # -- http ----------------------------------------------------------------

    def _req(self, path: str, method="GET", data=None) -> bytes:
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"x-api-key": self.api_key,
                     "x-risc0-version": self.version})
        try:
            with urllib.request.urlopen(req) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise SdkErr(f"{method} {path}: HTTP {e.code} "
                         f"{e.read().decode(errors='replace')}") from e

    def _get_json(self, path: str) -> dict:
        return json.loads(self._req(path))

    def _get_bytes(self, path: str) -> bytes:
        return self._req(path)

    def _post_json(self, path: str, obj: dict) -> dict:
        return json.loads(self._req(path, "POST", json.dumps(obj).encode()))

    def _put(self, path: str, data: bytes) -> None:
        self._req(path, "PUT", data)

    # -- assets ----------------------------------------------------------------

    def upload_img(self, image_id: str, elf: bytes) -> bool:
        """Returns True if the image already existed (reference
        image_upload_dup: 204 dedup)."""
        res = self._get_json(f"/images/upload/{image_id}")
        if res.get("exists"):
            return True
        self._put(res["url"], elf)
        return False

    def upload_input(self, data: bytes) -> str:
        res = self._get_json("/inputs/upload")
        self._put(res["url"], data)
        return res["uuid"]

    def upload_receipt(self, receipt: bytes) -> str:
        res = self._get_json("/receipts/upload")
        self._put(res["url"], receipt)
        return res["uuid"]

    def download(self, url: str) -> bytes:
        return self._get_bytes(url)

    # -- sessions --------------------------------------------------------------

    def create_session(self, img_id: str, input_id: str,
                       assumptions: list | None = None,
                       execute_only: bool = False) -> SessionId:
        res = self._post_json("/sessions/create", {
            "img": img_id, "input": input_id,
            "assumptions": assumptions or [],
            "execute_only": execute_only})
        return SessionId(res["uuid"])

    # -- snark -----------------------------------------------------------------

    def create_snark(self, session_id: str) -> SnarkId:
        res = self._post_json("/snark/create", {"session_id": session_id})
        return SnarkId(res["uuid"])

    # -- service ---------------------------------------------------------------

    def get_version(self) -> dict:
        return self._get_json("/version")

    def quotas(self) -> dict:
        return self._get_json("/user/quotas")
