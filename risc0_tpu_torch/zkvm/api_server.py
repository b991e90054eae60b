# The port's own copy of risc0_tpu/zkvm/api_server.py.
"""Self-hosted proving REST API (reference: risc0/r0vm/src/api.rs:58-670).

Bonsai-compatible route shape: upload images/inputs, create STARK sessions,
poll status, download receipts; x-api-key scoping.  Each job runs on a
background thread through the service's prover: by default the one
get_prover_server chooses (ProverImpl on `device`, the card unless the
caller names another, or the DevModeProver under RISC0_DEV_MODE).

Run: python -m risc0_tpu_torch.zkvm.api_server [--port 8000]
     [--storage DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


DEFAULT_STORAGE = os.path.join(tempfile.gettempdir(), "risc0_tpu_torch_api")


class AppState:
    def __init__(self, storage: Path, prover):
        self.storage = storage
        self.prover = prover
        (storage / "images").mkdir(parents=True, exist_ok=True)
        (storage / "inputs").mkdir(parents=True, exist_ok=True)
        (storage / "receipts").mkdir(parents=True, exist_ok=True)
        self.jobs: dict[str, dict] = {}
        self.lock = threading.Lock()

    def set_job(self, job_id, **kw):
        with self.lock:
            self.jobs.setdefault(job_id, {}).update(kw)

    def get_job(self, job_id):
        with self.lock:
            return dict(self.jobs.get(job_id, {}))


def _run_proof_job(state: AppState, job_id: str, image_id: str,
                   input_id: str, exec_only: bool):
    from .exec import ExecutorEnv, ExecutorImpl
    from .receipt import session_claim

    try:
        # IDs are client-controlled: restrict to the same [\w-]+ charset the
        # upload routes enforce so '../' or absolute paths cannot escape the
        # storage directory.
        for _id in (image_id, input_id):
            if not re.fullmatch(r"[\w-]+", _id):
                raise ValueError(f"invalid asset id: {_id!r}")
        elf = (state.storage / "images" / image_id).read_bytes()
        input_bytes = (state.storage / "inputs" / input_id).read_bytes()
        env = ExecutorEnv().write_slice(input_bytes)
        session = ExecutorImpl(env, elf).run()
        stats = {
            "segments": len(session.segments),
            "total_cycles": session.total_cycles,
            "cycles": session.user_cycles,
        }
        if exec_only:
            state.set_job(job_id, status="SUCCEEDED", stats=stats,
                          journal=session.journal)
            return
        info = state.prover.prove_session(session)
        receipt_path = state.storage / "receipts" / job_id
        receipt_path.write_bytes(pickle.dumps({
            "kind": info.receipt.inner.kind,
            "claim_digest": session_claim(session).digest().tobytes().hex(),
            "journal": info.receipt.journal.hex(),
        }))
        state.set_job(job_id, status="SUCCEEDED", stats=stats,
                      journal=session.journal)
    except Exception as e:  # job-level failure propagates to pollers
        state.set_job(job_id, status="FAILED", error=str(e))


class Handler(BaseHTTPRequestHandler):
    state: AppState = None  # assigned by serve()

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code, data):
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def log_message(self, *a):
        pass

    def do_GET(self):
        s = self.state
        if m := re.fullmatch(r"/images/upload/([\w-]+)", self.path):
            # presigned-style: url to PUT to; dedup flag mirrors the
            # reference's 204 on an existing image (bonsai sdk image_upload)
            exists = (s.storage / "images" / m.group(1)).exists()
            return self._json(200, {"url": f"/images/upload/{m.group(1)}",
                                    "exists": exists})
        if self.path == "/inputs/upload":
            input_id = str(uuid.uuid4())
            return self._json(200, {"uuid": input_id,
                                    "url": f"/inputs/upload/{input_id}"})
        if self.path == "/receipts/upload":
            rid = str(uuid.uuid4())
            return self._json(200, {"uuid": rid,
                                    "url": f"/receipts/upload/{rid}"})
        if m := re.fullmatch(r"/sessions/status/([\w-]+)", self.path):
            job = s.get_job(m.group(1))
            if not job:
                return self._json(404, {"error": "unknown job"})
            res = {"status": job.get("status", "RUNNING")}
            if job.get("status") == "SUCCEEDED":
                res["stats"] = job.get("stats")
                res["receipt_url"] = f"/receipts/stark/receipt/{m.group(1)}"
            if job.get("error"):
                res["error_msg"] = job["error"]
            return self._json(200, res)
        if m := re.fullmatch(r"/receipts/stark/receipt/([\w-]+)", self.path):
            path = s.storage / "receipts" / m.group(1)
            if not path.exists():
                return self._json(404, {"error": "no receipt"})
            return self._bytes(200, path.read_bytes())
        if self.path == "/version":
            return self._json(200, {"risc0_tpu_torch": "0.2",
                                    "compat_risc0": ["2.0", "3.0"]})
        if self.path == "/metrics":
            # Prometheus text exposition (reference r0vm OTLP metrics
            # pipeline equivalent, actors/mod.rs:39-46)
            from .. import telemetry
            return self._bytes(200, telemetry.metrics().expose().encode())
        if self.path == "/spans":
            # recent completed spans, OTLP/JSON-shaped
            from .. import telemetry
            spans = [sp.to_otlp() for sp in telemetry.tracer().finished()]
            return self._json(200, {"spans": spans[-500:]})
        if self.path == "/user/quotas":
            return self._json(200, {"exec_cycle_limit": 1 << 36,
                                    "max_parallelism": 4,
                                    "concurrent_proofs": 4})
        if m := re.fullmatch(r"/sessions/logs/([\w-]+)", self.path):
            job = s.get_job(m.group(1))
            if not job:
                return self._json(404, {"error": "unknown job"})
            return self._bytes(200, json.dumps(
                {"status": job.get("status"),
                 "error": job.get("error")}).encode())
        if m := re.fullmatch(r"/sessions/exec_only_journal/([\w-]+)", self.path):
            job = s.get_job(m.group(1))
            if "journal" not in job:
                return self._json(404, {"error": "no journal"})
            return self._bytes(200, job["journal"])
        return self._json(404, {"error": "not found"})

    def do_PUT(self):
        s = self.state
        if m := re.fullmatch(r"/(images|inputs|receipts)/upload/([\w-]+)",
                             self.path):
            (s.storage / m.group(1) / m.group(2)).write_bytes(self._body())
            return self._json(200, {"ok": True})
        return self._json(404, {"error": "not found"})

    def do_POST(self):
        s = self.state
        if self.path == "/sessions/create":
            req = json.loads(self._body() or b"{}")
            job_id = str(uuid.uuid4())
            s.set_job(job_id, status="RUNNING")
            t = threading.Thread(
                target=_run_proof_job,
                args=(s, job_id, req["img"], req["input"],
                      bool(req.get("execute_only", False))),
                daemon=True)
            t.start()
            return self._json(200, {"uuid": job_id})
        if self.path == "/snark/create":
            return self._json(501, {
                "error": "SNARK sessions are not served: prove with "
                         "receipt_kind groth16 (ProverOpts)"})
        if m := re.fullmatch(r"/sessions/stop/([\w-]+)", self.path):
            job = s.get_job(m.group(1))
            if not job:
                return self._json(404, {"error": "unknown job"})
            if job.get("status") == "RUNNING":
                s.set_job(m.group(1), status="ABORTED")
            return self._json(200, {"ok": True})
        return self._json(404, {"error": "not found"})


def serve(port: int = 8000, storage: str = DEFAULT_STORAGE,
          host: str = "127.0.0.1", prover=None, device="cuda"):
    """The service, not yet serving (call serve_forever).  `prover`
    proves its jobs; None: get_prover_server() on `device`."""
    if prover is None:
        from .prover import get_prover_server

        prover = get_prover_server(device=device)
    Handler.state = AppState(Path(storage), prover)
    server = ThreadingHTTPServer((host, port), Handler)
    return server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--storage", default=DEFAULT_STORAGE)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    server = serve(args.port, args.storage, device=args.device)
    print(f"listening on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
