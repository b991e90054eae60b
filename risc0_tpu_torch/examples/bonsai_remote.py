"""Remote-proving example (reference bonsai-sdk usage + examples/prover):
upload a guest image and input to a Bonsai-compatible REST proving
service, poll the STARK session to completion, and download the receipt.
The service here is the port's api_server, started in this process on
`--device` and proving in dev mode unless RISC0_DEV_MODE is set off;
point BONSAI_API_URL at a deployed instance instead.

    python -m risc0_tpu_torch.examples.bonsai_remote [--device cpu]
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

from .. import loop_guest
from ..zkvm.api_server import serve
from ..zkvm.bonsai import Client
from ..zkvm.prover import ProverOpts, get_prover_server
from .common import dev_mode_default_on, parse_args

LOOP_COUNT = 42


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    url = os.environ.get("BONSAI_API_URL")
    srv = storage = None
    if not url:
        storage = tempfile.TemporaryDirectory()
        prover = get_prover_server(ProverOpts(dev_mode=dev_mode_default_on()),
                                   args.device)
        srv = serve(port=0, storage=storage.name, prover=prover)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        print(f"started local proving service at {url}")
    try:
        client = Client.from_parts(url)
        elf = loop_guest.elf()
        client.upload_img("loop-img", elf)
        input_id = client.upload_input(LOOP_COUNT.to_bytes(4, "little"))
        print(f"uploaded image + input ({input_id})")

        session = client.create_session("loop-img", input_id)
        while (res := session.status(client))["status"] == "RUNNING":
            time.sleep(0.2)
        if res["status"] != "SUCCEEDED":
            raise SystemExit(f"proving failed: {res}")
        print(f"session {session.uuid}: {res['stats']}")
        receipt = client.download(res["receipt_url"])
        print(f"downloaded receipt: {len(receipt)} bytes")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            storage.cleanup()
    return {"elf": elf, "status": res, "receipt": receipt}


if __name__ == "__main__":
    main()
