# The port's own copy of risc0_tpu/cli.py.
"""r0vm-equivalent CLI (reference: risc0/r0vm/src/lib.rs:28-127), the
port's entry point.

Usage:
  python -m risc0_tpu_torch.cli execute --elf guest.elf [--input-hex 64000000] [--po2 N]
  python -m risc0_tpu_torch.cli id --elf guest.elf
  python -m risc0_tpu_torch.cli prove --elf guest.elf [--input-hex ...]
      [--receipt-kind composite|succinct|groth16] [--device cuda]
  python -m risc0_tpu_torch.cli verify --seal seal.bin [--device cuda]  (rv32im seal)
  python -m risc0_tpu_torch.cli serve --config cluster.toml [--device cuda]
  python -m risc0_tpu_torch.cli port --port P [--device cuda]
  python -m risc0_tpu_torch.cli new NAME [--dest DIR]

`prove`, `verify`, `serve` and `port` run on --device, the card unless
another is named (`--device cpu`); RISC0_DEV_MODE=1 proves with the
DevModeProver instead.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _env(args):
    from .zkvm.exec import ExecutorEnv

    env = ExecutorEnv(segment_po2=args.po2)
    if args.input_hex:
        env.write_slice(bytes.fromhex(args.input_hex))
    if args.input:
        with open(args.input, "rb") as f:
            env.write_slice(f.read())
    return env


def _elf(args) -> bytes:
    """The ELF, or a ProgramBinary (R0BF), as main reads it."""
    with open(args.elf, "rb") as f:
        return f.read()


_GUEST_TMPL = '''\
"""Guest for {name}: assembled rv32im (risc0_tpu_torch.zkvm.guest_env).

Reads input words, computes, journals the result.  Swap the body for
your own logic; the env library provides read_slice / commit / exit
plus raw Asm access (g.a) for arithmetic and control flow.
"""

from risc0_tpu_torch.zkvm.guest_env import GuestEnv


def build_guest() -> bytes:
    g = GuestEnv()
    a = g.a
    a.li("sp", 0x200400)

    inp = g.read_slice(8)           # two u32 words from the host
    out = a.put_data(b"\\0" * 4)
    a.li("t3", inp)
    a.lw("t4", "t3", 0)
    a.lw("t5", "t3", 4)
    a.add("t4", "t4", "t5")         # result = x + y
    a.li("t3", out)
    a.sw("t3", "t4", 0)

    dig = g.commit(out, 4)
    g.exit(0, dig)
    return g.link()
'''

_HOST_TMPL = '''\
"""Host for {name}: execute the guest, prove the session, verify."""

import os

from guest import build_guest
from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
from risc0_tpu_torch.zkvm.prover import ProverOpts, get_prover_server


def main():
    x, y = 7, 35
    elf = build_guest()
    env = ExecutorEnv(segment_po2=16).write_slice(
        x.to_bytes(4, "little") + y.to_bytes(4, "little"))
    executor = ExecutorImpl(env, elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    print("journal:", int.from_bytes(bytes(session.journal), "little"))

    if os.environ.get("RISC0_REAL_PROVE") != "1":
        os.environ["RISC0_DEV_MODE"] = "1"  # fast receipts while iterating
    prover = get_prover_server(ProverOpts(receipt_kind="composite"),
                               device=os.environ.get("RISC0_DEVICE", "cuda"))
    info = prover.prove_session(session)
    info.receipt.verify(image_id)
    print("receipt verified:", info.receipt.inner.kind)


if __name__ == "__main__":
    main()
'''

_README_TMPL = '''\
# {name}

A risc0_tpu_torch host+guest project (scaffolded by
`python -m risc0_tpu_torch.cli new`).

    PYTHONPATH=<repo> python host.py                 # dev-mode receipt
    RISC0_REAL_PROVE=1 PYTHONPATH=<repo> python host.py   # STARK on the card
    RISC0_REAL_PROVE=1 RISC0_DEVICE=cpu PYTHONPATH=<repo> python host.py

Edit `guest.py` for the in-zkVM program, `host.py` for input/receipt
handling.  See the repo `examples/` directory for richer guests
(sha, ecdsa, composition, keccak coprocessor, PoVW).
'''


def _scaffold(name: str, dest: str) -> int:
    import os
    import re

    if not re.fullmatch(r"[A-Za-z0-9_\-]+", name):
        print(f"invalid project name: {name!r}", file=sys.stderr)
        return 1
    root = os.path.join(dest, name)
    os.makedirs(root)
    for fname, tmpl in (("guest.py", _GUEST_TMPL), ("host.py", _HOST_TMPL),
                        ("README.md", _README_TMPL)):
        with open(os.path.join(root, fname), "w") as f:
            f.write(tmpl.format(name=name))
    print(json.dumps({"created": root,
                      "files": ["guest.py", "host.py", "README.md"]}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="risc0_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("execute", "id", "prove"):
        p = sub.add_parser(name)
        p.add_argument("--elf", required=True)
        p.add_argument("--input-hex", default="")
        p.add_argument("--input", default="")
        p.add_argument("--po2", type=int, default=20)
        p.add_argument("--kernel", action="store_true",
                       help="bare-metal kernel-only ELF, no userspace "
                            "(reference from_kernel_elf)")
        if name == "prove":
            p.add_argument("--receipt-kind", default=None,
                           choices=["composite", "succinct", "groth16"])
            p.add_argument("--device", default="cuda")
    p = sub.add_parser("verify")
    p.add_argument("--seal", required=True)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("serve", help="launch a cluster from a TOML config "
                       "(reference `r0vm --config`)")
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("port", help="protobuf IPC server: connect back to "
                       "the client listener (reference `r0vm --port`)")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("new", help="scaffold a host+guest project "
                       "(reference `cargo risczero new`)")
    p.add_argument("name")
    p.add_argument("--dest", default=".")
    args = ap.parse_args(argv)

    if args.cmd == "new":
        return _scaffold(args.name, args.dest)

    if args.cmd == "serve":
        import time as _time

        from .parallel.config import launch_cluster, load_config
        from .zkvm.prover import get_prover_server

        cluster = launch_cluster(load_config(args.config),
                                 get_prover_server(device=args.device))
        print(json.dumps({"workers": len(cluster.workers),
                          "manager": bool(cluster.factory_server),
                          "api": bool(cluster.api_server)}))
        try:
            while True:
                _time.sleep(1)
        except KeyboardInterrupt:
            cluster.stop()
        return 0

    if args.cmd == "port":
        from .zkvm.ipc import ApiServer

        ApiServer(device=args.device).connect(args.host, args.port)
        return 0

    if args.cmd == "verify":
        from .circuit.rv32im.verify import verify_rv32im_seal
        from .convert import card

        card(args.device)  # as every entry point; the verifier is host code
        seal = np.fromfile(args.seal, np.uint32)
        out = verify_rv32im_seal(seal)
        print(json.dumps({"ok": True, "globals": [int(x) for x in out[:8]]}))
        return 0

    from .zkvm.binfmt import ProgramBinary
    from .zkvm.exec import ExecutorImpl

    data = _elf(args)
    env = _env(args)
    if data[:4] == b"R0BF":
        pb = ProgramBinary.decode(data)
        ex = ExecutorImpl(env, pb.user_elf, pb.kernel_elf)
    elif args.kernel:
        ex = ExecutorImpl.from_kernel_elf(env, data)
    else:
        ex = ExecutorImpl(env, data)

    if args.cmd == "id":
        image_id = ex.compute_image_id()
        print(bytes(image_id.tobytes()).hex())
        return 0

    if args.cmd == "execute":
        s = ex.run()
        print(json.dumps({
            "exit": s.exit_code, "segments": len(s.segments),
            "user_cycles": s.user_cycles, "total_cycles": s.total_cycles,
            "paging_cycles": s.paging_cycles,
            "journal": s.journal.hex(),
        }))
        return 0

    if args.cmd == "prove":
        from .zkvm.prover import ProverOpts, get_prover_server

        opts = ProverOpts(receipt_kind=args.receipt_kind) \
            if args.receipt_kind else None
        prover = get_prover_server(opts, args.device)
        session = ex.run()
        info = prover.prove_session(session)
        claim = info.receipt.claim()
        print(json.dumps({
            "kind": info.receipt.inner.kind,
            "claim_digest": claim.digest().tobytes().hex(),
            "journal": info.receipt.journal.hex(),
            "segments": len(session.segments),
            "total_cycles": session.total_cycles,
        }))
        return 0


if __name__ == "__main__":
    sys.exit(main())
