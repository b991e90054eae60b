"""What the examples share: the command line with its ``--device``, which
is resolved before anything runs, and the proving modes."""

from __future__ import annotations

import argparse
import os

from ..convert import card
from ..zkvm.prover import ProverOpts, get_prover_server
from ..zkvm.receipt import VerifierContext


def parse_args(argv, doc: str, add_args=None) -> argparse.Namespace:
    """Parse `argv` (None: sys.argv) and resolve ``--device`` (default
    cuda) through convert.card: without that device this raises, before
    the example does any work."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    if add_args is not None:
        add_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to prove on (default: cuda)")
    args = ap.parse_args(argv)
    args.device = card(args.device)
    return args


def real_prove() -> bool:
    """RISC0_REAL_PROVE=1 asks for the cryptographic prover; otherwise
    the examples prove in dev mode."""
    return os.environ.get("RISC0_REAL_PROVE") == "1"


def dev_mode_default_on() -> bool:
    """RISC0_DEV_MODE, read as the JAX examples that set it to 1 unless
    it is already set: on unless set to a false value."""
    v = os.environ.get("RISC0_DEV_MODE", "1")
    return v.lower() not in ("", "0", "false", "no")


def composite_prover(device, real: bool):
    """The composite-receipt prover on `device`: ProverImpl when `real`,
    else the DevModeProver."""
    return get_prover_server(ProverOpts(receipt_kind="composite",
                                        dev_mode=not real), device)


def verifier_ctx(real: bool) -> VerifierContext:
    """The context the examples verify in: a dev-mode one for fake
    receipts, so that no example needs RISC0_DEV_MODE in its process."""
    return VerifierContext(dev_mode=not real)
