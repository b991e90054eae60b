"""Prover servers: options, and the local prover on the card (counterpart
of ``risc0_tpu/zkvm/prover.py``; reference risc0/zkvm/src/host/server/
prove/{mod,prover_impl,opts}.rs).

``ProverImpl`` executes a guest, proves every segment with the rv32im
STARK prover, chains the claims into a CompositeReceipt and, for the
succinct kind, compresses it: lifts, joins, and resolves the assumption
receipts, the keccak coprocessor's union root among them.  A session
with a PoVW job id compresses through the WorkClaim programs, which
prove its Work (ProveInfo.work).  The groth16 kind re-proves that
receipt under Poseidon254 (identity_p254) and wraps it in a BN254
Groth16 proof (shrink_wrap).  It verifies the receipt before it returns
it.  The STARK proves run on `device`, the card unless the caller names
another; the Groth16 prove runs on the host.  The dev-mode prover waits
for its slice (ROADMAP.md queue 1) and raises.
"""

from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass

import numpy as np

from ..convert import card
from . import recursion_driver
from .claims import ExitCode
from .exec import ExecutorEnv, ExecutorImpl, Session, resolve_segment
from .receipt import (CompositeReceipt, Groth16Receipt,
                      Groth16ReceiptVerifierParameters, InnerReceipt, Receipt,
                      SegmentReceipt, VerifierContext, segment_claim,
                      session_segment_output)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to risc0_tpu_torch yet (ROADMAP.md queue 1)")


HASHFN = "poseidon2"  # the one hash suite the port proves with


@dataclass
class ProverOpts:
    """reference host/server/prove/opts.rs:28-59, the options served here.
    `dev_mode` is the reference's switch to DevModeProver, which waits for
    ROADMAP.md queue 1: get_prover_server raises on it."""

    receipt_kind: str = "composite"  # composite | succinct | groth16
    dev_mode: bool = False
    # Groth16 prover of shrink_wrap.  None: the in-process prover
    # (groth16/wrap.py: the stark_verify R1CS and a CRS made on first use
    # and cached), unless RISC0_SNARK_PROVER names a shell command with
    # the reference's contract (the stark_verify witness JSON on stdin; a
    # 256-byte seal, {"seal": hex} or a snarkjs proof JSON on stdout, as
    # groth16/src/prove/docker.rs runs rapidsnark).  "builtin" forces the
    # in-process prover; a callable takes the witness JSON like the
    # command.
    snark_prover: object | None = None


@dataclass
class ProveInfo:
    receipt: Receipt
    session: Session
    # the PoVW Work when the env carried a povw_job_id (reference
    # prover_impl.rs work claims): proved by the succinct kind's WorkClaim
    # programs, counted on the host for the other kinds
    work: object | None = None


class ProverServer:
    """Interface (reference prove/mod.rs:54-256); ProverImpl serves it."""

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        session = ExecutorImpl(env, elf).run()
        return self.prove_session(session)

    def prove_session(self, session: Session) -> ProveInfo:
        raise NotImplementedError


class ProverImpl(ProverServer):
    """The cryptographic local prover on `device` (reference
    prove/prover_impl.rs:52-181)."""

    def __init__(self, opts: ProverOpts | None = None, device="cuda"):
        self.device = card(device)
        self.opts = opts or ProverOpts()

    def prove_session(self, session: Session) -> ProveInfo:
        kind, *rest = session.exit_code
        session_exit = ExitCode(kind, rest[0] if rest else 0)
        # the final segment claims the output the guest committed, every
        # assumption included (reference prover_impl.rs:98-114); resolve
        # removes them in compress
        output = session_segment_output(session)
        g16_params = None
        receipts = []
        for i, seg in enumerate(session.segments):
            final = i == len(session.segments) - 1
            receipts.append(self.prove_segment(
                seg, segment_claim(seg, final, session_exit, output)))
        composite = CompositeReceipt(
            segments=receipts,
            assumption_receipts=self._assumption_receipts(session))
        work = _session_work(session)
        if self.opts.receipt_kind == "composite":
            inner = InnerReceipt("composite", composite)
        elif self.opts.receipt_kind == "succinct":
            if work is not None:
                # lift_povw and join_povw thread the segment nonces
                # through WorkClaims; the last merge unwraps to the
                # session claim and proves the total Work
                succinct, work = recursion_driver.compress_composite_povw(
                    composite, self.device)
            else:
                succinct = self.compress_composite(composite)
            inner = InnerReceipt("succinct", succinct)
        elif self.opts.receipt_kind == "groth16":
            inner = InnerReceipt("groth16", self.shrink_wrap(
                self.compress_composite(composite)))
            g16_params = self._groth16_params()
        else:
            raise ValueError(f"unknown receipt kind {self.opts.receipt_kind}")
        receipt = Receipt(inner, session.journal)
        # self-check before returning (reference prover_impl.rs:155-170)
        receipt.verify_integrity(self._verifier_ctx(g16_params))
        return ProveInfo(receipt=receipt, session=session, work=work)

    def _assumption_receipts(self, session) -> list:
        """One receipt per assumptions_used entry, head first (reference
        prover_impl.rs:121-153): a proven entry keeps its receipt; an
        unresolved one (sys_verify_integrity2, receipt None) takes the
        keccak union-root receipt when its claim is that root's, and
        raises otherwise."""
        union_root = recursion_driver.keccak_union_root(
            getattr(session, "pending_keccaks", []), self.device)
        out = []
        for a, r in session.assumptions_used:
            if r is None:
                root_claim = None if union_root is None else \
                    recursion_driver.receipt_claim_digest(union_root)
                if root_claim is None or not np.array_equal(
                        np.asarray(a.claim, np.uint32), root_claim):
                    raise ValueError(
                        "no receipt available for unresolved assumption: "
                        f"claim {bytes(np.asarray(a.claim, np.uint32)).hex()}")
                r = union_root
            if hasattr(r, "verify_integrity"):
                out.append(r)
        return out

    def _verifier_ctx(self, groth16_params=None) -> VerifierContext:
        from ..circuit.recursion.predicates import own_control_ids

        _ids, root = own_control_ids()
        return VerifierContext(hashfn=HASHFN, dev_mode=False,
                               control_root=root,
                               groth16_params=groth16_params)

    def _snark_command(self) -> str | None:
        """The external Groth16 prover's shell command, if one is named."""
        if self.opts.snark_prover is None:
            return os.environ.get("RISC0_SNARK_PROVER") or None
        return None

    def _builtin_snark(self) -> bool:
        """Whether shrink_wrap proves with the in-process Groth16 prover."""
        return self.opts.snark_prover in (None, "builtin") \
            and self._snark_command() is None

    def _groth16_params(self):
        """The verifier parameters of this prover's Groth16 receipts: the
        in-process prover's own CRS key, else the defaults (the ceremony
        key the external provers target)."""
        if self._builtin_snark():
            from ..groth16 import wrap as g16wrap

            return g16wrap.verifier_parameters()
        return None

    def compress_composite(self, composite):
        """CompositeReceipt -> SuccinctReceipt (reference
        prover_impl.rs:183-213)."""
        return recursion_driver.compress_composite(composite, self.device)

    def prove_segment(self, seg, claim) -> SegmentReceipt:
        return self.prove_segment_core(self.segment_preflight(seg), seg,
                                       claim)

    def segment_preflight(self, seg):
        """Host half of segment proving (reference ProverServer::
        segment_preflight, prove/mod.rs:79-82): an opaque result for
        prove_segment_core."""
        from ..circuit.rv32im.prove import segment_preflight

        return segment_preflight(resolve_segment(seg), device=self.device)

    def prove_segment_core(self, preflight, seg, claim) -> SegmentReceipt:
        """Device half over a segment_preflight result (reference
        ProverServer::prove_segment_core, prove/mod.rs:83-86)."""
        from ..circuit.rv32im.prove import prove_segment_core

        seal = prove_segment_core(preflight, device=self.device)
        return SegmentReceipt(seal=seal, index=getattr(seg, "index", 0),
                              hashfn=HASHFN, claim=claim)

    def lift(self, segment_receipt):
        return recursion_driver.lift(segment_receipt, self.device)

    def join(self, a, b):
        return recursion_driver.join(a, b, self.device)

    def resolve(self, conditional, assumption):
        return recursion_driver.resolve(conditional, assumption, self.device)

    def lift_povw(self, segment_receipt):
        """The program reads the Work from the seal's globals."""
        return recursion_driver.lift_povw(segment_receipt, self.device)

    def join_povw(self, a, b, unwrap=False):
        return recursion_driver.join_povw(a, b, unwrap, self.device)

    def unwrap_povw(self, inner):
        return recursion_driver.unwrap_povw(inner, self.device)

    def resolve_povw(self, conditional, assumption, unwrap=False):
        return recursion_driver.resolve_povw(conditional, assumption, unwrap,
                                             self.device)

    def union(self, a, b):
        return recursion_driver.union(a, b, self.device)

    def prove_keccak(self, request: dict):
        """ProveKeccakRequest -> SuccinctReceipt (api.proto:63-71)."""
        return recursion_driver.prove_keccak_request(request, self.device)

    def identity_p254(self, receipt):
        """Poseidon2 SuccinctReceipt -> Poseidon254 SuccinctReceipt, the
        wrap's input (reference recursion/prove/mod.rs identity_p254)."""
        return recursion_driver.identity_p254(receipt, self.device)

    def shrink_wrap(self, receipt) -> Groth16Receipt:
        """SuccinctReceipt -> Groth16Receipt (reference prove/mod.rs
        shrink_wrap and the r0vm ShrinkWrap task): identity_p254 on the
        card, then a Groth16 proof of the stark_verify circuit over its
        seal, by the in-process prover or the external one that
        ProverOpts.snark_prover or RISC0_SNARK_PROVER names.  The
        receipt is checked with the BN254 pairing verifier before it is
        returned."""
        from ..groth16.seal_to_json import to_json

        p254 = self.identity_p254(receipt)
        if self._builtin_snark():
            from ..groth16 import wrap as g16wrap

            g, params = g16wrap.wrap(p254)
            g.verify_integrity(self._verifier_ctx(params))
            return g
        witness = to_json(np.asarray(p254.seal, np.uint32))
        cmd = self._snark_command()
        if cmd is not None:
            r = subprocess.run(cmd, shell=True, input=witness.encode(),
                               capture_output=True, check=False)
            if r.returncode != 0:
                raise RuntimeError(
                    f"snark prover failed: {r.stderr[-500:]!r}")
            out = json.loads(r.stdout)
        else:
            out = self.opts.snark_prover(witness)
        g = Groth16Receipt(
            seal=_groth16_seal(out), claim=p254.claim,
            verifier_parameters=Groth16ReceiptVerifierParameters.default()
            .digest())
        g.verify_integrity(self._verifier_ctx())
        return g


def _groth16_seal(out) -> bytes:
    """The 256-byte seal of an external prover's answer: raw bytes,
    {"seal": hex}, or a snarkjs proof JSON (under "proof" or bare)."""
    from ..groth16.verifier import proof_json_to_seal

    if isinstance(out, (bytes, bytearray)):
        return bytes(out)
    if "seal" in out:
        return bytes.fromhex(out["seal"])
    return proof_json_to_seal(out.get("proof", out))


def _session_work(session):
    """The session's Work, one nonce a segment, or None without PoVW."""
    if getattr(session, "povw_job_id", None) is None:
        return None
    from .povw import session_work

    return session_work(session, session.povw_job_id)


def get_prover_server(opts: ProverOpts | None = None,
                      device="cuda") -> ProverServer:
    """reference prove/mod.rs:417-424"""
    opts = opts or ProverOpts()
    if opts.dev_mode:
        raise _not_ported("the dev-mode prover")
    return ProverImpl(opts, device)


def default_prover(device="cuda") -> ProverServer:
    return get_prover_server(device=device)
