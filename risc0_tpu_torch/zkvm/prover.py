"""Prover servers: options, the dev-mode prover, and the local prover on
the card (counterpart of ``risc0_tpu/zkvm/prover.py``; reference
risc0/zkvm/src/host/server/prove/{mod,prover_impl,opts,dev_mode}.rs).

``ProverImpl`` executes a guest, proves every segment with the rv32im
STARK prover, chains the claims into a CompositeReceipt and, for the
succinct kind, compresses it: lifts, joins, and resolves the assumption
receipts, the keccak coprocessor's union root among them.  A session
with a PoVW job id compresses through the WorkClaim programs, which
prove its Work (ProveInfo.work).  The groth16 kind re-proves that
receipt under Poseidon254 (identity_p254) and wraps it in a BN254
Groth16 proof (shrink_wrap).  It verifies the receipt before it returns
it.  The STARK proves run on `device`, the card unless the caller names
another; the Groth16 prove runs on the host.

``DevModeProver`` (RISC0_DEV_MODE, ProverOpts.dev_mode) proves nothing:
it returns FakeReceipts of the claims the real prover would prove, after
the simulated latencies of a DevModeDelay, for testing hosts and the
proof-job scheduler.  Its receipts verify only in a dev-mode context.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np

from ..convert import card
from . import recursion_driver
from .claims import (Assumption, Assumptions, ExitCode, MaybePruned, Output,
                     ReceiptClaim)
from .exec import ExecutorEnv, ExecutorImpl, Session, resolve_segment
from .receipt import (CompositeReceipt, FakeReceipt, Groth16Receipt,
                      Groth16ReceiptVerifierParameters, InnerReceipt, Receipt,
                      SegmentReceipt, VerificationError, VerifierContext,
                      is_dev_mode, segment_claim, session_claim,
                      session_segment_output, union_claim)

HASHFN = "poseidon2"  # the one hash suite the port proves with


@dataclass
class ProverOpts:
    """reference host/server/prove/opts.rs:28-59.  `dev_mode` (default:
    RISC0_DEV_MODE) makes get_prover_server return the DevModeProver.
    ProverImpl proves under `hashfn` "poseidon2" only, and refuses a
    segment of po2 above `max_segment_po2`."""

    hashfn: str = HASHFN
    receipt_kind: str = "composite"  # composite | succinct | groth16
    max_segment_po2: int = 22
    dev_mode: bool = field(default_factory=is_dev_mode)
    # Groth16 prover of shrink_wrap.  None: the in-process prover
    # (groth16/wrap.py: the stark_verify R1CS and a CRS made on first use
    # and cached), unless RISC0_SNARK_PROVER names a shell command with
    # the reference's contract (the stark_verify witness JSON on stdin; a
    # 256-byte seal, {"seal": hex} or a snarkjs proof JSON on stdout, as
    # groth16/src/prove/docker.rs runs rapidsnark).  "builtin" forces the
    # in-process prover; a callable takes the witness JSON like the
    # command.
    snark_prover: object | None = None
    # threads of the in-process Groth16 prover's MSMs and CRS (0: all cores)
    snark_threads: int = 0


@dataclass
class DevModeDelay:
    """Simulated latencies of the DevModeProver's operations, in seconds,
    for scheduler tests (reference prove/dev_mode.rs:41-101)."""

    execute: float = 0.0
    segment_preflight: float = 0.0
    prove_segment_core: float = 0.0
    lift: float = 0.0
    join: float = 0.0
    resolve: float = 0.0
    union: float = 0.0


@dataclass
class ProveInfo:
    receipt: Receipt
    session: Session
    # the PoVW Work when the env carried a povw_job_id (reference
    # prover_impl.rs work claims): proved by the succinct kind's WorkClaim
    # programs, counted on the host for the other kinds
    work: object | None = None


class ProverServer:
    """Interface (reference prove/mod.rs:54-256); ProverImpl and
    DevModeProver serve it."""

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        session = ExecutorImpl(env, elf).run()
        return self.prove_session(session)

    def prove_session(self, session: Session) -> ProveInfo:
        raise NotImplementedError

    def prove_segment(self, seg, claim) -> SegmentReceipt:
        raise NotImplementedError

    def segment_preflight(self, seg):
        """Host half of segment proving (reference ProverServer::
        segment_preflight, prove/mod.rs:79-82): an opaque result for
        prove_segment_core, so a scheduler can give the two halves to
        different worker pools."""
        raise NotImplementedError

    def prove_segment_core(self, preflight, seg, claim) -> SegmentReceipt:
        """Device half over a segment_preflight result (reference
        ProverServer::prove_segment_core, prove/mod.rs:83-86)."""
        raise NotImplementedError

    def lift(self, segment_receipt):
        raise NotImplementedError

    def join(self, a, b):
        raise NotImplementedError

    def resolve(self, conditional, assumption):
        raise NotImplementedError

    def union(self, a, b):
        raise NotImplementedError

    def prove_keccak(self, request: dict):
        """ProveKeccakRequest -> SuccinctReceipt (api.proto:63-71)."""
        raise NotImplementedError


class DevModeProver(ProverServer):
    """FakeReceipts of the claims the real prover would prove (reference
    prove/dev_mode.rs), after the latencies of `delay`."""

    def __init__(self, delay: DevModeDelay | None = None):
        self.delay = delay or DevModeDelay()

    @staticmethod
    def _sleep(seconds):
        if seconds:
            time.sleep(seconds)

    def prove_session(self, session: Session) -> ProveInfo:
        for _seg in session.segments:
            self._sleep(self.delay.prove_segment_core)
        receipt = Receipt(InnerReceipt("fake", FakeReceipt(
            session_claim(session))), session.journal)
        return ProveInfo(receipt=receipt, session=session,
                         work=_session_work(session))

    def prove_segment(self, seg, claim) -> FakeReceipt:
        self._sleep(self.delay.segment_preflight)
        self._sleep(self.delay.prove_segment_core)
        return FakeReceipt(claim)

    def segment_preflight(self, seg):
        self._sleep(self.delay.segment_preflight)
        return {"fake_preflight": getattr(seg, "index", 0)}

    def prove_segment_core(self, preflight, seg, claim) -> FakeReceipt:
        self._sleep(self.delay.prove_segment_core)
        return FakeReceipt(claim)

    def lift(self, segment_receipt):
        self._sleep(self.delay.lift)
        return FakeReceipt(segment_receipt.claim)

    def join(self, a, b):
        self._sleep(self.delay.join)
        return FakeReceipt(ReceiptClaim(
            pre=a.claim.pre, post=b.claim.post, exit_code=b.claim.exit_code,
            input=a.claim.input, output=b.claim.output))

    def lift_povw(self, segment_receipt, work=None):
        """WorkClaim{segment claim, work}: the scheduler hands in the Work
        that the real program reads from the seal."""
        from .povw import WorkClaim

        self._sleep(self.delay.lift)
        return FakeReceipt(WorkClaim(segment_receipt.claim, work))

    def join_povw(self, a, b, unwrap=False):
        self._sleep(self.delay.join)
        joined = a.claim.join(b.claim)  # chains the claims, joins the Work
        return FakeReceipt(joined.claim if unwrap else joined)

    def unwrap_povw(self, inner):
        return FakeReceipt(inner.claim.claim)

    def resolve_povw(self, conditional, assumption, unwrap=False):
        from .povw import WorkClaim

        wc = conditional.claim
        inner = self.resolve(FakeReceipt(wc.claim), assumption)
        return inner if unwrap else FakeReceipt(WorkClaim(inner.claim,
                                                          wc.work))

    def resolve(self, conditional, assumption):
        """The conditional claim without its head assumption, the rest
        kept as a list (reference Assumptions::resolve)."""
        self._sleep(self.delay.resolve)
        claim = conditional.claim
        out = claim.output.value if claim.output is not None else None
        if out is None or not out.assumptions.value.items:
            return conditional
        rest = Assumptions(list(out.assumptions.value.items[1:]))
        return FakeReceipt(ReceiptClaim(
            pre=claim.pre, post=claim.post, exit_code=claim.exit_code,
            input=claim.input,
            output=MaybePruned.of(Output(out.journal, MaybePruned.of(rest)))))

    def union(self, a, b):
        """The UnionClaim the union program proves: the two operands'
        Assumption{claim, allowed root} digests, ordered
        (receipt.union_claim), as receipt.keccak_root_claim merges them.
        The JAX package's fake union binds the bare claim digests
        (ROADMAP.md queue 3)."""
        from ..circuit.recursion.predicates import own_control_ids

        self._sleep(self.delay.union)
        _ids, root = own_control_ids()
        return FakeReceipt(union_claim(
            Assumption(np.asarray(a.claim.digest(), np.uint32), root).digest(),
            Assumption(np.asarray(b.claim.digest(), np.uint32), root).digest()))

    def compress(self, receipt):
        """Fake receipts are already minimal (reference dev_mode.rs)."""
        return receipt

    def identity_p254(self, receipt):
        return receipt

    def shrink_wrap(self, receipt):
        return receipt

    def prove_keccak(self, request: dict):
        digest = request["claim_digest"]
        digest = (np.frombuffer(bytes(digest), np.uint32)
                  if isinstance(digest, (bytes, bytearray))
                  else np.asarray(digest, np.uint32))
        return FakeReceipt(MaybePruned.from_digest(digest))


class ProverImpl(ProverServer):
    """The cryptographic local prover on `device` (reference
    prove/prover_impl.rs:52-181)."""

    def __init__(self, opts: ProverOpts | None = None, device="cuda"):
        self.device = card(device)
        self.opts = opts or ProverOpts()
        if self.opts.hashfn != HASHFN:
            raise ValueError(f"ProverImpl proves under {HASHFN} only, not "
                             f"{self.opts.hashfn}")

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

    def compress(self, receipt: Receipt) -> Receipt:
        """A composite Receipt -> the succinct Receipt of its claim,
        verified (reference prove/mod.rs compress); a succinct one is
        returned as it is."""
        if receipt.inner.kind == "succinct":
            return receipt
        if receipt.inner.kind != "composite":
            raise ValueError(f"cannot compress a {receipt.inner.kind} receipt")
        out = Receipt(InnerReceipt("succinct", self.compress_composite(
            receipt.inner.value)), receipt.journal)
        out.verify_integrity(self._verifier_ctx())
        return out

    def prove_segment(self, seg, claim) -> SegmentReceipt:
        return self.prove_segment_core(self.segment_preflight(seg), seg,
                                       claim)

    def segment_preflight(self, seg):
        """Host half of segment proving (reference ProverServer::
        segment_preflight, prove/mod.rs:79-82): an opaque result for
        prove_segment_core."""
        from ..circuit.rv32im.prove import segment_preflight

        seg = resolve_segment(seg)
        if seg.po2 > self.opts.max_segment_po2:
            raise ValueError(f"segment po2 {seg.po2} exceeds max_segment_po2 "
                             f"{self.opts.max_segment_po2}")
        return segment_preflight(seg, device=self.device)

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
        """`assumption`: a succinct receipt, or a top-level Receipt of
        one (as ExecutorEnv.add_assumption records it)."""
        return recursion_driver.resolve(
            conditional, recursion_driver._as_succinct(assumption),
            self.device)

    def lift_povw(self, segment_receipt, work=None):
        """The program reads the Work from the seal's globals; a `work`
        the caller expects (the scheduler's) must be that Work."""
        receipt = recursion_driver.lift_povw(segment_receipt, self.device)
        if work is not None and receipt.claim.work != work:
            raise VerificationError(
                f"the seal's work {receipt.claim.work} is not {work}")
        return receipt

    def join_povw(self, a, b, unwrap=False):
        return recursion_driver.join_povw(a, b, unwrap, self.device)

    def unwrap_povw(self, inner):
        return recursion_driver.unwrap_povw(inner, self.device)

    def resolve_povw(self, conditional, assumption, unwrap=False):
        return recursion_driver.resolve_povw(
            conditional, recursion_driver._as_succinct(assumption), unwrap,
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

            g, params = g16wrap.wrap(p254, n_threads=self.opts.snark_threads)
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
    """reference prove/mod.rs:417-424: the DevModeProver in dev mode, else
    ProverImpl on `device`."""
    opts = opts or ProverOpts()
    if opts.dev_mode:
        return DevModeProver()
    return ProverImpl(opts, device)


def default_prover(device="cuda") -> ProverServer:
    return get_prover_server(device=device)
