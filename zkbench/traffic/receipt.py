"""Items that each prove a guest to a receipt: a user waiting on
`ProverImpl(ProverOpts(receipt_kind=...)).prove(env, elf)`, which
executes, proves every segment, compresses (for the succinct kind) and
checks the receipt before it returns it.

Item k proves the guest on inputs drawn from (seed, k); the warm-up is
item 0, the window's items are 1, 2, ...  The judge holds each item to
the plain reference: the journal and exit code to what secp256k1 says of
the inputs, every segment seal to the verifier and its claim, the
receipt to the kind the mix asks for, and a succinct receipt's seal to
the recursion verifier, its program to the allowed set and its claim to
the session's expected claim.  A counter, on in every run, holds each
item to one self-check (`Receipt.verify_integrity`) of the receipt that
`prove` returned, passed before it returned.
"""

import os
import time

import numpy as np

from zkbench.reference import circuits, claims, image, secp256k1, stark


def stream(seed: int, *key) -> np.random.Generator:
    """The generator of one use of the seed: (1, k) item k."""
    return np.random.default_rng([seed % 2**64, *key])


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.config
        self.mix = ctx.mix
        self.timed = False
        self.sync = lambda: None
        self.span = None
        self.current = None
        self._restore = []

    def perf_module(self):
        from risc0_tpu_torch import perf

        return perf

    def setup(self):
        from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

        self.guest = self.ctx.cell.guest_module()
        self.elf = self.guest.elf(self.ctx.root, self.config)
        self.prover = ProverImpl(ProverOpts(
            receipt_kind=self.mix["receipt_kind"]), self.ctx.device)
        inner = self.prover.prove_segment

        def prove_segment(seg, claim):
            # keeps each segment seal for the judge
            receipt = self._call("prove_segment", inner, seg, claim)
            self.current["segments"].append(
                (int(seg.po2), np.asarray(receipt.seal, np.uint32)))
            return receipt

        self.prover.prove_segment = prove_segment
        self._count_self_checks()
        self.warm = self._prove(0)

    def _count_self_checks(self):
        """Keep, in the current item, each receipt whose
        `Receipt.verify_integrity` returned."""
        from risc0_tpu_torch.zkvm.receipt import Receipt

        inner = Receipt.verify_integrity

        def counted(receipt, *args, **kw):
            out = inner(receipt, *args, **kw)
            if self.current is not None:
                self.current["checked"].append(receipt)
            return out

        self._restore.append((Receipt, "verify_integrity", inner))
        Receipt.verify_integrity = counted

    def _call(self, name, fn, *args, **kw):
        """fn(*args); with timers installed, its wall time (ended by a
        device sync) and the program's perf scopes, read and reset around
        it, are kept under `name` in the current item."""
        if not self.timed:
            return fn(*args, **kw)
        from risc0_tpu_torch import perf

        perf.reset()
        t0 = time.perf_counter()
        if self.span is not None:
            with self.span(name):
                out = fn(*args, **kw)
                self.sync()
        else:
            out = fn(*args, **kw)
            self.sync()
        self.current["calls"].setdefault(name, []).append(
            {"s": time.perf_counter() - t0, "scopes": perf.report()})
        return out

    def install_timers(self, sync):
        """Timers around the executor, the segment prover, each lift and
        the receipt's self-check."""
        from risc0_tpu_torch.zkvm import exec as zexec
        from risc0_tpu_torch.zkvm import receipt as zreceipt
        from risc0_tpu_torch.zkvm import recursion_driver

        self.timed = True
        self.sync = sync
        for owner, attr, name in ((zexec.ExecutorImpl, "run", "executor"),
                                  (recursion_driver, "lift", "lift"),
                                  (zreceipt.Receipt, "verify_integrity",
                                   "self_check")):
            inner = getattr(owner, attr)
            self._restore.append((owner, attr, inner))
            setattr(owner, attr, self._timer(name, inner))

    def _timer(self, name, inner):
        def timed(*args, **kw):
            return self._call(name, inner, *args, **kw)
        return timed

    def _prove(self, k):
        from risc0_tpu_torch.zkvm.exec import ExecutorEnv

        inp = self.guest.inputs(self.config, stream(self.ctx.seed, 1, k))
        rec = {"k": k, "inputs": inp, "segments": [], "calls": {},
               "checked": []}
        self.current = rec
        env = ExecutorEnv(segment_po2=self.config["segment_po2"]).write_slice(
            inp["stdin"])
        t0 = time.perf_counter()
        try:
            info = self.prover.prove(env, self.elf)
            rec["journal"] = bytes(info.receipt.journal)
            rec["exit"] = tuple(info.session.exit_code)
            rec["self_checks"] = sum(r is info.receipt
                                     for r in rec["checked"])
            inner = info.receipt.inner
            rec["kind"] = inner.kind
            if inner.kind == "succinct":
                rec["seal"] = np.asarray(inner.value.seal, np.uint32)
        except Exception as e:  # an item that fails is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"
        self.sync()
        rec["s"] = time.perf_counter() - t0
        del rec["checked"]
        self.current = None
        return rec

    def item(self, i):
        return self._prove(i + 1)

    def end_to_end(self, results, window_s):
        return {"receipt_s": window_s / len(results)}

    def free(self):
        for owner, attr, inner in reversed(self._restore):
            setattr(owner, attr, inner)
        self._restore = []
        self.prover = None

    def judge(self, results):
        """{number: (value, limit)} over the warm-up and every item."""
        image_id = image.image_id_of_files(
            os.path.join(self.ctx.root, self.config["elf"]),
            os.path.join(self.ctx.root, self.config["kernel_elf"]))
        ids, root = claims.allowed_set()
        out = {"rejected": 0, "claims_wrong": 0, "journals_wrong": 0,
               "unchecked": 0}
        for rec in [self.warm] + list(results):
            if "error" in rec:
                out["rejected"] += 1
                continue
            out["unchecked"] += rec["self_checks"] != 1
            inp = rec["inputs"]
            valid = secp256k1.verify(inp["message"], inp["q"], inp["r"],
                                     inp["s"])
            journal = (secp256k1.journal(inp["message"], inp["q"])
                       if valid else b"")
            exit_pair = (0, 0) if valid else (0, 1)
            if rec["journal"] != journal or rec["exit"] != (
                    "Halted", exit_pair[1]):
                out["journals_wrong"] += 1
            expect = claims.receipt_claim(
                image_id, claims.system_state(0, claims.ZERO), exit_pair,
                claims.output_digest(journal))
            for name, n in self._judge_receipt(rec, image_id, journal,
                                               exit_pair, expect, ids,
                                               root).items():
                out[name] += n
        return {k: (v, 0) for k, v in out.items()}

    def _judge_receipt(self, rec, image_id, journal, exit_pair, expect, ids,
                       root):
        rv32im = circuits.rv32im()
        out = {"rejected": 0, "claims_wrong": 0}
        segs = []
        for po2, seal in rec["segments"]:
            try:
                if int(seal[0]) != self.config["seal_version"]:
                    raise stark.Rejected("seal version")
                g, got_po2 = stark.verify(seal[1:], rv32im)
                segs.append((got_po2 == po2, claims.segment_claim(g)))
            except (stark.Rejected, ValueError):
                out["rejected"] += 1
                segs.append((False, None))
        ok = bool(segs) and all(good and c for good, c in segs)
        if ok:
            cs = [c for _g, c in segs]
            ok = (claims.system_state(0, cs[0]["pre"]) == image_id
                  and all(c["input"] == claims.ZERO for c in cs)
                  and all(not c["terminated"] for c in cs[:-1])
                  and all(a["post"] == b["pre"] for a, b in zip(cs, cs[1:]))
                  and cs[-1]["terminated"] and cs[-1]["exit"] == exit_pair
                  and cs[-1]["output"] == claims.output_digest(journal))
        out["claims_wrong"] += not ok
        if rec["kind"] != self.mix["receipt_kind"] or (
                rec["kind"] == "succinct" and "seal" not in rec):
            out["claims_wrong"] += 1  # not the receipt that was asked for
        elif rec["kind"] == "succinct":
            program = (f"lift_rv32im_{rec['segments'][0][0]}"
                       if len(rec["segments"]) == 1 else "join")

            def check_code(_po2, code_root):
                if code_root != ids.get(program):
                    raise stark.Rejected(f"the code root is not {program}'s")

            try:
                g, _po2 = stark.verify(rec["seal"], circuits.recursion(),
                                       check_code)
                got_root, digest = claims.recursion_output(g)
                out["claims_wrong"] += got_root != root or digest != expect
            except (stark.Rejected, ValueError):
                out["rejected"] += 1
        return out
