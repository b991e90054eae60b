"""Items that each prove the keccak composition guest to a succinct
receipt: a user waiting on
`ProverImpl(ProverOpts(receipt_kind="succinct")).prove(env, elf)`, which
executes, proves the segment, proves every keccak batch the guest flushed
and lifts it, merges the lifts with `union`, lifts the segment, resolves
the guest's root assumption with the union root and checks the receipt
before it returns it (risc0 prover_impl.rs:121-139).

Item k proves the guest on a start state drawn from (seed, k), as the
receipt traffic does (zkbench/traffic/receipt.py, whose timers, self-check
counter and item loop this kind reuses); the warm-up is item 0.  The judge
holds each item to the plain reference: the journal to the keccak-f chain
of the start state, every segment seal to the verifier and its claim (the
root assumption in its output), and the succinct seal to the recursion
verifier, its program to `resolve` and its claim to the session's with no
assumption left.

What holds the batches to the reference is `claims_wrong`: the root
assumption is the reference's union of the reference's batch claims, and
only a verified `resolve` seal whose claim keeps no assumption discharges
it.  `keccak_claims_wrong` adds a check of what the prover was asked: each
request's size, po2 and claim digest against the reference's, and the
claim in its lift's output words, which the judge reads from a seal it
does not verify.
"""

import os

import numpy as np

from zkbench import manifest
from zkbench.reference import circuits, claims, image, keccak, stark
from zkbench.reference import field as F

receipt = manifest.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "receipt.py"),
    "zkbench_traffic_receipt")
stream = receipt.stream

COUNTS = ("rejected", "claims_wrong", "journals_wrong", "keccak_claims_wrong",
          "unchecked")


def lift_claim(out) -> bytes:
    """The claim digest in a recursion seal's 32 output words."""
    return claims.recursion_output([F.decode(int(w)) for w in out])[1]


class Traffic(receipt.Traffic):
    def setup(self):
        self._keep_keccak_requests()
        super().setup()

    def _keep_keccak_requests(self):
        """Keep, in the current item, each keccak request the prover
        proved: its size, po2, claim digest and the output words of the
        lifted receipt's seal."""
        from risc0_tpu_torch.zkvm import recursion_driver

        inner = recursion_driver.prove_keccak_request

        def kept(request, *args, **kw):
            out = inner(request, *args, **kw)
            if self.current is not None:
                self.current.setdefault("keccak", []).append({
                    "n": len(request["input"]), "po2": int(request["po2"]),
                    "claim": bytes(request["claim_digest"]),
                    "out": np.asarray(out.seal[:32], np.uint32)})
            return out

        self._restore.append((recursion_driver, "prove_keccak_request",
                              inner))
        recursion_driver.prove_keccak_request = kept

    def judge(self, results):
        """{number: (value, limit)} over the warm-up and every item."""
        image_id = image.image_id_of_files(
            os.path.join(self.ctx.root, self.config["elf"]),
            os.path.join(self.ctx.root, self.config["kernel_elf"]))
        ids, root = claims.allowed_set()
        out = dict.fromkeys(COUNTS, 0)
        for rec in [self.warm] + list(results):
            if "error" in rec:
                out["rejected"] += 1
                continue
            for name, n in self.judge_item(rec, image_id, ids,
                                           root).items():
                out[name] += n
        return {k: (v, 0) for k, v in out.items()}

    def judge_item(self, rec, image_id, ids, root):
        """{count: n} of one item that returned a receipt."""
        inp = rec["inputs"]
        out = dict.fromkeys(COUNTS, 0)
        out["unchecked"] = int(rec["self_checks"] != 1)
        journal = inp["journal"]
        out["journals_wrong"] = int(rec["journal"] != journal
                                    or rec["exit"] != ("Halted", 0))
        got = rec.get("keccak", [])
        want = list(zip(inp["sizes"], inp["claims"]))
        out["keccak_claims_wrong"] = abs(len(got) - len(want)) + sum(
            not (g["n"] == n and g["po2"] == self.config["keccak_po2"]
                 and g["claim"] == c and lift_claim(g["out"]) == c)
            for g, (n, c) in zip(got, want))
        # the final segment claims the guest's output: its journal and
        # the root assumption, under the zero control root
        assumed = keccak.assumption(inp["root_claim"], claims.ZERO)
        rejected, ok = self._segments(rec["segments"], image_id,
                                      keccak.output_with(journal, [assumed]))
        out["rejected"] += rejected
        out["claims_wrong"] += int(not ok)
        if rec["kind"] != self.mix["receipt_kind"] or "seal" not in rec:
            out["claims_wrong"] += 1  # not the receipt that was asked for
            return out
        programs = {v: k for k, v in ids.items()}
        code = []

        def check_code(_po2, code_root):
            if code_root not in programs:
                raise stark.Rejected("the code root is not in the allowed set")
            code.append(programs[code_root])

        expect = claims.receipt_claim(
            image_id, claims.system_state(0, claims.ZERO), (0, 0),
            claims.output_digest(journal))
        try:
            g, _po2 = stark.verify(rec["seal"], circuits.recursion(),
                                   check_code)
            got_root, digest = claims.recursion_output(g)
            out["claims_wrong"] += (code != ["resolve"] or got_root != root
                                    or digest != expect)
        except (stark.Rejected, ValueError):
            out["rejected"] += 1
        return out

    def _segments(self, segments, image_id, output):
        """(seals rejected, whether the segments chain from the image ID to
        a halt with exit code 0 and `output`)."""
        rv32im = circuits.rv32im()
        rejected, cs = 0, []
        for po2, seal in segments:
            try:
                if int(seal[0]) != self.config["seal_version"]:
                    raise stark.Rejected("seal version")
                g, got_po2 = stark.verify(seal[1:], rv32im)
                cs.append(claims.segment_claim(g) if got_po2 == po2
                          else None)
            except (stark.Rejected, ValueError):
                rejected += 1
                cs.append(None)
        ok = bool(cs) and all(cs)
        if ok:
            ok = (claims.system_state(0, cs[0]["pre"]) == image_id
                  and all(c["input"] == claims.ZERO for c in cs)
                  and all(not c["terminated"] for c in cs[:-1])
                  and all(a["post"] == b["pre"] for a, b in zip(cs, cs[1:]))
                  and cs[-1]["terminated"] and cs[-1]["exit"] == (0, 0)
                  and cs[-1]["output"] == output)
        return rejected, ok
