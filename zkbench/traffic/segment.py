"""Items that each prove one segment: the job of a prover worker.

Set-up executes the configuration's guest into a session (its loop count
drawn from the seed) and keeps its first `segments` segments of
2^segment_po2 rows.  Item k proves segment k mod `segments` with
`prove_segment`, its witness challenge `rand_z` drawn from (seed, k); the
warm-up is item 0, the window's items are 1, 2, ...  The judge verifies
every seal with the plain verifier and holds its claim to the inputs:
po2, rand_z, no input and no PoVW nonce, a split and no halt, the first
segment's pre-state the image ID that the reference builds from the
configuration's ELF files, and each segment's pre-state the post-state of
the segment before it.
"""

import os
import time

import numpy as np

from zkbench.reference import circuits, claims, image, stark

P = 15 * (1 << 27) + 1


def stream(seed: int, *key) -> np.random.Generator:
    """The generator of one use of the seed: (0,) the session, (1, k) item
    k."""
    return np.random.default_rng([seed % 2**64, *key])


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.config
        self.mix = ctx.mix
        self.sync = lambda: None

    def perf_module(self):
        from risc0_tpu_torch import perf

        return perf

    def setup(self):
        from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl

        guest = self.ctx.cell.guest_module()
        count = guest.loop_count(self.config, self.mix,
                                 stream(self.ctx.seed, 0))
        env = ExecutorEnv(segment_po2=self.config["segment_po2"]).write_slice(
            guest.stdin(count))
        session = ExecutorImpl(env, guest.elf(self.ctx.root,
                                              self.config)).run()
        po2 = self.config["segment_po2"]
        whole = [s for s in session.segments if s.po2 == po2]
        if len(whole) < self.mix["segments"]:
            raise RuntimeError(f"the session has {len(whole)} segments of "
                               f"po2 {po2}, the mix asks for "
                               f"{self.mix['segments']}")
        self.segments = whole[:self.mix["segments"]]
        self.warm = self._prove(0)

    def install_timers(self, sync):
        """Each item is one timed call: its wall time ends in `sync`."""
        self.sync = sync

    def _prove(self, k):
        from risc0_tpu_torch import perf
        from risc0_tpu_torch.circuit.rv32im.prove import prove_segment

        idx = k % len(self.segments)
        seg = self.segments[idx]
        rand_z = tuple(int(x) for x in stream(self.ctx.seed, 1, k)
                       .integers(0, P, 4))
        rec = {"k": k, "segment": idx, "rand_z": rand_z,
               "cycles": 1 << seg.po2}
        perf.reset()
        t0 = time.perf_counter()
        try:
            rec["seal"] = np.asarray(prove_segment(
                seg, rand_z=rand_z, device=self.ctx.device), np.uint32)
        except Exception as e:  # an item that fails is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"
        self.sync()
        rec["s"] = time.perf_counter() - t0
        rec["scopes"] = perf.report()
        return rec

    def item(self, i):
        return self._prove(i + 1)

    def end_to_end(self, results, window_s):
        return {"prove_cycles_per_s":
                sum(r["cycles"] for r in results) / window_s}

    def free(self):
        self.segments = None

    def judge(self, results):
        """{number: (value, limit)} over the warm-up and every item."""
        rv32im = circuits.rv32im()
        image_id = image.image_id_of_files(
            os.path.join(self.ctx.root, self.config["elf"]),
            os.path.join(self.ctx.root, self.config["kernel_elf"]))
        rejected = wrong = 0
        prev = None
        for rec in [self.warm] + list(results):
            if "seal" not in rec:
                rejected += 1
                prev = None
                continue
            seal = rec["seal"]
            try:
                if int(seal[0]) != self.config["seal_version"]:
                    raise stark.Rejected("seal version")
                g, po2 = stark.verify(seal[1:], rv32im)
            except stark.Rejected:
                rejected += 1
                prev = None
                continue
            c = claims.segment_claim(g)
            ok = (po2 == self.config["segment_po2"]
                  and c["rng"] == rec["rand_z"]
                  and c["input"] == claims.ZERO
                  and not any(c["povw_nonce"])
                  and not c["terminated"] and c["exit"] == (2, 0))
            if rec["segment"] == 0:
                ok &= claims.system_state(0, c["pre"]) == image_id
            elif prev is not None and prev[0] == rec["segment"] - 1:
                ok &= c["pre"] == prev[1]
            wrong += not ok
            prev = (rec["segment"], c["post"])
        return {"rejected": (rejected, 0), "claims_wrong": (wrong, 0)}
