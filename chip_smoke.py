#!/usr/bin/env python3
"""Smoke run of risc0_tpu_torch on one CUDA card: python3 chip_smoke.py

Phases, one printed line or block each; any failure raises and exits
non-zero:

  1. device  - the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   - nvcc builds the kernels from risc0_tpu_torch/csrc
  3. kernels - every CUDA kernel against its plain torch version on the same
               CUDA inputs at every shape the prove gives it, bit for bit
               (torch.equal), with the kernel's time (CUDA events, warm,
               mean of TIMED_REPS), the plain version's, and the bound:
               the larger of the bytes over 3.35 TB/s and the 32-bit
               multiplies (3 per Montgomery product) over 132 SMs x 64 a
               clock x 1.98 GHz.  The pair kernel runs as the Merkle fold
               of each tree of the prove and as one layer; both Poseidon2
               kernels also meet words at the edges of their lazy bounds
  4. check   - the fib seal at po2 6 proved on the card must equal the JAX
               package's seal (tests/data/fib_seal_po2_6_seed_0.npy)
  5. witgen  - on the loop guest's po2 20 segment, the host C++ witgens
               against the device ones, bit for bit: exec (data, global,
               both lookup tables) and, with a fixed mix, accum (decoded);
               each side's time (the device side synchronised), the device
               side's peak memory and the accum's kernel launches
               (torch.profiler, a second run)
  6. prove   - the main path: that segment proved on the card (device
               accum witgen), verified by the port's verifier, a
               corrupted seal rejected; prove time, cycles/s, the stage
               table (device times: every top-level scope synchronises
               the card), peak device memory and each kernel's launch
               count (every count must be > 0); then proved once more
               with the exec witgen on the device, whose seal must be the
               same bytes and verify
  7. recursion - the control IDs of keccak_lift_14 (the official digest),
               lift_rv32im_20 and join committed on the card; phase 6's
               seal lifted with lift_rv32im_20 into a verified succinct
               receipt of the seal's claim, a flipped word rejected; a
               two-segment loop session at segment po2 16 (the executor
               sizes the last segment down to po2 15) proved on the card and
               compressed (two lifts and a join) into one verified
               succinct receipt of the session's claim.  For each
               recursion prove: wall time, seal words and SHA-256, the
               stage table and peak device memory; each kernel's launch
               count over the lift and the compress (every count > 0)
  8. composition - the user's path: ProverImpl(succinct).prove of a guest
               (keccak_guest.py) that permutes a keccak state 655 times
               (a full batch at po2 17) and 3 more, flushing a batch
               after each run, assumes the union root of the two batch
               claims (sys_verify_integrity2) and halts with a journal:
               two keccak proves at po2 17, each verified on the host and
               lifted with keccak_lift_17, their union, the po2 17
               segment's prove and lift, and the resolve.  Per prove:
               wall time, stage table, peak device memory, seal words and
               SHA-256.  The receipt must pass Receipt.verify(image_id)
               with the session's claim and no assumption left, the union
               root's claim must be the guest's, and a flipped seal word
               must be rejected; each kernel's launch count over the
               prove (every count > 0).  Then the po2 14 keccak seal of
               the golden keccak lift's inputs, which must equal the JAX
               package's (tests/data/keccak_seal_po2_14.npy)

  9. snark   - stark-to-snark: identity_p254 of phase 7's lift_rv32im_20
               receipt on the card, one po2 18 recursion prove under the
               Poseidon254 suite at full width (its Merkle trees hashed on
               the host and their layers uploaded to the card, under their
               own scopes); wall time, stage table,
               the host Poseidon254 share, peak device memory, seal words
               and SHA-256.  The p254 receipt must carry the inner claim,
               pass verify_integrity under poseidon254 (the singleton
               identity_p254 root, the Poseidon2 root as inner root) and
               reject a flipped word; both NTT kernels must have run in
               it, and no Poseidon2 kernel.  Then its seal_to_json
               witness (size, SHA-256); the port's Groth16 verifier on the
               golden Groth16 receipt and the reference proof.json, each
               also rejected with a public input changed; and a small
               Groth16 setup, prove and verify on the host.  The full
               Groth16 wrap is scripts/torch_groth16_wrap.py

 10. povw    - proof of verifiable work: ProverImpl(succinct).prove of a
               two-segment loop session at segment po2 16 (the last
               segment po2 15) with a PoVW job id: lift_rv32im_povw_16,
               lift_rv32im_povw_15 and join_unwrap_povw on the card; each
               segment seal's Work must be its job nonce, the receipt must
               pass Receipt.verify(image_id) with a flipped seal word
               rejected, and ProveInfo.work must be session_work.  Then
               lift_povw of a one-segment po2 14 session of the next job
               (its claim WorkClaim(decode_claim, decode_work), verified)
               and WorkLogUpdateProver.prove_update of it through the
               log-builder guest proved with ProverImpl(succinct): the
               guest's segment, its lift and the resolve of the work
               receipt; the journal receipt must pass Receipt.verify of
               the guest's image ID and its journal equal the host's
               transition.  Per prove: wall time, seal words and SHA-256,
               stage table, peak device memory; each kernel's launch count
               over both (every count > 0).  Then the control IDs of
               join_povw, unwrap_povw, resolve_povw and
               resolve_unwrap_povw committed on the card

 11. orchestration - the host layers: `python -m risc0_tpu_torch.cli id`
               of the loop guest (== ExecutorImpl.compute_image_id) and
               `prove --po2 16 --receipt-kind composite` on the card (its
               claim_digest == session_claim of the same session), each a
               subprocess; then a cluster from a TOML config
               (launch_cluster: one executor, one preflight worker, two
               card workers as threads of this process, all running
               ProverImpl(succinct)) runs ProofJob(split_preflight=True)
               over phase 7's two-segment session: the receipt must pass
               Receipt.verify(image_id) with the session's claim and a
               flipped seal word must be rejected.  Each task's kind,
               worker and wall time (the telemetry spans), the job's wall
               time, the most card tasks running at once, peak device
               memory and each kernel's launches (every count > 0).  Last,
               a fresh process whose make_local_pools (two card workers)
               proves that session composite with no retries: both
               segment proves start together, so the first use of the
               kernel library and the witgen caches is concurrent; every
               task must succeed and the receipt verify
 12. predicates - the port's generators on the card: lift_rv32im_20,
               lift_rv32im_povw_16, join, union, identity and resolve
               built (the lifts' rv32im code roots committed on the card)
               and written to risc0_tpu_torch/build/predicates, each
               control ID committed on the card; every program must equal
               its vendored file word for word, every ID own_control_ids(),
               and the allowed root rebuilt from the vendored ID list the
               vendored root.  Each program's emission and commit times,
               rows and SHA-256, and each kernel's launches (every count
               > 0)
 13. sharded - one process over a list of devices (every card when there
               are several, else the card twice): commit_sharded of a
               seeded (211, 2^20) witness must equal commit_pipeline's
               coefficients, evaluations and every Merkle layer; phase 6's
               segment proved under mesh_context must give phase 6's seal
               byte for byte, verify, and reject a flipped word.  Commit
               times, the prove's wall time and peak memory of each card,
               and each kernel's launches (every count > 0)
 14. examples - the programs of risc0_tpu_torch.examples on the card: the
               ecdsa example (two po2 17 segments through the bigint2
               accelerator) and the composition example (guest B verifies
               guest A's receipt in the guest) proved for real through
               their main (RISC0_REAL_PROVE=1): each receipt must verify
               against its image ID, ecdsa's journal must be (qx, qy,
               sha256(message)), its tampered signature must halt with
               exit code 1 and a flipped seal word be rejected, and B's
               receipt must carry A's.  Each segment's preflight and prove
               time, peak device memory and each kernel's launches (every
               count > 0); then the other eleven examples through their
               main in dev mode, each asserting what its JAX counterpart
               asserts

Phase 3 also runs the plan interpreter (csrc/eval_plan.cu), the
constraint eval of one domain chunk, against its plain twin
(ir_range._run_chunk) on a chunk of T = 2^16 rows of the rv32im, recursion
and keccak plans (random taps and globals, the edge words among them),
with every register row compared; its bound is the stream's
register-file bytes (ir_range.stream_row_bytes) x T over 3.35 TB/s.
Phase 6 counts its launches: one a chunk, 64 for the po2 20 prove.
Phase 3 also holds the kernels at the recursion prove's shapes (12, 23
and 128 columns at 2^18 rows, the check group, trees of 2^20 leaves, its
FRI rounds) and at the keccak prove's (1096 columns at 2^17 rows and at
2^19 for the leaves, the commit's chunks of 32 and 8 columns, a tree of
2^19 leaves), at phase 12's one-column code roots, and at phase 13's
column blocks, row blocks and subtrees on one card.  The last two lines
are a JSON object {"kernels": [...]} (launches: phase 6's prove;
launches_recursion: phase 7's; launches_composition: phase 8's;
launches_snark: phase 9's identity_p254; launches_povw: phase 10's proves;
launches_cluster: phase 11's job; launches_predicates: phase 12's
generation; launches_sharded: phase 13's sharded commit and prove;
launches_examples: phase 14's two real proves) and
{"ok": true, "device": {...}}.
Imports nothing of jax.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PO2 = 20
TIMED_REPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit integer
# multiplies/s (132 SMs x 64 IMAD lanes x 1.98 GHz boost clock)
P = 2013265921  # BabyBear
HBM_BYTES_S = 3.35e12
MUL32_S = 132 * 64 * 1.98e9
MUL32_PER_PRODUCT = 3  # Montgomery product: a*b (lo, hi), M*low, red*P
P2_PRODUCTS = 8 * 24 * 4 + 21 * (4 + 24)  # one Poseidon2 permutation: 1356


def _bound(bytes_moved: float, products: float):
    """(bound_ms, bound_by): the least time for these bytes and products."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = products * MUL32_PER_PRODUCT / MUL32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ntt_bound(batch: int, n_bits: int, stages: int, scale: bool):
    n = 1 << n_bits
    products = batch * (n // 2) * stages + (batch * n if scale else 0)
    return _bound(2 * 4 * batch * n, products)


def _sync_ms(fn, reps: int = 1):
    """Mean ms of `reps` calls timed with CUDA events; returns (ms, out)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _words(gen, shape, dev):
    """Seeded random field words made on the card."""
    return torch.randint(0, P, shape, dtype=torch.int32, device=dev,
                         generator=gen)


def _max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_kernels(dev, kntt, kp2, ntt_mod):
    """Kernel vs plain at the prove's shapes; returns {kernel: record of its
    first (main-path) shape}.  A record holds the largest error over all
    of the kernel's shapes."""
    rng = np.random.default_rng(20)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rec = {}

    def compare(name, shape_s, kernel, plain, bound, reps=TIMED_REPS):
        kernel()  # warm-up: first launch, tables, allocator
        ms, got = _sync_ms(kernel, reps)
        plain_ms, want = _sync_ms(plain)
        if isinstance(got, list):  # the fold's layers
            got, want = torch.cat(got), torch.cat(want)
        err = _max_abs_err(got, want)
        equal = torch.equal(got, want)
        bound_ms, bound_by = bound
        print(f"kernel {name} {shape_s}: equal={equal} max_abs_err={err} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) "
              f"share={bound_ms / ms:.1%}", flush=True)
        if not equal:
            raise AssertionError(f"{name} {shape_s} differs from its plain "
                                 f"version (max abs err {err})")
        r = rec.setdefault(name, {"max_abs_err": 0, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by, "shape": shape_s})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del got, want
        torch.cuda.empty_cache()

    # hash_rows at every shape of the prove: data, accum, check and code
    # groups, the FRI rounds, the final FRI digest (prove/fri.py); then the
    # recursion prove's: data, code, accum and check groups, FRI rounds and
    # final digest; then the keccak prove's data (68 full blocks of 16 and
    # 8 words a row), check and code/accum groups; then phase 12's code
    # root of lift_rv32im_povw_16 and phase 13's row blocks on one card (a
    # mesh of the card twice: half the rows of the data, accum, code and
    # check groups)
    n22 = 1 << 22
    big = _words(gen, (211, n22), dev)
    for cols, bits in ((211, 22), (103, 22), (16, 22), (1, 22), (64, 18),
                       (64, 14), (64, 10), (1024, 0),
                       (128, 20), (23, 20), (12, 20), (16, 20), (64, 16),
                       (64, 12), (64, 8), (256, 0),
                       (1096, 19), (16, 19), (1, 19),
                       (1, 18), (211, 21), (103, 21), (16, 21), (1, 21)):
        m = big[:cols] if bits == 22 else _words(gen, (cols, 1 << bits), dev)
        perms = (1 << bits) * max(1, -(-cols // 16))
        compare("hash_rows", f"({cols}, 2^{bits})", lambda: kp2.hash_rows(m),
                lambda: kp2.hash_rows_plain(m),
                _bound(4 * (cols + 8) * (1 << bits), perms * P2_PRODUCTS),
                TIMED_REPS if bits >= 18 else 20)
        del m
    del big
    # the Merkle fold above the leaves of each tree of the prove, of the
    # recursion prove and of the keccak prove (2^19 leaves), and phase 13's
    # subtrees of 2^21 leaves and its top fold of 2: 2^n - 1 compressions,
    # the leaves read once and every layer written once
    for bits in (22, 18, 14, 10, 20, 16, 12, 8, 19, 21, 1):
        leaves = _words(gen, (1 << bits, 8), dev)
        compare("hash_pairs", f"fold 2^{bits} leaves",
                lambda: kp2.merkle_fold(leaves),
                lambda: kp2.merkle_fold_plain(leaves),
                _bound(32 * ((1 << bits) + (1 << bits) - 1),
                       ((1 << bits) - 1) * P2_PRODUCTS),
                TIMED_REPS if bits >= 18 else 20)
        del leaves
    # one layer of the pair kernel: hash_pairs(left, right)
    layer = _words(gen, (n22, 8), dev)
    left, right = layer[0::2], layer[1::2]
    compare("hash_pairs", "(2^21, 8)", lambda: kp2.hash_pairs(left, right),
            lambda: kp2.hash_pairs_plain(left, right),
            _bound(4 * 3 * 8 * (n22 // 2), (n22 // 2) * P2_PRODUCTS))
    del layer, left, right
    # words at the edges of the kernels' lazy bounds: all 0, all P - 1, and
    # those mixed with 1, P - 2 and the Montgomery one
    edge = np.array([0, 1, P - 1, P - 2, (1 << 32) % P], np.uint32)
    for label, fill in (("all 0", 0), ("all P-1", P - 1), ("mixed", None)):
        words = (np.full((64, 1 << 12), fill, np.uint32) if fill is not None
                 else rng.choice(edge, (64, 1 << 12)))
        m = torch.from_numpy(words.view(np.int32)).to(dev)
        leaves = m.reshape(-1, 8)[: 1 << 12]
        for name, kernel, plain in (
                ("hash_rows", kp2.hash_rows(m), kp2.hash_rows_plain(m)),
                ("hash_pairs", torch.cat(kp2.merkle_fold(leaves)),
                 torch.cat(kp2.merkle_fold_plain(leaves)))):
            equal = torch.equal(kernel, plain)
            print(f"kernel {name} edge words {label}: equal={equal}",
                  flush=True)
            if not equal:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"on edge words ({label})")

    # evaluate: the commit LDEs (data chunks of 32, accum 103, one data
    # group at once), 2^23 and 2^24, and an expand at or above k1; then the
    # recursion prove's LDEs (data, code, accum, check) and FRI rounds; then
    # the keccak prove's: its data group at once, the chunks of 32 and 8
    # columns its commit runs, the check group, and code/accum; then phase
    # 12's code roots (one column at 2^20 and 2^16) and phase 13's column
    # blocks on one card (data: 106 columns, in chunks of 32 and 10;
    # accum: 52; code: 1; check: 8)
    k1_22 = kntt.split(22)[0]
    cases = [(211, 20, 2), (32, 20, 2), (103, 20, 2), (2, 21, 2), (2, 22, 2),
             (2, 22 - k1_22 - 1, k1_22 + 1),
             (128, 18, 2), (23, 18, 2), (12, 18, 2), (16, 18, 2),
             (4, 18, 2), (4, 14, 2), (4, 10, 2),
             (1096, 17, 2), (32, 17, 2), (8, 17, 2), (16, 17, 2), (1, 17, 2),
             (1, 20, 2), (1, 16, 2), (10, 20, 2), (52, 20, 2), (8, 20, 2)]
    for rows, c_bits, eb in cases:
        c = _words(gen, (rows, 1 << c_bits), dev)
        x = ntt_mod.expand(c, eb)
        del c
        n_bits = c_bits + eb
        shape_s = (f"expand(({rows}, 2^{c_bits}), {eb})" if eb == 2 else
                   f"({rows}, 2^{n_bits}) expand_bits {eb}")
        compare("evaluate_ntt", shape_s, lambda: kntt.evaluate_ntt(x, eb),
                lambda: kntt.evaluate_ntt_plain(x, eb),
                _ntt_bound(rows, n_bits, n_bits - eb, False))
        del x
    # interpolate: the commit iNTTs, the check poly, 2^23 and 2^24; then
    # the recursion prove's commits and check poly; then the keccak
    # prove's: its data group at once, its chunks of 32 and 8 columns, the
    # check poly, and code/accum; then phase 12's code roots and phase
    # 13's column blocks on one card
    for rows, n_bits in ((211, 20), (32, 20), (103, 20), (4, 22), (2, 23),
                         (2, 24), (128, 18), (23, 18), (12, 18), (4, 20),
                         (1096, 17), (32, 17), (8, 17), (4, 19), (1, 17),
                         (1, 20), (1, 16), (10, 20), (52, 20)):
        x = _words(gen, (rows, 1 << n_bits), dev)
        compare("interpolate_ntt", f"({rows}, 2^{n_bits})",
                lambda: kntt.interpolate_ntt(x),
                lambda: kntt.interpolate_ntt_plain(x),
                _ntt_bound(rows, n_bits, n_bits, True))
        del x
    return rec


def phase_eval_plan(dev):
    """The plan interpreter against ir_range._run_chunk on one chunk of
    T = 2^16 rows of each circuit's plan; returns a record per circuit."""
    from risc0_tpu_torch.circuit import ir_range
    from risc0_tpu_torch.circuit.keccak.circuit import load_circuit as kc
    from risc0_tpu_torch.circuit.recursion.circuit import \
        load_prover_circuit
    from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit as rv
    from risc0_tpu_torch.hal.cuda import eval_plan as keval

    T = 1 << 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    edge = torch.tensor([0, 1, P - 1], dtype=torch.int32, device=dev)
    recs = []
    for name, load in (("rv32im", rv), ("recursion", load_prover_circuit),
                       ("keccak", kc)):
        plan = ir_range._range_plan(load())
        dplan = ir_range._DevicePlan(plan, dev)
        nc, nt, ng = (len(plan.const_vals), len(plan.tap_specs),
                      len(plan.global_specs))
        fp = torch.zeros((plan.fp_rows, T), dtype=torch.int32, device=dev)
        fp[:nc] = torch.from_numpy(plan.const_vals.view(np.int32)).to(
            dev)[:, None]
        fp[nc:nc + nt] = _words(gen, (nt, T), dev)
        fp[nc:nc + nt, :3] = edge
        glob = _words(gen, (ng, 1), dev)
        glob[:3] = edge[:min(3, ng), None]
        fp[nc + nt:nc + nt + ng] = glob
        ext = torch.zeros((plan.ext_rows, T, 4), dtype=torch.int32,
                          device=dev)
        ext[:len(plan.econst_vals)] = torch.from_numpy(
            plan.econst_vals.view(np.int32)).to(dev)[:, None, :]
        pm = _words(gen, (max(dplan.ops_head[2], 3), 4), dev)
        pm[:3] = edge[:, None]
        pf, pe = fp.clone(), ext.clone()

        def kernel():
            keval.eval_plan(dplan.ops, dplan.ops_head, fp, ext, pm)

        kernel()  # warm-up
        ms, _ = _sync_ms(kernel, TIMED_REPS)
        plain_ms, _ = _sync_ms(lambda: ir_range._run_chunk(dplan, pf, pe,
                                                           pm, T))
        equal = torch.equal(fp, pf) and torch.equal(ext, pe)
        read, written = ir_range.stream_row_bytes(
            ir_range.encode_plan(plan))
        bound_ms = (read + written) * T / HBM_BYTES_S * 1e3
        shape_s = (f"{name} chunk (fp {plan.fp_rows}, ext {plan.ext_rows}, "
                   f"T 2^16)")
        print(f"kernel eval_plan {shape_s}: equal={equal} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.5f} (bytes: {read} read + {written} "
              f"written a row) share={bound_ms / ms:.1%}", flush=True)
        if not equal:
            raise AssertionError(f"eval_plan differs from _run_chunk on "
                                 f"the {name} plan")
        recs.append({"name": "eval_plan", "route": "cuda",
                     "source": "risc0_tpu_torch/csrc/eval_plan.cu",
                     "replaces": None, "max_abs_err": 0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None,
                     "shape": shape_s})
        del fp, ext, pf, pe, dplan
        torch.cuda.empty_cache()
    return recs


def phase_check(dev):
    """The fib seal on the card equals the JAX package's seal."""
    from risc0_tpu_torch.circuit import fib

    want = np.load(os.path.join(ROOT, "tests", "data",
                                "fib_seal_po2_6_seed_0.npy"))
    t0 = time.perf_counter()
    got = fib.prove(po2=6, seed=0, device=dev)
    fib.verify(got, device=dev)
    same = np.array_equal(got, want)
    print(f"check fib po2 6 seal == JAX seal: {same} "
          f"({len(got)} words, {time.perf_counter() - t0:.2f} s)", flush=True)
    if not same:
        raise AssertionError("fib seal on the card differs from the JAX seal")


def _wall_s(fn):
    """(seconds, result) of fn, ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _device_launches(fn) -> int:
    """Kernels that one run of fn launches, from torch.profiler (device
    copies and sets are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw kineto events: prof.events() would build a Python event tree
    # of every launch first, minutes for the exec witgen's
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name().lower()
               and "memset" not in e.name().lower())


def phase_witgen(dev, seg):
    """Host C++ against device witgens on the prove's segment."""
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch import field as F
    from risc0_tpu_torch.circuit.rv32im import witgen
    from risc0_tpu_torch.circuit.rv32im.accum_device import \
        witgen_accum_device
    from risc0_tpu_torch.circuit.rv32im.exec_device import \
        witgen_exec_device
    from risc0_tpu_torch.convert import to_numpy

    rz = loop_guest.RAND_Z
    mix = np.random.default_rng(7).integers(0, P, 36).astype(np.uint32)
    host_s, host = _wall_s(lambda: witgen.witgen_exec(seg, rand_z=rz))
    torch.cuda.reset_peak_memory_stats()
    dev_s, res = _wall_s(lambda: witgen_exec_device(seg, rand_z=rz,
                                                    device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = {"data": np.array_equal(to_numpy(res["data"]), host["data"])}
    for key in ("global", "tables_u8", "tables_u16"):
        same[key] = np.array_equal(res[key], host[key])
    # the device exec's launches are not counted: a profiled run of it
    # takes about a minute of the time limit (PERF.md has its count)
    print(f"witgen exec: host C++ {host_s:.3f} s; device {dev_s:.3f} s, "
          f"peak {peak:.2f} GiB; equal {json.dumps(same)}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"device exec witgen differs: {same}")

    host_s, want = _wall_s(lambda: witgen.witgen_accum(host, mix))
    # the device accum reads the device exec's data where it lies
    torch.cuda.reset_peak_memory_stats()
    dev_s, got = _wall_s(lambda: witgen_accum_device(res, mix, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = np.array_equal(F.decode_np(to_numpy(got)), want)
    del got
    launches = _device_launches(lambda: witgen_accum_device(res, mix,
                                                            device=dev))
    print(f"witgen accum: host C++ {host_s:.3f} s; device {dev_s:.3f} s, "
          f"peak {peak:.2f} GiB (the exec's data resident), {launches} "
          f"kernel launches; equal {same}", flush=True)
    if not same:
        raise AssertionError("device accum witgen differs from the host's")
    del res
    torch.cuda.empty_cache()


def phase_prove(dev, seg, counters):
    from risc0_tpu_torch import loop_guest, perf
    from risc0_tpu_torch.circuit.rv32im.prove import (EVAL_CHUNK,
                                                      prove_segment)
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.hal.cuda import eval_plan as keval
    from risc0_tpu_torch.verify.verifier import VerificationError

    for fn in counters + [keval.eval_plan]:
        fn.launches = 0
    perf.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seal = prove_segment(seg, rand_z=loop_guest.RAND_Z, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    eval_launches = keval.eval_plan.launches
    peak = torch.cuda.max_memory_allocated()
    stages = perf.report()

    t0 = time.perf_counter()
    out = verify_rv32im_seal(seal)
    verify_s = time.perf_counter() - t0
    if len(out) != 90:
        raise AssertionError(f"verifier returned {len(out)} globals")
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    try:
        verify_rv32im_seal(bad)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted seal was accepted")

    cycles = 1 << seg.po2
    print(f"prove: po2 {seg.po2}, {cycles} cycles in {prove_s:.3f} s = "
          f"{cycles / prove_s:.1f} cycles/s; seal {len(seal)} words, "
          f"SHA-256 {hashlib.sha256(seal.tobytes()).hexdigest()}", flush=True)
    print(f"prove: verified in {verify_s:.2f} s; corrupted seal rejected "
          f"({rejected})", flush=True)
    print(f"prove: peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print("prove: stage table (s, calls; each top-level scope ends in a "
          "device sync)", flush=True)
    for path, (calls, secs) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        if "." not in path or path.startswith("commit_group."):
            print(f"  {secs:9.3f}  x{calls:<3d} {path}", flush=True)
    print(f"prove: launches {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    chunks = (4 << seg.po2) // EVAL_CHUNK
    print(f"prove: eval_plan launches {eval_launches} (one a chunk of "
          f"{EVAL_CHUNK} domain rows: {chunks})", flush=True)
    if eval_launches != chunks:
        raise AssertionError(f"eval_plan launched {eval_launches} times, "
                             f"not once a chunk ({chunks})")
    launches["eval_plan"] = eval_launches

    perf.reset()
    exec_s, seal2 = _wall_s(lambda: prove_segment(
        seg, rand_z=loop_guest.RAND_Z, device=dev, exec="device"))
    same = np.array_equal(seal2, seal)
    verify_rv32im_seal(seal2)
    stages = perf.report()
    print(f"prove (exec on the device): {exec_s:.3f} s, witgen_exec "
          f"{stages['witgen_exec'][1]:.3f} s, witgen_accum "
          f"{stages['witgen_accum'][1]:.3f} s; seal verified, same bytes "
          f"as the main path's: {same}", flush=True)
    if not same:
        raise AssertionError("the device-exec seal differs from the main "
                             "path's")
    return launches, seal


KECCAK_LIFT_14_ID = ("92631f2b8dc9431cb2abdc1e82ac2e30"
                     "deaf086a36e51e4aa60ad0516bf5b748")
REC_SESSION_PO2 = 16
REC_STAGES = ("rec_preflight", "rec_witgen", "commit_group.1",
              "commit_group.2", "rec_accum", "commit_group.0", "eval_check",
              "check_commit", "tap_eval", "combos", "fri_prove")


def _watch(module, name, log, counters=()):
    """Record each call of module.name (a shim that only observes): its
    wall time (ended by a device sync), stage table, peak device memory,
    the launches of each of `counters` and the result."""
    from risc0_tpu_torch import perf

    inner = getattr(module, name)

    def timed(*args, **kw):
        perf.reset()
        torch.cuda.reset_peak_memory_stats()
        before = [fn.launches for fn in counters]
        secs, out = _wall_s(lambda: inner(*args, **kw))
        log.append({"s": secs, "out": out, "stages": perf.report(),
                    "peak": torch.cuda.max_memory_allocated(),
                    "launches": {fn.__name__: fn.launches - b
                                 for fn, b in zip(counters, before)}})
        return out

    timed.__wrapped__ = inner
    setattr(module, name, timed)


def _unwatch(module, name):
    """Put back what _watch wrapped, if it did."""
    fn = getattr(module, name)
    setattr(module, name, getattr(fn, "__wrapped__", fn))


def _print_recursion_prove(name, rec):
    seal = np.asarray(rec["out"][0], np.uint32)
    print(f"recursion {name}: {rec['s']:.3f} s, seal {len(seal)} words, "
          f"SHA-256 {hashlib.sha256(seal.tobytes()).hexdigest()}, peak "
          f"device memory {rec['peak'] / 2**30:.2f} GiB; stages (s, calls): "
          + ", ".join(f"{k} {rec['stages'][k][1]:.3f} x{rec['stages'][k][0]}"
                      for k in REC_STAGES if k in rec["stages"]), flush=True)


def phase_recursion(dev, seal20, counters, log):
    """Control IDs on the card; lift the po2 20 seal; compress a
    two-segment session.  `log` fills with each recursion prove
    (a _watch log of prove_program).  Returns {kernel: launches over the lift
    and the compress}."""
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch.circuit.recursion.predicates import (
        load_own_program, own_control_ids)
    from risc0_tpu_torch.circuit.recursion.prove import load_keccak_lift
    from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.zkvm.receipt import (CompositeReceipt,
                                              SegmentReceipt,
                                              VerificationError,
                                              VerifierContext, session_claim)
    from risc0_tpu_torch.zkvm.recursion_driver import (compress_composite,
                                                       lift)

    ids, root = own_control_ids()
    t0 = time.perf_counter()
    got = load_keccak_lift(14).control_id(dev)
    same = got.tobytes().hex() == KECCAK_LIFT_14_ID
    print(f"recursion: keccak_lift_14 control ID {got.tobytes().hex()} == "
          f"official: {same}", flush=True)
    if not same:
        raise AssertionError("keccak_lift_14 control ID differs from the "
                             "official digest")
    for name in ("lift_rv32im_20", "join"):
        same = np.array_equal(load_own_program(name).control_id(dev),
                              ids[name])
        print(f"recursion: {name} control ID == own_control_ids(): {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{name} control ID differs")
    print(f"recursion: control IDs in {time.perf_counter() - t0:.2f} s",
          flush=True)

    ctx = VerifierContext(control_root=root)
    rng = np.random.default_rng(7)
    for fn in counters:
        fn.launches = 0
    sr = SegmentReceipt(seal=seal20, index=0, hashfn="poseidon2",
                        claim=decode_claim(seal20))
    lifted = lift(sr, device=dev, rng=rng)
    launches = {fn.__name__: fn.launches for fn in counters}
    _print_recursion_prove("lift_rv32im_20", log[-1])
    t0 = time.perf_counter()
    lifted.verify_integrity(ctx)
    verify_s = time.perf_counter() - t0
    if not np.array_equal(lifted.claim.digest(), decode_claim(seal20).digest()):
        raise AssertionError("lifted claim != the segment seal's claim")
    bad = np.array(lifted.seal)
    bad[len(bad) // 2] ^= 1
    try:
        dataclasses.replace(lifted, seal=bad).verify_integrity(ctx)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted succinct receipt was accepted")
    print(f"recursion: lifted receipt verified in {verify_s:.2f} s, claim == "
          f"decode_claim(seal); flipped word rejected ({rejected})",
          flush=True)

    t0 = time.perf_counter()
    session = loop_guest.session(REC_SESSION_PO2, 2)
    segs = session.segments
    po2s = [s.po2 for s in segs]
    print(f"recursion: executed a {len(segs)}-segment loop session at "
          f"segment po2 {REC_SESSION_PO2}: segments of po2 {po2s} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if len(segs) != 2 or po2s[0] != REC_SESSION_PO2:
        raise AssertionError(f"the session's segments are of po2 {po2s}")
    receipts = []
    for i, seg in enumerate(segs):
        secs, seal = _wall_s(lambda: prove_segment(
            seg, rand_z=loop_guest.RAND_Z, device=dev))
        receipts.append(SegmentReceipt(seal=seal, index=i, hashfn="poseidon2",
                                       claim=decode_claim(seal)))
        print(f"recursion: segment {i} proved in {secs:.3f} s", flush=True)
    before = {fn.__name__: fn.launches for fn in counters}
    n = len(log)
    secs, final = _wall_s(lambda: compress_composite(
        CompositeReceipt(segments=receipts), device=dev, rng=rng))
    for fn in counters:
        launches[fn.__name__] += fn.launches - before[fn.__name__]
    names = [f"lift_rv32im_{p} (segment {i})" for i, p in enumerate(po2s)]
    for name, rec in zip(names + ["join"], log[n:]):
        _print_recursion_prove(name, rec)
    t0 = time.perf_counter()
    final.verify_integrity(ctx)
    want = session_claim(session).digest()
    same = np.array_equal(final.claim.digest(), want)
    print(f"recursion: compress_composite {secs:.3f} s ({len(log) - n} "
          f"proves); final receipt verified in "
          f"{time.perf_counter() - t0:.2f} s; claim == "
          f"session_claim(session): {same}", flush=True)
    if not same:
        raise AssertionError("the final claim differs from the session's")
    print(f"recursion: launches {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the recursion "
                             f"proves: {missing}")
    return launches, lifted

KECCAK_BATCHES = (655, 3)  # the first batch full: (1 << 17) // 200 states


def _fixture_keccak_inputs():
    """The keccak states of the golden keccak lift's fixture
    (scripts/gen_keccak_seal.py inputs())."""
    rng = np.random.default_rng(14)
    return [[int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
            for _ in range(2)]


def _stage_line(stages):
    """The top-level scopes and the group commits, in the order run."""
    return ", ".join(f"{k} {secs:.3f} x{calls}"
                     for k, (calls, secs) in stages.items()
                     if "." not in k or k.startswith("commit_group."))


def phase_composition(dev, counters, rec_log):
    """The keccak coprocessor and receipt composition through the user's
    entry point: ProverImpl(succinct).prove of a guest that flushes two
    keccak batches at po2 17 and assumes their union root.  Returns
    {kernel: launches over the prove}."""
    from risc0_tpu_torch import keccak_guest
    from risc0_tpu_torch.circuit.keccak import KECCAK_DEFAULT_PO2
    from risc0_tpu_torch.circuit.keccak import prove as kprove
    from risc0_tpu_torch.circuit.keccak import verify as kverify
    from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids
    from risc0_tpu_torch.circuit.rv32im import prove as rv_prove
    from risc0_tpu_torch.zkvm import recursion_driver as drv
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import (VerificationError,
                                              VerifierContext,
                                              keccak_root_claim,
                                              session_claim)

    t0 = time.perf_counter()
    elf, inputs, root_claim = keccak_guest.build(KECCAK_BATCHES)
    env = ExecutorEnv(keccak_max_po2=KECCAK_DEFAULT_PO2)
    image_id = ExecutorImpl(env, elf).compute_image_id()
    print(f"composition: built the keccak guest ({KECCAK_BATCHES[0]} + "
          f"{KECCAK_BATCHES[1]} permutations in two batches at po2 "
          f"{KECCAK_DEFAULT_PO2}, root claim computed on the host) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    keccak_log, verify_log, seg_log, union_log = [], [], [], []
    _watch(kprove, "prove_keccak", keccak_log, counters)
    _watch(kverify, "verify_keccak_seal", verify_log)
    _watch(rv_prove, "segment_preflight", seg_log)
    _watch(rv_prove, "prove_segment_core", seg_log)
    _watch(drv, "keccak_union_root", union_log)
    n_rec = len(rec_log)

    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs, info = _wall_s(lambda: ProverImpl(
        ProverOpts(receipt_kind="succinct"), device=dev).prove(env, elf))
    launches = {fn.__name__: fn.launches for fn in counters}
    # each watched call resets the peak: the prove's is the largest
    peak = max([torch.cuda.max_memory_allocated()]
               + [r["peak"] for r in keccak_log + seg_log + rec_log[n_rec:]])
    session = info.session
    print(f"composition: ProverImpl(succinct).prove {secs:.3f} s (the "
          f"executor, {len(keccak_log)} keccak proves, 1 segment of po2 "
          f"{session.segments[0].po2}, {len(rec_log) - n_rec} recursion "
          f"proves and the self-check), peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for i, rec in enumerate(keccak_log):
        seal = np.asarray(rec["out"], np.uint32)
        print(f"composition: keccak batch {i} ({len(inputs[i])} states) "
              f"proved at po2 {int(seal[17])} in {rec['s']:.3f} s, seal "
              f"{len(seal)} words, SHA-256 "
              f"{hashlib.sha256(seal.tobytes()).hexdigest()}, peak device "
              f"memory {rec['peak'] / 2**30:.2f} GiB, launches "
              f"{json.dumps(rec['launches'])}; stages (s, calls): "
              f"{_stage_line(rec['stages'])}", flush=True)
    for i, rec in enumerate(verify_log):
        print(f"composition: keccak seal {i} verified on the host in "
              f"{rec['s']:.3f} s", flush=True)
    pre, core = seg_log
    seal = np.asarray(core["out"], np.uint32)
    print(f"composition: segment of po2 {session.segments[0].po2}: "
          f"segment_preflight {pre['s']:.3f} s ({_stage_line(pre['stages'])})"
          f", prove_segment_core {core['s']:.3f} s, seal {len(seal)} words, "
          f"SHA-256 {hashlib.sha256(seal.tobytes()).hexdigest()}, peak "
          f"device memory {core['peak'] / 2**30:.2f} GiB; stages (s, "
          f"calls): {_stage_line(core['stages'])}", flush=True)
    names = ([f"keccak_lift_{KECCAK_DEFAULT_PO2} (batch {i})"
              for i in range(len(keccak_log))] + ["union"]
             + [f"lift_rv32im_{session.segments[0].po2}", "resolve"])
    for name, rec in zip(names, rec_log[n_rec:]):
        _print_recursion_prove(name, rec)
    if len(rec_log) - n_rec != len(names):
        raise AssertionError(f"{len(rec_log) - n_rec} recursion proves, "
                             f"expected {len(names)}")

    succinct = info.receipt.inner.value
    t0 = time.perf_counter()
    info.receipt.verify(image_id)
    verify_s = time.perf_counter() - t0
    claim = session_claim(session)
    same = np.array_equal(info.receipt.claim().digest(), claim.digest())
    left = claim.output.value.assumptions.value.items
    print(f"composition: receipt.verify(image_id) passed in {verify_s:.2f} "
          f"s; claim == session_claim(session): {same}; assumptions left "
          f"in the session claim: {len(left)}", flush=True)
    if not same or left:
        raise AssertionError("the receipt's claim is not the session's")
    union_root = union_log[0]["out"]
    root = drv.receipt_claim_digest(union_root)
    same = (np.array_equal(root, keccak_root_claim(session.pending_keccaks))
            and np.array_equal(root, root_claim))
    print(f"composition: union root claim == keccak_root_claim == the "
          f"guest's assumption: {same}", flush=True)
    if not same:
        raise AssertionError("the union root's claim is not the guest's")
    bad = np.array(succinct.seal)
    bad[len(bad) // 2] ^= 1
    try:
        dataclasses.replace(succinct, seal=bad).verify_integrity(
            VerifierContext(control_root=own_control_ids()[1]))
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted succinct receipt was accepted")
    print(f"composition: flipped seal word rejected ({rejected})",
          flush=True)
    print(f"composition: launches {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the composition: "
                             f"{missing}")

    want = np.load(os.path.join(ROOT, "tests", "data",
                                "keccak_seal_po2_14.npy"))
    secs, got = _wall_s(lambda: kprove.prove_keccak(
        _fixture_keccak_inputs(), 14, device=dev))
    same = np.array_equal(got, want)
    print(f"composition: po2 14 keccak seal == JAX seal "
          f"(tests/data/keccak_seal_po2_14.npy): {same} ({secs:.3f} s)",
          flush=True)
    if not same:
        raise AssertionError("the po2 14 keccak seal differs from the JAX "
                             "seal")
    return launches


P254_SCOPES = ("poseidon254_readback", "poseidon254_leaves",
               "poseidon254_folds", "poseidon254_upload")


def _scope_sums(stages, names):
    """{name: seconds} summed over every dotted path that ends in name."""
    return {n: sum(secs for path, (_c, secs) in stages.items()
                   if path.split(".")[-1] == n) for n in names}


def _golden_groth16():
    from risc0_tpu_torch.groth16 import native as nat
    from risc0_tpu_torch.groth16.verifier import VerifyingKey

    z = np.load(os.path.join(ROOT, "tests", "data",
                             "groth16_receipt_golden.npz"))
    vk = VerifyingKey(
        alpha_g1=nat.g1_from_arr(z["vk_alpha_g1"])[0],
        beta_g2=nat.g2_from_arr(z["vk_beta_g2"])[0],
        gamma_g2=nat.g2_from_arr(z["vk_gamma_g2"])[0],
        delta_g2=nat.g2_from_arr(z["vk_delta_g2"])[0],
        ic=nat.g1_from_arr(z["vk_ic"]))
    return z, vk


def phase_snark(dev, lifted, counters, log):
    """Stark-to-snark: identity_p254 of phase 7's lift on the card, the
    p254 receipt checked and its witness JSON made; the port's Groth16
    verifier on the golden receipts; a small Groth16 round trip on the
    host.  Returns {kernel: launches over identity_p254}."""
    from risc0_tpu_torch.circuit.recursion.predicates import (
        identity_p254_control_id, own_control_ids)
    from risc0_tpu_torch.circuit.recursion.prove import MerkleGroup
    from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
    from risc0_tpu_torch.groth16 import prove as GP
    from risc0_tpu_torch.groth16.r1cs import CS
    from risc0_tpu_torch.groth16.seal_to_json import to_json
    from risc0_tpu_torch.groth16.verifier import (Verifier,
                                                  proof_json_to_seal)
    from risc0_tpu_torch.hash.suite import POSEIDON254
    from risc0_tpu_torch.zkvm.receipt import (Groth16Receipt,
                                              Groth16ReceiptVerifierParameters,
                                              VerificationError,
                                              VerifierContext)
    from risc0_tpu_torch.zkvm.recursion_driver import (identity_p254,
                                                       receipt_claim_digest)

    for fn in counters:
        fn.launches = 0
    n = len(log)
    secs, p254 = _wall_s(lambda: identity_p254(
        lifted, device=dev, rng=np.random.default_rng(11)))
    launches = {fn.__name__: fn.launches for fn in counters}
    (rec,) = log[n:]
    seal = np.asarray(p254.seal, np.uint32)
    stages = rec["stages"]
    host = _scope_sums(stages, P254_SCOPES)
    p254_s = host["poseidon254_leaves"] + host["poseidon254_folds"]
    top = {k: v for k, v in stages.items() if "." not in k or (
        k.startswith("commit_group.") and k.count(".") == 1)}
    device_s = sum(secs_ for k, (_c, secs_) in top.items()
                   if k not in ("rec_preflight", "rec_witgen", "rec_accum"))
    print(f"snark: identity_p254 of the lift_rv32im_20 receipt: {secs:.3f} "
          f"s, seal {len(seal)} words, SHA-256 "
          f"{hashlib.sha256(seal.tobytes()).hexdigest()}, peak device "
          f"memory {rec['peak'] / 2**30:.2f} GiB", flush=True)
    print("snark: stage table (s, calls; each top-level scope ends in a "
          "device sync): " + ", ".join(
              f"{k} {v[1]:.3f} x{v[0]}" for k, v in top.items()), flush=True)
    print(f"snark: host Poseidon254 trees {p254_s:.3f} s of {secs:.3f} "
          f"({100 * p254_s / secs:.1f}%): leaves "
          f"{host['poseidon254_leaves']:.3f}, folds "
          f"{host['poseidon254_folds']:.3f}; readback of the evaluated "
          f"matrices {host['poseidon254_readback']:.3f}, upload of the "
          f"layers {host['poseidon254_upload']:.3f}; the prove's "
          f"stages past the witgen, trees and copies included, "
          f"{device_s:.3f} s", flush=True)

    _ids, root = own_control_ids()
    p254_id = identity_p254_control_id()
    ctx = VerifierContext(
        hashfn="poseidon254",
        control_root=MerkleGroup([p254_id], POSEIDON254).calc_root(),
        inner_control_root=root)
    same = (np.array_equal(p254.claim.digest(), lifted.claim.digest())
            and np.array_equal(receipt_claim_digest(p254),
                               receipt_claim_digest(lifted)))
    t0 = time.perf_counter()
    p254.verify_integrity(ctx)
    verify_s = time.perf_counter() - t0
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    try:
        dataclasses.replace(p254, seal=bad).verify_integrity(ctx)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted p254 receipt was accepted")
    print(f"snark: p254 receipt verified (poseidon254, the singleton "
          f"identity_p254 root, the Poseidon2 root as inner root) in "
          f"{verify_s:.2f} s; claim == the inner receipt's: {same}; "
          f"flipped word rejected ({rejected})", flush=True)
    if not same:
        raise AssertionError("the p254 claim differs from the inner claim")
    print(f"snark: launches over identity_p254 {json.dumps(launches)}",
          flush=True)
    missing = [k for k in ("evaluate_ntt", "interpolate_ntt")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"NTT kernels not launched by the p254 prove: "
                             f"{missing}")
    if launches["hash_rows"] or launches["hash_pairs"]:
        raise AssertionError("a Poseidon2 kernel ran in the p254 prove")

    t0 = time.perf_counter()
    witness = to_json(seal)
    print(f"snark: seal_to_json {len(witness)} bytes, SHA-256 "
          f"{hashlib.sha256(witness.encode()).hexdigest()} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    t0 = time.perf_counter()
    z, vk = _golden_groth16()
    params = Groth16ReceiptVerifierParameters.default()
    params.verifying_key = vk
    claim = decode_claim(np.load(os.path.join(ROOT, "tests", "data",
                                              "rv32im_seal_po2_14.npy")))
    golden = Groth16Receipt(seal=z["seal"].tobytes(), claim=claim,
                            verifier_parameters=z["verifier_parameters"])
    golden.verify_integrity(VerifierContext(groth16_params=params))
    bad_params = dataclasses.replace(
        params, control_root=params.control_root ^ np.uint32(1))
    try:
        golden.verify_integrity(VerifierContext(groth16_params=bad_params))
    except VerificationError:
        pass
    else:
        raise AssertionError("the golden Groth16 receipt verified with a "
                             "public input changed")
    gdir = os.path.join(ROOT, "tests", "data", "groth16")
    proof, public, vk_json = (
        json.load(open(os.path.join(gdir, f + ".json")))
        for f in ("proof", "public", "verification_key"))
    if not Verifier.from_json(proof, public, vk_json).verify():
        raise AssertionError("the reference Groth16 vectors do not verify")
    if Verifier.from_json(proof, [str(int(public[0]) + 1)],
                          vk_json).verify():
        raise AssertionError("the reference Groth16 vectors verified with "
                             "a public input changed")
    print(f"snark: golden Groth16 receipt (embedded vk) and the reference "
          f"proof.json/public.json verified, each rejected with a public "
          f"input changed ({time.perf_counter() - t0:.2f} s)", flush=True)

    def small(x_val, y_val):
        cs = CS(check=True)
        pub = cs.alloc_public()
        x, y = cs.witness(x_val), cs.witness(y_val)
        cs.bind_public(pub, (x * y + x + 7) * (x * y + x + 7) + y)
        cs.finalize()
        return cs

    t0 = time.perf_counter()
    pk, vk_small = GP.setup(small(3, 4))
    proof = GP.prove(pk, small(10, 20))
    seal_g = proof_json_to_seal(proof)
    w = [int.from_bytes(seal_g[32 * i: 32 * i + 32], "big") for i in range(8)]
    pts = ((w[0], w[1]), ((w[3], w[2]), (w[5], w[4])), (w[6], w[7]))
    ok = Verifier(*pts, [int(proof["public"][0])], vk_small).verify()
    wrong = Verifier(*pts, [int(proof["public"][0]) + 1], vk_small).verify()
    print(f"snark: small Groth16 setup/prove/verify on the host: verified "
          f"{ok}, a changed public input rejected {not wrong} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if not ok or wrong:
        raise AssertionError("the small Groth16 round trip failed")
    return launches


POVW_LOG = 0x5EED_C0FFEE  # the work log's 160-bit id
POVW_JOB = 7


def _print_segment_prove(prefix, rec):
    seal = np.asarray(rec["out"], np.uint32)
    print(f"{prefix}: segment of po2 {int(seal[91])} proved in "
          f"{rec['s']:.3f} s, seal {len(seal)} words, SHA-256 "
          f"{hashlib.sha256(seal.tobytes()).hexdigest()}, peak device "
          f"memory {rec['peak'] / 2**30:.2f} GiB; stages (s, calls): "
          f"{_stage_line(rec['stages'])}", flush=True)


def phase_povw(dev, counters, rec_log):
    """Proof of verifiable work on the card: ProverImpl's PoVW branch over
    a two-segment session, lift_povw of a one-segment session and the
    work-log update proved through the log-builder guest; then the control
    IDs of the PoVW programs not proved here.  Returns {kernel: launches
    over the two proves}."""
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch.circuit.recursion.predicates import (
        load_own_program, own_control_ids)
    from risc0_tpu_torch.circuit.rv32im import prove as rv_prove
    from risc0_tpu_torch.circuit.rv32im.claim import decode_claim, decode_work
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.povw import PovwJobId, WorkClaim, session_work
    from risc0_tpu_torch.zkvm.povw_guest import LogBuilderGuestProver
    from risc0_tpu_torch.zkvm.povw_updater import WorkLogUpdateProver
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import (SegmentReceipt,
                                              VerificationError,
                                              VerifierContext)
    from risc0_tpu_torch.zkvm.recursion_driver import lift_povw

    t_phase = time.perf_counter()
    ids, root = own_control_ids()
    ctx = VerifierContext(control_root=root)
    elf = loop_guest.elf()
    seg_log = []
    _watch(rv_prove, "prove_segment_core", seg_log)

    # (a) the PoVW branch of ProverImpl(succinct) over two segments
    job = PovwJobId(log=POVW_LOG, job=POVW_JOB)
    env = loop_guest.session_env(REC_SESSION_PO2, 2, job)
    image_id = ExecutorImpl(env, elf).compute_image_id()
    for fn in counters:
        fn.launches = 0
    n_rec = len(rec_log)
    torch.cuda.reset_peak_memory_stats()
    secs, info = _wall_s(lambda: ProverImpl(
        ProverOpts(receipt_kind="succinct"), device=dev).prove(env, elf))
    session = info.session
    po2s = [s.po2 for s in session.segments]
    peak = max([torch.cuda.max_memory_allocated()]
               + [r["peak"] for r in seg_log + rec_log[n_rec:]])
    print(f"povw: ProverImpl(succinct).prove of a {len(po2s)}-segment loop "
          f"session (segments of po2 {po2s}, job {job.job} of log "
          f"{POVW_LOG:#x}) {secs:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if po2s != [REC_SESSION_PO2, REC_SESSION_PO2 - 1]:
        raise AssertionError(f"the session's segments are of po2 {po2s}")
    for rec in seg_log:
        _print_segment_prove("povw", rec)
    names = [f"lift_rv32im_povw_{p} (segment {i})"
             for i, p in enumerate(po2s)] + ["join_unwrap_povw"]
    for name, rec in zip(names, rec_log[n_rec:]):
        _print_recursion_prove(name, rec)
    if len(rec_log) - n_rec != len(names):
        raise AssertionError(f"{len(rec_log) - n_rec} recursion proves, "
                             f"expected {len(names)}")
    works = [decode_work(rec["out"]) for rec in seg_log]
    same = [(w.nonce_min, w.nonce_max) == (job.nonce(i), job.nonce(i))
            for i, w in enumerate(works)]
    print(f"povw: decode_work of each segment seal == job.nonce(i): {same}",
          flush=True)
    if not all(same):
        raise AssertionError("a segment seal carries another nonce")
    t0 = time.perf_counter()
    info.receipt.verify(image_id)
    verify_s = time.perf_counter() - t0
    want = session_work(session, job)
    same = (info.work == want and want.nonce_min == job.nonce(0)
            and want.nonce_max == job.nonce(1)
            and want.value == (1 << 16) + (1 << 15))
    print(f"povw: receipt.verify(image_id) passed in {verify_s:.2f} s; "
          f"info.work == session_work(session, job) (nonces 0..1, value "
          f"{info.work.value}): {same}", flush=True)
    if not same:
        raise AssertionError("ProveInfo.work is not the session's work")
    succinct = info.receipt.inner.value
    bad = np.array(succinct.seal)
    bad[len(bad) // 2] ^= 1
    try:
        dataclasses.replace(succinct, seal=bad).verify_integrity(ctx)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted succinct receipt was accepted")
    print(f"povw: flipped seal word rejected ({rejected})", flush=True)

    # (b) lift_povw of a po2 14 segment, then the work-log update proved
    # through the log-builder guest
    job_b = PovwJobId(log=POVW_LOG, job=POVW_JOB + 1)
    env_b = ExecutorEnv(segment_po2=16, povw_job_id=job_b).write_slice(
        (100).to_bytes(4, "little"))
    (seg,) = ExecutorImpl(env_b, elf).run().segments
    if seg.po2 != 14:
        raise AssertionError(f"the one-segment session is of po2 {seg.po2}")
    n_seg, n_rec = len(seg_log), len(rec_log)
    seal = rv_prove.prove_segment(seg, device=dev)
    _print_segment_prove("povw", seg_log[n_seg])
    sr = SegmentReceipt(seal=seal, index=0, hashfn="poseidon2",
                        claim=decode_claim(seal))
    work_receipt = lift_povw(sr, device=dev, rng=np.random.default_rng(8))
    _print_recursion_prove("lift_rv32im_povw_14", rec_log[n_rec])
    want = WorkClaim(decode_claim(seal), decode_work(seal))
    t0 = time.perf_counter()
    work_receipt.verify_integrity(ctx)
    verify_s = time.perf_counter() - t0
    same = (np.array_equal(work_receipt.claim.digest(), want.digest())
            and want.work.nonce_min == job_b.nonce(0)
            and want.work.value == 1 << 14)
    print(f"povw: lift_povw receipt verified in {verify_s:.2f} s; claim == "
          f"WorkClaim(decode_claim, decode_work) (nonce job.nonce(0), "
          f"value 2^14): {same}", flush=True)
    if not same:
        raise AssertionError("the lift_povw claim is not the seal's")

    guest = LogBuilderGuestProver(prover=ProverImpl(
        ProverOpts(receipt_kind="succinct"), device=dev))
    updater = WorkLogUpdateProver(log_id=POVW_LOG, journal_prover=guest,
                                  device=dev)
    n_seg, n_rec = len(seg_log), len(rec_log)
    secs, (journal, receipt) = _wall_s(
        lambda: updater.prove_update([work_receipt]))
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"povw: prove_update through the log-builder guest {secs:.3f} s "
          f"(the work receipt's verify, the guest's execution, "
          f"{len(seg_log) - n_seg} segment, {len(rec_log) - n_rec} "
          f"recursion proves and the self-checks)", flush=True)
    for rec in seg_log[n_seg:]:
        _print_segment_prove("povw: log-builder guest", rec)
    guest_po2s = [int(np.asarray(r["out"])[91]) for r in seg_log[n_seg:]]
    names = ([f"lift_rv32im_{p} (guest segment {i})"
              for i, p in enumerate(guest_po2s)]
             + ["join"] * (len(guest_po2s) - 1) + ["resolve"])
    for name, rec in zip(names, rec_log[n_rec:]):
        _print_recursion_prove(name, rec)
    if len(rec_log) - n_rec != len(names):
        raise AssertionError(f"{len(rec_log) - n_rec} recursion proves, "
                             f"expected {len(names)}")
    t0 = time.perf_counter()
    receipt.verify(guest.image_id())
    verify_s = time.perf_counter() - t0
    same = (receipt.inner.kind == "succinct"
            and journal.update_value == 1 << 14
            and journal.updated_commit == updater.work_log.commit()
            and journal.work_log_id == POVW_LOG)
    print(f"povw: journal receipt ({receipt.inner.kind}) passed "
          f"Receipt.verify(guest image ID) in {verify_s:.2f} s; journal "
          f"update_value {journal.update_value} == 2^14 and updated_commit "
          f"== the work log's commit: {same}", flush=True)
    if not same:
        raise AssertionError("the log-builder journal is not the host's "
                             "transition")
    print(f"povw: launches {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the PoVW proves: "
                             f"{missing}")

    # (c) the PoVW programs this phase does not prove
    t0 = time.perf_counter()
    for name in ("join_povw", "unwrap_povw", "resolve_povw",
                 "resolve_unwrap_povw"):
        same = np.array_equal(load_own_program(name).control_id(dev),
                              ids[name])
        print(f"povw: {name} control ID == own_control_ids(): {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{name} control ID differs")
    print(f"povw: control IDs in {time.perf_counter() - t0:.2f} s; phase 10 "
          f"in {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches


CLUSTER_TOML = """
version = 1
[executor]
count = 1
[[prover]]
subscribe = ["preflight"]
count = 1
[[prover]]
subscribe = ["prove-segment", "lift", "join", "union", "resolve", "unwrap"]
count = 2
"""
CARD_TASKS = ("prove_segment", "lift", "join", "union", "resolve", "unwrap")


def _cli(*argv):
    """(seconds, last stdout line) of the port's CLI in a subprocess."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "risc0_tpu_torch.cli", *argv],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300,
                         check=False)
    if res.returncode != 0:
        raise AssertionError(f"cli {argv[0]} failed ({res.returncode}): "
                             f"{res.stderr[-2000:]}")
    return time.perf_counter() - t0, res.stdout.strip().splitlines()[-1]


def _peak_concurrency(spans) -> int:
    """Most spans open at one instant."""
    edges = sorted([(s.start_ns, 1) for s in spans]
                   + [(s.end_ns, -1) for s in spans])
    cur = peak = 0
    for _t, d in edges:
        cur += d
        peak = max(peak, cur)
    return peak


def cold_pool_child() -> int:
    """Phase 11 (c), run in a fresh process: make_local_pools with two card
    workers and ProverImpl(composite) proves phase 7's two-segment
    session; both prove-segment tasks start together, so the first use of
    the kernel library, libr0vm.so, the witgen graphs and their plans
    happens on two threads at once.  No retries.  Prints one JSON line."""
    sys.path.insert(0, ROOT)
    from risc0_tpu_torch import loop_guest, telemetry
    from risc0_tpu_torch.parallel.scheduler import (Factory, ProofJob,
                                                    make_local_pools)
    from risc0_tpu_torch.zkvm.exec import ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import (InnerReceipt, Receipt,
                                              session_claim)

    prover = ProverImpl(ProverOpts(receipt_kind="composite"), device="cuda")
    factory = Factory()
    workers = make_local_pools(factory, prover, num_cpu=1, num_accel=2)
    elf = loop_guest.elf()
    env = loop_guest.session_env(REC_SESSION_PO2, 2)
    try:
        job = ProofJob(factory, prover, env, elf, receipt_kind="composite")
        job.max_retries = 0
        job_s, (session, composite) = _wall_s(job.run)
    finally:
        for w in workers:
            w.stop()
    receipt = Receipt(InnerReceipt("composite", composite), session.journal)
    receipt.verify(ExecutorImpl(env, elf).compute_image_id())
    tasks = sorted((s for s in telemetry.tracer().finished()
                    if s.name.startswith("task:")), key=lambda s: s.start_ns)
    t_first = tasks[0].start_ns
    proves = [s for s in tasks if s.name == "task:prove_segment"]
    print(json.dumps({
        "job_s": job_s,
        "tasks": [[s.name[5:], s.attributes["worker"],
                   (s.start_ns - t_first) / 1e9,
                   (s.end_ns - s.start_ns) / 1e9, s.status] for s in tasks],
        "prove_overlap_s": (min(s.end_ns for s in proves)
                            - max(s.start_ns for s in proves)) / 1e9,
        "claim_ok": bool(np.array_equal(receipt.claim().digest(),
                                        session_claim(session).digest())),
    }), flush=True)
    return 0


def phase_orchestration(dev, counters):
    """The host layers on the card: the CLI in subprocesses (id, and a
    composite prove of one po2 16 segment), then a cluster from a TOML
    config running ProofJob with split preflight over the two-segment
    session of phase 7, its receipt verified.  Returns {kernel: launches
    over the cluster's job}."""
    from risc0_tpu_torch import loop_guest, telemetry
    from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids
    from risc0_tpu_torch.parallel.config import launch_cluster, load_config
    from risc0_tpu_torch.parallel.scheduler import ProofJob
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts
    from risc0_tpu_torch.zkvm.receipt import (InnerReceipt, Receipt,
                                              VerificationError,
                                              VerifierContext, session_claim)

    t_phase = time.perf_counter()
    elf = loop_guest.elf()

    # (a) the CLI
    secs, image_id = _cli("id", "--elf", loop_guest.ELF)
    want = ExecutorImpl(ExecutorEnv(), elf).compute_image_id()
    same = image_id == want.tobytes().hex()
    print(f"orchestration: cli id {image_id} in {secs:.2f} s == "
          f"ExecutorImpl.compute_image_id(): {same}", flush=True)
    if not same:
        raise AssertionError("the CLI's image ID is not the host's")
    input_hex = loop_guest.session_env(REC_SESSION_PO2, 1).input.hex()
    secs, line = _cli("prove", "--elf", loop_guest.ELF, "--input-hex",
                      input_hex, "--po2", str(REC_SESSION_PO2),
                      "--receipt-kind", "composite")
    out = json.loads(line)
    env = ExecutorEnv(segment_po2=REC_SESSION_PO2).write_slice(
        bytes.fromhex(input_hex))
    session = ExecutorImpl(env, elf).run()
    same = (out["kind"] == "composite" and out["claim_digest"]
            == session_claim(session).digest().tobytes().hex())
    print(f"orchestration: cli prove --receipt-kind composite on the card "
          f"({out['segments']} segment(s), {out['total_cycles']} cycles) in "
          f"{secs:.2f} s (process start, build check, prove and its "
          f"self-check); claim_digest == session_claim: {same}", flush=True)
    if not same:
        raise AssertionError("the CLI's claim digest is not the session's")

    # (b) the cluster
    rprove_mod = sys.modules["risc0_tpu_torch.circuit.recursion.prove"]
    rv_mod = sys.modules["risc0_tpu_torch.circuit.rv32im.prove"]
    _unwatch(rprove_mod, "prove_program")  # its resets race across threads
    _unwatch(rv_mod, "prove_segment_core")
    _ids, root = own_control_ids()
    prover = ProverImpl(ProverOpts(receipt_kind="succinct"), device=dev)
    cluster = launch_cluster(load_config(CLUSTER_TOML), prover=prover)
    env = loop_guest.session_env(REC_SESSION_PO2, 2)
    telemetry.tracer().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    try:
        job = ProofJob(cluster.factory, prover, env, elf,
                       split_preflight=True)
        job_s, (session, succinct) = _wall_s(job.run)
    finally:
        cluster.stop()
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    po2s = [s.po2 for s in session.segments]
    print(f"orchestration: cluster ProofJob(split_preflight) of a "
          f"{len(po2s)}-segment loop session (segments of po2 {po2s}) in "
          f"{job_s:.3f} s; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if po2s != [REC_SESSION_PO2, REC_SESSION_PO2 - 1]:
        raise AssertionError(f"the session's segments are of po2 {po2s}")
    spans = telemetry.tracer().finished()
    tasks = sorted((s for s in spans if s.name.startswith("task:")),
                   key=lambda s: s.start_ns)
    t_first = min(s.start_ns for s in tasks)
    for s in tasks:
        print(f"  {s.name[5:]:<14} {s.attributes['worker']:<13} start "
              f"{(s.start_ns - t_first) / 1e9:8.3f} s  wall "
              f"{(s.end_ns - s.start_ns) / 1e9:8.3f} s  {s.status}",
              flush=True)
    card = [s for s in tasks if s.name[5:] in CARD_TASKS]
    print(f"orchestration: {len(tasks)} tasks; at most "
          f"{_peak_concurrency(card)} card tasks at once (prove-segment, "
          f"lift, join; two workers), at most {_peak_concurrency(tasks)} "
          f"tasks of any kind", flush=True)
    if any(s.status != "OK" for s in tasks):
        raise AssertionError("a task of the cluster's job failed")
    t0 = time.perf_counter()
    ctx = VerifierContext(control_root=root)
    receipt = Receipt(InnerReceipt("succinct", succinct), session.journal)
    receipt.verify(ExecutorImpl(env, elf).compute_image_id(), ctx)
    same = np.array_equal(succinct.claim.digest(),
                          session_claim(session).digest())
    print(f"orchestration: the job's succinct receipt passed "
          f"Receipt.verify(image_id) in {time.perf_counter() - t0:.2f} s; "
          f"claim == session_claim(session): {same}", flush=True)
    if not same:
        raise AssertionError("the cluster's claim is not the session's")
    bad = np.array(succinct.seal)
    bad[len(bad) // 2] ^= 1
    try:
        dataclasses.replace(succinct, seal=bad).verify_integrity(ctx)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted cluster receipt was accepted")
    print(f"orchestration: flipped seal word rejected ({rejected})",
          flush=True)

    # (c) cold first use from two card workers, in a fresh process
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.cold_pool_child())"],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=300, check=False)
    if res.returncode != 0:
        raise AssertionError(f"the cold pool failed ({res.returncode}): "
                             f"{res.stderr[-2000:]}")
    cold = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"orchestration: a fresh process's make_local_pools(2 card "
          f"workers) proved the session composite in {cold['job_s']:.3f} s "
          f"({time.perf_counter() - t0:.2f} s with process start); the two "
          f"prove-segment tasks overlapped {cold['prove_overlap_s']:.3f} s; "
          f"claim == session_claim: {cold['claim_ok']}", flush=True)
    for kind, worker, start, wall, status in cold["tasks"]:
        print(f"  {kind:<14} {worker:<13} start {start:8.3f} s  wall "
              f"{wall:8.3f} s  {status}", flush=True)
    if not cold["claim_ok"] or cold["prove_overlap_s"] <= 0 or any(
            t[4] != "OK" for t in cold["tasks"]):
        raise AssertionError("the cold pool's first use did not hold")
    print(f"orchestration: launches {json.dumps(launches)}; phase 11 in "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the cluster's job: "
                             f"{missing}")
    return launches


PREDICATES = ("lift_rv32im_20", "lift_rv32im_povw_16", "join", "union",
              "identity", "resolve")


def phase_predicates(dev, counters):
    """Generate predicates with the port on the card: each must equal its
    vendored program word for word, each control ID (a (23, 2^18) code
    group committed on the card) the vendored ID, and the allowed root
    rebuilt from the vendored ID list the vendored root.  Returns {kernel:
    launches over the generation}."""
    from risc0_tpu_torch.circuit.recursion import predicates as pr

    t_phase = time.perf_counter()

    def log(r):
        print(f"predicates: {r['name']}: {r['rows']} rows, emitted in "
              f"{r['emit_s']:.3f} s, control ID committed in "
              f"{r['commit_s']:.3f} s, SHA-256 {r['sha256']}", flush=True)

    for fn in counters:
        fn.launches = 0
    result = pr.generate(PREDICATES, device=dev, log=log)
    launches = {fn.__name__: fn.launches for fn in counters}
    diffs = pr.compare_vendored(result)
    print(f"predicates: {len(PREDICATES)} programs written to "
          f"{os.path.relpath(pr.DEFAULT_OUT, ROOT)}; each equal to its "
          f"vendored program word for word, its control ID to "
          f"own_control_ids(), and the allowed root rebuilt from the "
          f"vendored ID list to the vendored root: {not diffs}", flush=True)
    if diffs:
        raise AssertionError(f"generated predicates differ: {diffs}")
    print(f"predicates: launches {json.dumps(launches)}; phase 12 in "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the generation: "
                             f"{missing}")
    return launches


SHARD_COMMIT_SHAPE = (211, 1 << PO2)  # the rv32im data group at po2 20


def mesh_devices():
    """Every card when there are several, else the one card twice."""
    count = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(count)] if count > 1
            else ["cuda:0", "cuda:0"])


def phase_sharded(dev, seg, seal20, counters):
    """The sharded commit and prove over mesh_devices(): a seeded
    (211, 2^20) commit must equal the one-device commit layer for layer,
    and phase 6's segment proved under mesh_context must give phase 6's
    seal, verify, and reject a flipped word.  Returns {kernel: launches
    over the sharded commit and the prove}."""
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.hal import torch_hal as hal
    from risc0_tpu_torch.parallel.sharded import commit_sharded, mesh_context
    from risc0_tpu_torch.verify.verifier import VerificationError

    t_phase = time.perf_counter()
    names = mesh_devices()
    cards = sorted({torch.device(d).index for d in names})
    print(f"sharded: mesh of {len(names)} devices {names} "
          f"({len(cards)} card(s))", flush=True)
    witness = np.random.default_rng(13).integers(
        0, P, SHARD_COMMIT_SHAPE, dtype=np.uint32)
    one_s, want = _wall_s(lambda: hal.commit_pipeline(witness, device=dev))
    for fn in counters:
        fn.launches = 0
    mesh_s, got = _wall_s(lambda: commit_sharded(witness, names))
    same = [torch.equal(a, b) for a, b in zip(want[:2], got[:2])]
    same_layers = len(want[2]) == len(got[2]) and all(
        torch.equal(a, b) for a, b in zip(want[2], got[2]))
    print(f"sharded: commit of a seeded {SHARD_COMMIT_SHAPE} witness: one "
          f"device {one_s:.3f} s, the mesh {mesh_s:.3f} s; coefficients "
          f"equal {same[0]}, evaluations equal {same[1]}, all "
          f"{len(got[2])} Merkle layers equal {same_layers}", flush=True)
    if not (all(same) and same_layers):
        raise AssertionError("the sharded commit differs from the "
                             "one-device commit")
    del want, got, witness
    torch.cuda.empty_cache()

    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    before = {fn.__name__: fn.launches for fn in counters}
    with mesh_context(names):
        prove_s, seal = _wall_s(lambda: prove_segment(
            seg, rand_z=loop_guest.RAND_Z, device=dev))
    launches = {fn.__name__: fn.launches for fn in counters}
    prove_launches = {k: v - before[k] for k, v in launches.items()}
    peaks = [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards]
    same = np.array_equal(seal, seal20)
    print(f"sharded: po2 {seg.po2} segment proved under mesh_context in "
          f"{prove_s:.3f} s, peak device memory "
          + ", ".join(f"cuda:{c} {p:.2f} GiB" for c, p in zip(cards, peaks))
          + f"; seal SHA-256 {hashlib.sha256(seal.tobytes()).hexdigest()}, "
          f"the same bytes as phase 6's: {same}", flush=True)
    if not same:
        raise AssertionError("the sharded seal differs from phase 6's")
    t0 = time.perf_counter()
    verify_rv32im_seal(seal)
    verify_s = time.perf_counter() - t0
    bad = np.array(seal)
    bad[len(bad) // 3] ^= 1
    try:
        verify_rv32im_seal(bad)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a corrupted sharded seal was accepted")
    print(f"sharded: seal verified in {verify_s:.2f} s; flipped word "
          f"rejected ({rejected})", flush=True)
    print(f"sharded: launches of the prove {json.dumps(prove_launches)}; "
          f"of the commit and the prove {json.dumps(launches)}; phase 13 in "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    missing = [k for k, v in prove_launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the sharded prove: "
                             f"{missing}")
    return launches


EXAMPLES_DEV = ("hello_world", "factors", "password_checker", "sha",
                "prorata", "prover_api", "bonsai_remote",
                "keccak_coprocessor", "cluster", "povw", "profiling")


class _Env:
    """Set (value) or unset (None) environment variables for a block."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _flipped(receipt, index):
    """`receipt` (composite) with one word of segment `index`'s seal
    flipped."""
    inner = receipt.inner.value
    segs = list(inner.segments)
    seal = np.array(segs[index].seal)
    seal[len(seal) // 2] ^= 1
    segs[index] = dataclasses.replace(segs[index], seal=seal)
    return dataclasses.replace(receipt, inner=dataclasses.replace(
        receipt.inner, value=dataclasses.replace(inner, segments=segs)))


def _seconds(values):
    return ", ".join(f"{v:.2f}" for v in values)


def phase_examples(dev, counters):
    """The examples of risc0_tpu_torch.examples on the card: ecdsa (two
    po2 17 segments through the bigint2 accelerator) and composition (B
    verifies A's receipt in the guest) proved for real; the other eleven
    through their main in dev mode.  Returns {kernel: launches over the
    two real proves}."""
    import importlib
    import tempfile

    from risc0_tpu_torch.circuit.rv32im import prove as rv_prove
    from risc0_tpu_torch.examples import composition, ecdsa
    from risc0_tpu_torch.zkvm.receipt import (Receipt, VerificationError,
                                              VerifierContext)

    t_phase = time.perf_counter()
    ctx = VerifierContext(dev_mode=False)
    pre_log, seg_log, verify_log = [], [], []
    _watch(rv_prove, "segment_preflight", pre_log)
    _watch(rv_prove, "prove_segment_core", seg_log)
    # each example's main verifies its receipts against their image IDs:
    # time those calls rather than verify again
    _watch(Receipt, "verify", verify_log)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with _Env(RISC0_REAL_PROVE="1", RISC0_DEV_MODE=None):
        ecdsa_s, ec = _wall_s(lambda: ecdsa.main(["--device", str(dev)]))
        n_ec, n_ec_verify = len(seg_log), len(verify_log)
        comp_s, co = _wall_s(lambda: composition.main(["--device",
                                                       str(dev)]))
    launches = {fn.__name__: fn.launches for fn in counters}
    _unwatch(rv_prove, "segment_preflight")
    _unwatch(rv_prove, "prove_segment_core")
    _unwatch(Receipt, "verify")
    peak = max([torch.cuda.max_memory_allocated()]
               + [r["peak"] for r in pre_log + seg_log])

    # (a) ecdsa: two po2 17 segments, the journal, a tampered signature
    session, receipt = ec["session"], ec["receipt"]
    po2s = [s.po2 for s in session.segments]
    print(f"examples: ecdsa ({session.user_cycles} user cycles, segments "
          f"of po2 {po2s}) executed, proved composite on the card and "
          f"verified in {ecdsa_s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for pre, rec in zip(pre_log[:n_ec], seg_log[:n_ec]):
        print(f"examples: ecdsa segment preflight {pre['s']:.3f} s", end="; ",
              flush=True)
        _print_segment_prove("prove", rec)
    if po2s != [17, 17] or receipt.inner.kind != "composite" \
            or len(receipt.inner.value.segments) != 2:
        raise AssertionError(f"ecdsa: segments of po2 {po2s}, receipt "
                             f"{receipt.inner.kind}")
    qx, qy = ec["pubkey"]
    journal = (qx.to_bytes(32, "little") + qy.to_bytes(32, "little")
               + hashlib.sha256(ec["message"]).digest())
    verify_s = [r["s"] for r in verify_log[:n_ec_verify]]
    try:
        _flipped(receipt, 0).verify(ec["image_id"], ctx)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("ecdsa: a flipped seal word was accepted")
    ok = (len(verify_s) == 1 and receipt.journal == journal
          and ec["rejected"].exit_code == ("Halted", 1))
    print(f"examples: ecdsa receipt verified against the image ID by "
          f"main in {_seconds(verify_s)} s; journal == (qx, qy, "
          f"sha256(message)): "
          f"{receipt.journal == journal}; tampered signature halts "
          f"{ec['rejected'].exit_code}; flipped seal word rejected "
          f"({rejected})", flush=True)
    if not ok:
        raise AssertionError("ecdsa: wrong journal or tampered exit code")

    # (b) composition: B's receipt carries A's and verifies
    receipt = co["receipt"]
    attached = receipt.inner.value.assumption_receipts
    claim_a = co["receipt_a"].claim().digest()
    verify_s = [r["s"] for r in verify_log[n_ec_verify:]]
    ok = (len(verify_s) == 2 and len(attached) == 1
          and np.array_equal(attached[0].claim().digest(), claim_a)
          and receipt.journal == (composition.VALUE ** 2).to_bytes(
              4, "little"))
    print(f"examples: composition (guests A and B, one segment each) "
          f"proved for real in {comp_s:.3f} s; A's and B's receipts "
          f"verified against their image IDs by main in "
          f"{_seconds(verify_s)} s, B's with A's receipt attached: {ok}",
          flush=True)
    for pre, rec in zip(pre_log[n_ec:], seg_log[n_ec:]):
        print(f"examples: composition segment preflight {pre['s']:.3f} s",
              end="; ", flush=True)
        _print_segment_prove("prove", rec)
    if not ok:
        raise AssertionError("composition: B's receipt does not carry A's")
    print(f"examples: launches of the two real proves "
          f"{json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the examples' "
                             f"proves: {missing}")

    # (c) the other eleven, in dev mode, each asserting what the JAX
    # example asserts
    times = {}
    with tempfile.TemporaryDirectory() as tmp, \
            _Env(RISC0_REAL_PROVE=None, RISC0_DEV_MODE="1",
                 BONSAI_API_URL=None):
        for name in EXAMPLES_DEV:
            argv = ([os.path.join(tmp, "guest.pb")]
                    if name == "profiling" else [])
            mod = importlib.import_module(f"risc0_tpu_torch.examples.{name}")
            t0 = time.perf_counter()
            out = mod.main(argv + ["--device", str(dev)])
            times[name] = round(time.perf_counter() - t0, 3)
            if name == "bonsai_remote":
                if out["status"]["status"] != "SUCCEEDED":
                    raise AssertionError(f"bonsai_remote: {out['status']}")
            elif out["session"].exit_code != ("Halted", 0):
                raise AssertionError(f"{name}: {out['session'].exit_code}")
    print(f"examples: dev mode on the card, s each: {json.dumps(times)}; "
          f"phase 14 in {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from risc0_tpu_torch.core import ntt as ntt_mod
    from risc0_tpu_torch.hal.cuda import build
    from risc0_tpu_torch.hal.cuda import ntt as kntt
    from risc0_tpu_torch.hal.cuda import poseidon2 as kp2

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    def done(phase):
        print(f"chip_smoke: phase {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"build: {build.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rec = phase_kernels(dev, kntt, kp2, ntt_mod)
    eval_recs = phase_eval_plan(dev)
    done(3)
    phase_check(dev)

    from risc0_tpu_torch import loop_guest
    t0 = time.perf_counter()
    seg = loop_guest.segment(PO2)
    print(f"executed loop guest, segment po2 {seg.po2} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if seg.po2 != PO2:
        raise AssertionError(f"segment po2 {seg.po2} != {PO2}")
    phase_witgen(dev, seg)
    done(5)
    counters = [kp2.hash_rows, kp2.hash_pairs, kntt.evaluate_ntt,
                kntt.interpolate_ntt]
    launches, seal = phase_prove(dev, seg, counters)
    done(6)
    from risc0_tpu_torch.circuit.recursion import prove as rprove
    rec_log = []
    _watch(rprove, "prove_program", rec_log)
    launches_rec, lifted = phase_recursion(dev, seal, counters, rec_log)
    done(7)
    launches_comp = phase_composition(dev, counters, rec_log)
    done(8)
    launches_snark = phase_snark(dev, lifted, counters, rec_log)
    done(9)
    launches_povw = phase_povw(dev, counters, rec_log)
    done(10)
    launches_cluster = phase_orchestration(dev, counters)
    done(11)
    launches_predicates = phase_predicates(dev, counters)
    done(12)
    launches_sharded = phase_sharded(dev, seg, seal, counters)
    done(13)
    launches_examples = phase_examples(dev, counters)

    meta = {
        "hash_rows": ("poseidon2.cu", "risc0_tpu/hal/pallas/poseidon2.py:121"),
        "hash_pairs": ("poseidon2.cu", "risc0_tpu/hal/pallas/poseidon2.py:149"),
        "evaluate_ntt": ("ntt.cu", "risc0_tpu/hal/pallas/ntt.py:124"),
        "interpolate_ntt": ("ntt.cu", "risc0_tpu/hal/pallas/ntt.py:186"),
    }
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"risc0_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches[name], "launches_recursion": launches_rec[name],
        "launches_composition": launches_comp[name],
        "launches_snark": launches_snark[name],
        "launches_povw": launches_povw[name],
        "launches_cluster": launches_cluster[name],
        "launches_predicates": launches_predicates[name],
        "launches_sharded": launches_sharded[name],
        "launches_examples": launches_examples[name],
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
        "library_ms": None,  # no PyTorch call computes these functions
        "shape": rec[name]["shape"],
    } for name, (src, replaces) in meta.items()]
    kernels += [dict(r, launches=launches["eval_plan"]) for r in eval_recs]
    print(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
