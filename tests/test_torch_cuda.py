"""Card-only checks of the CUDA kernels of risc0_tpu_torch against their
plain torch versions, on the same CUDA inputs (the recursion prove's
shapes too), of the device witgens and the rv32im prove on the card
against their CPU and host runs, and of a lift on the card.  Field
arithmetic is exact, so every comparison is bit for bit.

These skip where torch sees no CUDA device.  This file imports no jax, so
it also runs on a machine without it:

    RISC0_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.core import ntt as ntt_mod
from risc0_tpu_torch.hal.cuda import ntt as kntt
from risc0_tpu_torch.hal.cuda import poseidon2 as kp2

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, shape, dev):
    return torch.from_numpy(
        rng.integers(0, F.P, shape, dtype=np.uint32).view(np.int32)).to(dev)


def test_field_edge_words_through_ntt(dev):
    # the edge words of test_mul_edge_cases go through the kernels'
    # Montgomery product: a 2-point NTT is add/sub of x0 and x1*W
    edge = np.array([0, 1, F.P - 1, F.R, (1 << 31) - (1 << 27), F.P - 2],
                    np.uint32)
    x = torch.from_numpy(np.stack(np.meshgrid(edge, edge), -1)
                         .reshape(-1, 2).view(np.int32)).to(dev).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


@pytest.mark.parametrize("cols", [0, 1, 15, 16, 17, 64, 103, 211, 1024])
@pytest.mark.parametrize("rows", [1, 37, 1024])
def test_hash_rows_kernel(dev, cols, rows):
    rng = np.random.default_rng(cols * 1000 + rows)
    m = _words(rng, (cols, rows), dev)
    assert torch.equal(kp2.hash_rows(m), kp2.hash_rows_plain(m))


def _edge_words(dev, shape):
    # all 0, all P - 1, and the edge words mixed (the lazy reductions'
    # extremes: 0, 1, P - 1, P - 2 and the Montgomery one)
    rng = np.random.default_rng(17)
    mixed = rng.choice(np.array([0, 1, F.P - 1, F.P - 2, F.R % F.P],
                                np.uint32), shape)
    out = [np.zeros(shape, np.uint32), np.full(shape, F.P - 1, np.uint32),
           mixed]
    return [torch.from_numpy(a.view(np.int32)).to(dev) for a in out]


@pytest.mark.parametrize("cols", [1, 16, 17, 211])
def test_hash_rows_kernel_edge_words(dev, cols):
    for m in _edge_words(dev, (cols, 64)):
        assert torch.equal(kp2.hash_rows(m), kp2.hash_rows_plain(m))


def test_pair_kernels_edge_words(dev):
    for leaves in _edge_words(dev, (64, 8)):
        assert torch.equal(kp2.hash_pairs(leaves[0::2], leaves[1::2]),
                           kp2.hash_pairs_plain(leaves[0::2], leaves[1::2]))
        for got, want in zip(kp2.merkle_fold(leaves),
                             kp2.merkle_fold_plain(leaves)):
            assert torch.equal(got, want)


# every boundary of the fold plan: one launch up to 2^9 leaves, then a
# second launch of 1 to 3 levels; 2^22 is the prove's tree (9 + 9 + 4)
@pytest.mark.parametrize("n_bits", list(range(13)) + [22])
def test_merkle_fold_kernel(dev, n_bits):
    leaves = _words(np.random.default_rng(n_bits), (1 << n_bits, 8), dev)
    got = kp2.merkle_fold(leaves)
    want = kp2.merkle_fold_plain(leaves)
    assert len(got) == len(want) == n_bits
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_merkle_fold_counts_its_launches(dev):
    leaves = _words(np.random.default_rng(2), (1 << 20, 8), dev)
    before = kp2.hash_pairs.launches
    kp2.merkle_fold(leaves)
    assert kp2.hash_pairs.launches - before == len(kp2.fold_plan(20)) == 3


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4096])
def test_hash_pairs_kernel(dev, n):
    rng = np.random.default_rng(n)
    layer = _words(rng, (2 * n, 8), dev)
    left, right = layer[0::2], layer[1::2]
    assert torch.equal(kp2.hash_pairs(left, right),
                       kp2.hash_pairs_plain(left, right))


@pytest.mark.parametrize("n_bits", [0, 1, 2, 5, 10, 11, 12, 14, 16])
@pytest.mark.parametrize("batch", [1, 3])
def test_ntt_kernels(dev, n_bits, batch):
    rng = np.random.default_rng(n_bits * 10 + batch)
    x = _words(rng, (batch, 1 << n_bits), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


# n_bits 17-24: every (k1, k2) split of the two-pass kernels, up to the
# 64 KB strided tile at k2 = 10 (n_bits 24)
@pytest.mark.parametrize("n_bits", list(range(17, 25)))
@pytest.mark.parametrize("batch", [1, 2])
def test_ntt_kernels_large(dev, n_bits, batch):
    rng = np.random.default_rng(n_bits * 10 + batch)
    x = _words(rng, (batch, 1 << n_bits), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


def test_ntt_kernels_batch_above_one_tile(dev):
    # 9 rows: above the 8-row batch tile of the Pallas kernels
    x = _words(np.random.default_rng(9), (9, 1 << 14), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


@pytest.mark.parametrize("n_bits", [2, 3, 11, 13, 15, 22])
def test_ntt_expand_kernel(dev, n_bits):
    rng = np.random.default_rng(n_bits)
    c = _words(rng, (5, 1 << (n_bits - 2)), dev)
    x = ntt_mod.expand(c, 2).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x, 2), kntt.evaluate_ntt_plain(x, 2))


# expand_bits at or above k1: the contiguous pass is skipped and the
# strided pass starts above its first stage (or is skipped too)
@pytest.mark.parametrize("n_bits,expand_bits", [(14, 12), (16, 13), (20, 15),
                                                (12, 12), (14, 14)])
def test_ntt_expand_at_or_above_k1(dev, n_bits, expand_bits):
    assert expand_bits >= kntt.split(n_bits)[0]
    rng = np.random.default_rng(n_bits + expand_bits)
    c = _words(rng, (2, 1 << (n_bits - expand_bits)), dev)
    x = ntt_mod.expand(c, expand_bits).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x, expand_bits),
                       kntt.evaluate_ntt_plain(x, expand_bits))


def test_ntt_misaligned_view(dev):
    # a row view that starts 4 bytes into its storage is copied first
    base = _words(np.random.default_rng(3), (1, 1 + (2 << 13)), dev)
    x = base[0, 1:].reshape(2, 1 << 13)
    assert x.data_ptr() % 16
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


def test_ntt_roundtrip_kernel(dev):
    rng = np.random.default_rng(5)
    x = _words(rng, (4, 1 << 15), dev)
    assert torch.equal(kntt.evaluate_ntt(kntt.interpolate_ntt(x)), x)


def test_wrappers_count_launches(dev):
    x = _words(np.random.default_rng(1), (2, 64), dev)
    before = (kntt.evaluate_ntt.launches, kp2.hash_rows.launches)
    kntt.evaluate_ntt(x)
    kp2.hash_rows(x)
    assert (kntt.evaluate_ntt.launches, kp2.hash_rows.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.fixture(scope="module")
def loop_segment():
    import os

    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "guests", "loop.bin"), "rb") as f:
        elf = f.read()
    env = ExecutorEnv(segment_po2=16).write_slice((100).to_bytes(4, "little"))
    return ExecutorImpl(env, elf).run().segments[0]


def test_device_witgens_on_the_card_equal_their_cpu_runs(dev, loop_segment):
    # 2^14 rows; the CPU runs take small chunks, the card its defaults
    from risc0_tpu_torch.circuit.rv32im.accum_device import \
        witgen_accum_device
    from risc0_tpu_torch.circuit.rv32im.exec_device import \
        witgen_exec_device

    rand_z = (5, 6, 7, 8)
    cpu = witgen_exec_device(loop_segment, rand_z=rand_z, device="cpu",
                             p2_chunk=1 << 11)
    card = witgen_exec_device(loop_segment, rand_z=rand_z, device=dev)
    assert cpu["rows"] == card["rows"] == 1 << 14
    assert card["data"].device.type == "cuda"
    assert torch.equal(card["data"].cpu(), cpu["data"])
    for key in ("global", "tables_u8", "tables_u16"):
        assert np.array_equal(card[key], cpu[key]), key
    mix = np.random.default_rng(3).integers(0, F.P, 36).astype(np.uint32)
    want = witgen_accum_device(cpu, mix, device="cpu", chunk=1 << 11)
    got = witgen_accum_device(card, mix, device=dev)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def test_device_accum_prove_gives_the_host_accum_seal(dev, loop_segment):
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal

    seals = [prove_segment(loop_segment, rand_z=(1, 2, 3, 4), device=dev,
                           exec=ex, accum=acc)
             for ex, acc in (("host", "device"), ("host", "host"),
                             ("device", "device"))]
    assert np.array_equal(seals[0], seals[1])
    assert np.array_equal(seals[0], seals[2])
    assert len(verify_rv32im_seal(seals[0])) == 90


# the recursion prove's groups: 12 accum, 23 code and 128 data columns at
# 2^18 rows (batches that are no multiple of 4), their 4x LDE, its leaves
# and a tree of 2^20 leaves
@pytest.mark.parametrize("cols", [12, 23, 128])
def test_recursion_shapes(dev, cols):
    w = _words(np.random.default_rng(cols), (cols, 1 << 18), dev)
    assert torch.equal(kntt.interpolate_ntt(w), kntt.interpolate_ntt_plain(w))
    x = ntt_mod.expand(w, 2).contiguous()
    ev = kntt.evaluate_ntt(x, 2)
    assert torch.equal(ev, kntt.evaluate_ntt_plain(x, 2))
    leaves = kp2.hash_rows(ev)
    assert torch.equal(leaves, kp2.hash_rows_plain(ev))
    for got, want in zip(kp2.merkle_fold(leaves),
                         kp2.merkle_fold_plain(leaves)):
        assert torch.equal(got, want)


def test_lift_on_the_card(dev):
    import os

    from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids
    from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
    from risc0_tpu_torch.zkvm.receipt import SegmentReceipt, VerifierContext
    from risc0_tpu_torch.zkvm.recursion_driver import lift

    seal = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "rv32im_seal_po2_14.npy"))
    sr = SegmentReceipt(seal=seal, index=0, hashfn="poseidon2",
                        claim=decode_claim(seal))
    receipt = lift(sr, device=dev, rng=np.random.default_rng(1))
    _ids, root = own_control_ids()
    receipt.verify_integrity(VerifierContext(control_root=root))
    assert np.array_equal(receipt.claim.digest(), decode_claim(seal).digest())


def test_lift_povw_of_a_nonce_segment_on_the_card(dev):
    """A po2 14 loop segment with a PoVW nonce proved on the card, lifted
    with lift_rv32im_povw_14 into a verified receipt of
    WorkClaim(decode_claim, decode_work)."""
    from risc0_tpu_torch import loop_guest
    from risc0_tpu_torch.circuit.recursion.predicates import own_control_ids
    from risc0_tpu_torch.circuit.rv32im.claim import (decode_claim,
                                                      decode_work)
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu_torch.zkvm.povw import PovwJobId, WorkClaim
    from risc0_tpu_torch.zkvm.receipt import SegmentReceipt, VerifierContext
    from risc0_tpu_torch.zkvm.recursion_driver import lift_povw

    job = PovwJobId(log=0x5EED, job=3)
    env = ExecutorEnv(segment_po2=16, povw_job_id=job).write_slice(
        (100).to_bytes(4, "little"))
    (seg,) = ExecutorImpl(env, loop_guest.elf()).run().segments
    seal = prove_segment(seg, rand_z=(1, 2, 3, 4), device=dev)
    work = decode_work(seal)
    assert (work.nonce_min, work.nonce_max, work.value) == \
        (job.nonce(0), job.nonce(0), 1 << 14)
    receipt = lift_povw(SegmentReceipt(seal, 0, "poseidon2",
                                       decode_claim(seal)),
                        device=dev, rng=np.random.default_rng(2))
    _ids, root = own_control_ids()
    receipt.verify_integrity(VerifierContext(control_root=root))
    assert np.array_equal(receipt.claim.digest(),
                          WorkClaim(decode_claim(seal), work).digest())


# the keccak prove's data group: 1096 columns (68 full Poseidon2 blocks
# and 8 words) at 2^17 rows, its 4x LDE, its leaves and a tree of 2^19
# leaves
def test_keccak_shapes(dev):
    w = _words(np.random.default_rng(1096), (1096, 1 << 17), dev)
    assert torch.equal(kntt.interpolate_ntt(w), kntt.interpolate_ntt_plain(w))
    x = ntt_mod.expand(w, 2).contiguous()
    del w
    ev = kntt.evaluate_ntt(x, 2)
    assert torch.equal(ev, kntt.evaluate_ntt_plain(x, 2))
    del x
    leaves = kp2.hash_rows(ev)
    assert torch.equal(leaves, kp2.hash_rows_plain(ev))
    del ev
    for got, want in zip(kp2.merkle_fold(leaves),
                         kp2.merkle_fold_plain(leaves)):
        assert torch.equal(got, want)


def test_keccak_seal_on_the_card_is_the_jax_seal(dev):
    """The po2 14 keccak seal of the golden keccak lift's inputs, proved
    on the card, is tests/data/keccak_seal_po2_14.npy word for word."""
    import os

    from risc0_tpu_torch.circuit.keccak.prove import prove_keccak

    rng = np.random.default_rng(14)  # scripts/gen_keccak_seal.py inputs()
    inputs = [[int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
              for _ in range(2)]
    seal = prove_keccak(inputs, 14, device=dev)
    assert np.array_equal(seal, np.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data",
        "keccak_seal_po2_14.npy")))


def test_p254_merkle_and_seal_on_the_card(dev):
    """The host-suite Merkle path from a card tensor (one readback, the
    host hashes, one upload back to the card) equals it from the same
    words on the CPU, and the
    fib seal proved on the card under Poseidon254 is the JAX package's
    (tests/data/fib_seal_po2_6_poseidon254.npy)."""
    import os

    from risc0_tpu_torch.circuit import fib
    from risc0_tpu_torch.hal import torch_hal as hal
    from risc0_tpu_torch.hash.suite import POSEIDON254

    m = _words(np.random.default_rng(8), (23, 1 << 12), dev)
    got = hal.merkle_layers(m, POSEIDON254)
    want = hal.merkle_layers(m.cpu(), POSEIDON254)
    assert len(got) == 13
    assert all(g.device == m.device for g in got)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    seal = fib.prove(po2=6, seed=0, device=dev, suite=POSEIDON254)
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    assert np.array_equal(
        seal, np.load(os.path.join(data, "fib_seal_po2_6_poseidon254.npy")))


@pytest.mark.parametrize("name", ["sha256", "poseidon254", "blake2b"])
def test_segment_proves_and_verifies_under_each_suite(dev, loop_segment,
                                                      name):
    """prove_segment under a host-hashed suite on the card: its seal
    verifies under that suite, not under Poseidon2, and a flipped word is
    rejected."""
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal
    from risc0_tpu_torch.hash.suite import get_suite
    from risc0_tpu_torch.verify.verifier import VerificationError

    suite = get_suite(name)
    seal = prove_segment(loop_segment, rand_z=(1, 2, 3, 4), device=dev,
                         suite=suite)
    assert len(verify_rv32im_seal(seal, suite)) == 90
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    for s, st in ((bad, suite), (seal, None)):
        with pytest.raises(VerificationError):
            verify_rv32im_seal(s, st)


# the plan interpreter (csrc/eval_plan.cu) against its plain twin on one
# chunk of each circuit's plan, every fp and ext row of the file compared;
# random taps, globals and mix powers with 0, 1 and P - 1 among them.  T is
# no multiple of the kernel's block in the synthetic case.
@pytest.mark.parametrize("name,T", [("rv32im", 1 << 12),
                                    ("recursion", 1 << 11),
                                    ("keccak", 1 << 10), ("synthetic", 1000)])
def test_eval_plan_kernel_equals_run_chunk(dev, name, T):
    from test_torch_eval_stream import _plan, staged_file

    from risc0_tpu_torch.circuit import ir_range
    from risc0_tpu_torch.hal.cuda import eval_plan as keval

    plan = _plan(name)
    fp, ext, pm = (torch.from_numpy(a.view(np.int32)).to(dev)
                   for a in staged_file(plan, T, seed=T))
    dplan = ir_range._DevicePlan(plan, dev)
    want_fp, want_ext = fp.clone(), ext.clone()
    before = keval.eval_plan.launches
    keval.eval_plan(dplan.ops, dplan.ops_head, fp, ext, pm)
    assert keval.eval_plan.launches == before + 1
    ir_range._run_chunk(dplan, want_fp, want_ext, pm, T)
    assert torch.equal(fp, want_fp)
    assert torch.equal(ext, want_ext)


def test_eval_check_on_the_card_equals_its_cpu_run(dev):
    """make_eval_check of the rv32im plan at po2 10 in chunks of 2^10:
    the card runs the kernel once a chunk, the CPU the plain twin."""
    from risc0_tpu_torch.circuit import ir_range
    from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit
    from risc0_tpu_torch.hal.cuda import eval_plan as keval

    circuit = load_circuit()
    plan = ir_range._range_plan(circuit)
    po2, chunk = 10, 1 << 10
    rng = np.random.default_rng(10)
    evs = [rng.integers(0, F.P, (cols, 4 << po2), dtype=np.uint32)
           for cols in (103, 211)]
    gvals = rng.integers(0, F.P, len(plan.global_specs), dtype=np.uint32)
    pm = circuit.mix_pows(rng.integers(0, F.P, 4, dtype=np.uint32))
    fn = ir_range.make_eval_check(plan, po2, chunk=chunk)
    want = fn(tuple(torch.from_numpy(e.view(np.int32)) for e in evs),
              gvals, pm)
    before = keval.eval_plan.launches
    got = fn(tuple(torch.from_numpy(e.view(np.int32)).to(dev) for e in evs),
             gvals, pm)
    assert keval.eval_plan.launches == before + (4 << po2) // chunk
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
