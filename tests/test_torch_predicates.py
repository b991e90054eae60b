"""The port's predicate generators on the CPU against the JAX package.

  * the assembler (circuit/recursion/asm.py) in the port's preflight: micro
    ops, the in-VM Poseidon2 sponge against the host suite, IOP reads and
    the output stream, in-VM SHA-256 against hashlib; the same emission
    calls give the JAX assembler's rows word for word;
  * a small program at po2 11 built by the port: its words and its control
    ID are the JAX package's, and the JAX seal of it verifies against that
    ID (tests/data/recursion_seal_asm_po2_11.npy);
  * the in-VM verifier generator (zkr_verify.py): the fib spec at po2 6
    emits the JAX program word for word, and that program accepts the fib
    seal (tests/data/fib_seal_po2_6_seed_0.npy) and rejects tampered ones;
  * the PoVW helpers (_read_work, _check_contiguous, _sum_u64) against the
    host Work.join, and lift_rv32im_povw(14) in the preflight on a real
    segment seal against the host WorkClaim.

Field arithmetic is exact, so every comparison is bit for bit.  The
vendored programs regenerated word for word are in
test_torch_predicate_programs.py.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.circuit.recursion.asm import Asm
from risc0_tpu_torch.circuit.recursion.preflight import RecursionPreflight
from risc0_tpu_torch.circuit.recursion.zkr_verify import (CircuitSpec, Gen,
                                                          gen_verify)
from risc0_tpu_torch.zkvm.povw import PovwJobId, PovwNonce, Work, WorkClaim

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIB_SEAL = os.path.join(DATA, "fib_seal_po2_6_seed_0.npy")
ASM_SEAL = os.path.join(DATA, "recursion_seal_asm_po2_11.npy")
SEGMENT_SEAL = os.path.join(DATA, "rv32im_seal_po2_14.npy")


def _run(asm, inputs=(), po2=11):
    prog = asm.program(po2)
    pf = RecursionPreflight(list(inputs))
    pf.run(prog.code)
    return prog, pf


# -- the assembler ------------------------------------------------------------

def test_asm_micro_semantics():
    a = Asm()
    c5 = a.const(5)
    c7 = a.const(7, 3)            # (7, 3, 0, 0)
    s = a.add(c5, c7)             # (12, 3, 0, 0)
    d = a.sub(c7, c5)             # (2, 3, 0, 0)
    m = a.mul(c5, c7)             # (35, 15, 0, 0)
    i = a.inv(c5)                 # ext inverse of 5
    z = a.iszero(c5)              # 0
    e3 = a.extract(c7, 1)         # component 1 = 3
    a.eq(z, a.const(0))
    sel = a.select(a.const(1), c5, 2)   # wom[c5 + 2 * 1]
    _, pf = _run(a)
    assert pf.wom[s] == (12, 3, 0, 0)
    assert pf.wom[d] == (2, 3, 0, 0)
    assert pf.wom[m] == (35, 15, 0, 0)
    assert pf.wom[i][0] == pow(5, F.P - 2, F.P)
    assert pf.wom[z] == (0, 0, 0, 0)
    assert pf.wom[e3] == (3, 0, 0, 0)
    assert pf.wom[sel] == pf.wom[c5 + 2]


def test_asm_poseidon_hash_matches_suite():
    """The in-VM sponge (load 16 Montgomery words, permute, store) equals
    the host hash_elem_slice over the same words."""
    from risc0_tpu_torch.hash.suite import POSEIDON2

    vals = np.random.default_rng(0).integers(0, F.P, 16, dtype=np.uint32)
    a = Asm()
    addrs = [a.const(int(F.s_encode(int(v)))) for v in vals]
    a.p2_load(addrs[:8], group=0, do_mont=1, keep_state=0, keep_upper=0)
    a.p2_load(addrs[8:], group=1, do_mont=1, keep_state=1, keep_upper=1,
              prep_full=True)
    a.p2_permute()
    base = a.p2_store(group=0, do_mont=1)
    _, pf = _run(a)
    got = np.array([pf.wom[base + i][0] for i in range(8)], np.uint32)
    assert np.array_equal(got, POSEIDON2.hash_elem_slice(F.encode_np(vals)))


def test_asm_iop_read_and_output():
    a = Asm()
    a.read_iop_header(4, k=1)
    vals = [a.read_iop_body(do_mont=True) for _ in range(4)]
    tot = a.add(vals[0], vals[1])
    for v in vals[2:]:
        tot = a.add(tot, v)
    a.output(tot)
    words = [17, 100, 3, F.P - 2]
    _, pf = _run(a, inputs=words)
    # k=1 reads decode Montgomery; body do_mont re-encodes: a round trip
    assert pf.wom[vals[0]] == (17, 0, 0, 0)
    assert pf.output == [sum(words) % F.P]


@pytest.mark.parametrize("nbytes", [64, 170])
def test_asm_sha256_matches_hashlib(nbytes):
    msg = (bytes(range(nbytes % 251)) * 4 * (nbytes + 1))[:nbytes]
    padded = msg + b"\x80" + b"\x00" * ((55 - nbytes) % 64) \
        + (8 * nbytes).to_bytes(8, "big")
    a = Asm()
    addrs = [a.const(int(w) & 0xFFFF, int(w) >> 16)
             for w in np.frombuffer(padded, "<u4")]
    dig = a.sha256(addrs)
    _, pf = _run(a)
    got = np.array([pf.wom[dig[i]][0] | (pf.wom[dig[i]][1] << 16)
                    for i in range(8)], np.uint32)
    assert np.array_equal(got, np.frombuffer(hashlib.sha256(msg).digest(),
                                             np.uint32))


def _emit_every_row_kind(a):
    """One call of each emission method of the assembler."""
    x = a.const(3, 4)
    y = a.const_ext([1, 2, 3, 4])
    s = a.mul(a.add(x, y), a.sub(y, x))
    a.eq(a.inv(s), a.inv(s))
    a.select(a.iszero(x), x, 1)
    a.read_iop_header(2, k=1, flip=True)
    r = [a.read_iop_body(do_mont=False) for _ in range(2)]
    a.mix_rng(r[0], r[1], 1)
    a.bit_and_elem(a.extract(y, 3), a.const(0xFF))
    a.bit_op_shorts(x, y, True)
    a.p2_load([x] * 8, group=2, do_mont=1, keep_state=0, keep_upper=1,
              prep_full=True)
    a.p2_permute()
    a.p2_store(group=1, do_mont=0)
    a.checked_bytes(x, keep_coeffs=1, keep_upper=0, prep_full=True)
    a.sha256([a.const(i, i + 1) for i in range(16)])
    a.output(s)
    a.set_global(s, 0)


def test_asm_rows_are_the_jax_assemblers():
    from risc0_tpu.circuit.recursion.asm import Asm as JaxAsm

    a, j = Asm(), JaxAsm()
    _emit_every_row_kind(a)
    _emit_every_row_kind(j)
    assert np.array_equal(a.program(11).code, j.program(11).code)


def _square_sum_program(a):
    """The po2 11 program of tests/test_recursion_asm.py: read 8 words, sum
    their squares, write four globals."""
    a.read_iop_header(8, k=1)
    vals = [a.read_iop_body(do_mont=True) for _ in range(8)]
    sq = [a.mul(v, v) for v in vals]
    tot = sq[0]
    for s in sq[1:]:
        tot = a.add(tot, s)
    ex = a.extract(tot, 0)
    outs = [a.add(ex, a.const(i)) for i in range(16)]
    for k in range(4):
        a.set_global(outs[4 * k], k)
    return a.program(11)


def test_small_program_and_control_id_are_jaxs():
    """Words and control ID (committed on the CPU) equal the JAX
    package's, and the JAX seal of the program verifies against it."""
    from risc0_tpu.circuit.recursion.asm import Asm as JaxAsm
    from risc0_tpu_torch.circuit.recursion.circuit import \
        verify_recursion_seal
    from risc0_tpu_torch.verify.verifier import VerificationError

    prog, jprog = _square_sum_program(Asm()), _square_sum_program(JaxAsm())
    assert np.array_equal(prog.code, jprog.code)
    cid = prog.control_id(device="cpu")
    assert np.array_equal(cid, jprog.control_id())

    def check(po2, root):
        if po2 != 11 or not np.array_equal(root, cid):
            raise VerificationError("control id mismatch")

    seal = np.load(ASM_SEAL)
    verify_recursion_seal(seal, check)
    bad = seal.copy()
    bad[100] ^= 1
    with pytest.raises(VerificationError):
        verify_recursion_seal(bad, check)


# -- the in-VM verifier generator ---------------------------------------------

def _fib_poly_ext_emit(gen, pm, u, out, mix):
    a = gen.a
    acc, s0, s1, rec, fini, x0, x1, x2 = u
    cons = [
        a.mul(s0, a.sub(x0, out[0])),
        a.mul(s1, a.sub(x0, out[1])),
        a.mul(rec, a.sub(x0, a.add(x1, x2))),
        a.mul(fini, a.sub(x0, out[2])),
        a.mul(a.add(a.add(s0, s1), a.add(rec, fini)),
              a.sub(acc, a.mul(x0, mix[0]))),
    ]
    tot = a.const(0)
    cur = a.const(1)
    for c in cons:
        tot = a.add(tot, a.mul(cur, c))
        cur = a.mul(cur, pm)
    return tot


def _fib_spec(fib, root, spec_cls, po2=6):
    root_std = [int(w) * F.R_INV % F.P for w in np.asarray(root, np.uint32)]

    def check_code(gen, _po2, root_cells):
        for cell, want in zip(root_cells, root_std):
            gen.a.eq(cell, gen.a.const(want))

    return spec_cls(
        taps=fib.TAPS, circuit_info=fib.CIRCUIT_INFO,
        output_size=fib.OUTPUT_SIZE, mix_size=fib.MIX_SIZE,
        poly_ext_emit=_fib_poly_ext_emit, check_code_emit=check_code,
        version_word=fib.SEAL_VERSION)


@pytest.fixture(scope="module")
def fib_verify_prog():
    from risc0_tpu_torch.circuit import fib

    a = Asm()
    gen = Gen(a)
    spec = _fib_spec(fib, fib.code_root(6, device="cpu"), CircuitSpec)
    out_cells, _ = gen_verify(gen, spec, po2=6)
    for c in out_cells:
        a.output(c)
    return a.program(18)


def test_gen_verify_emits_the_jax_program(fib_verify_prog):
    from risc0_tpu.circuit import fib as jfib
    from risc0_tpu.circuit.recursion import asm as jasm
    from risc0_tpu.circuit.recursion import zkr_verify as jzv

    a = jasm.Asm()
    spec = _fib_spec(jfib, jfib.code_root(6), jzv.CircuitSpec)
    out_cells, _ = jzv.gen_verify(jzv.Gen(a), spec, po2=6)
    for c in out_cells:
        a.output(c)
    assert np.array_equal(fib_verify_prog.code, a.program(18).code)


def test_gen_verify_accepts_the_fib_seal(fib_verify_prog):
    seal = np.load(FIB_SEAL)
    pf = RecursionPreflight([int(w) for w in seal])
    pf.run(fib_verify_prog.code)  # raises on any in-VM assertion
    assert pf.output[:3] == [int(w) for w in F.decode_np(seal[1:4])]


@pytest.mark.parametrize("idx", [2, 5, 40, -7])
def test_gen_verify_rejects_a_tampered_fib_seal(fib_verify_prog, idx):
    bad = np.load(FIB_SEAL).copy()
    bad[idx] ^= 1
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight([int(w) for w in bad]).run(fib_verify_prog.code)


# -- the PoVW helpers ---------------------------------------------------------

def _carry_prog():
    """Read two Work records, check contiguity, sum the values and output
    the joined Work digest (_check_contiguous and _sum_u64 without a STARK
    verify)."""
    from risc0_tpu_torch.circuit.recursion.predicates import (
        RECURSION_PO2, _check_contiguous, _read_work, _sum_u64,
        _work_digest)

    a = Asm()
    gen = Gen(a)
    lw = _read_work(gen)
    rw = _read_work(gen)
    _check_contiguous(gen, lw["max"], rw["min"])
    value = _sum_u64(gen, lw["value"], rw["value"])
    for c in _work_digest(gen, lw["min"], rw["max"], value):
        a.output(c)
    return a.program(RECURSION_PO2)


def _work_tape(*works):
    from risc0_tpu_torch.zkvm.recursion_driver import _work_tape_words

    return [w for work in works for w in _work_tape_words(work)]


@pytest.mark.parametrize("job,segs,values", [
    (PovwJobId(log=7, job=9), (0, 1), (100, 200)),
    # the carry ripples through the whole segment word (0xFFFFFFFF + 1)
    (PovwJobId(log=2**159 + 5, job=2**63 + 1), (0xFFFFFFFE, 0xFFFFFFFF),
     (0xFFFF, 0x1_0000)),
    # the value sum carries across u16 limbs
    (PovwJobId(log=1, job=1), (3, 4), (0xFFFF_FFFF, 1)),
])
def test_carry_arithmetic_in_vm_matches_host(job, segs, values):
    w0 = Work(job.nonce(segs[0]), job.nonce(segs[0]), values[0])
    w1 = Work(job.nonce(segs[1]), job.nonce(segs[1]), values[1])
    pf = RecursionPreflight(_work_tape(w0, w1))
    pf.run(_carry_prog().code)
    assert pf.output == [int(w) & 0xFFFF for w in w0.join(w1).digest()]


def test_carry_arithmetic_rejects_gap_and_overflow():
    job = PovwJobId(log=3, job=4)
    prog = _carry_prog()
    w0 = Work(job.nonce(0), job.nonce(0), 5)
    w2 = Work(job.nonce(2), job.nonce(2), 5)
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight(_work_tape(w0, w2)).run(prog.code)
    top = PovwNonce.from_u256((1 << 256) - 1)
    wzero = Work(PovwNonce.ZERO, PovwNonce.ZERO, 5)
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight(_work_tape(Work(top, top, 5), wzero)).run(
            prog.code)


@pytest.fixture(scope="module")
def povw_lift_prog():
    from risc0_tpu_torch.circuit.recursion.predicates import lift_rv32im_povw

    return lift_rv32im_povw(14, device="cpu")


def test_lift_povw_preflight_matches_host_work_claim(povw_lift_prog):
    from risc0_tpu_torch.circuit.rv32im.claim import (decode_claim,
                                                      decode_work)

    seal = np.load(SEGMENT_SEAL)
    root = list(range(8))  # echoed verbatim
    pf = RecursionPreflight(root + [int(w) for w in seal])
    pf.run(povw_lift_prog.code)
    assert pf.output[:8] == root
    want = WorkClaim(decode_claim(seal), decode_work(seal)).digest()
    assert pf.output[8:] == [int(w) & 0xFFFF for w in want]


def test_lift_povw_preflight_rejects_tampered_nonce_globals(povw_lift_prog):
    seal = np.load(SEGMENT_SEAL).copy()
    seal[1 + 33] ^= 1  # the first povw_nonce short (layout reg 33)
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight([0] * 8 + [int(w) for w in seal]).run(
            povw_lift_prog.code)
