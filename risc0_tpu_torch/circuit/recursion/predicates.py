"""The repository's own recursion predicates (counterpart of
``risc0_tpu/circuit/recursion/predicates.py``): the loader of the vendored
programs and the builders that generate them.

The reference ships its predicates as zirgen-compiled zkr blobs
(risc0/circuit/recursion/src/recursion_zkr.zip), driven by
host/recursion/prove/mod.rs:73-260.  This repository authors equivalent
programs with the assembler (asm.py) and the in-VM verifier generator
(zkr_verify.py), vendors them under ``assets.RECURSION_ZKR`` with their
allowed-control-IDs set, and receipts verify against that set's root.

lift_rv32im(po2): verifies an rv32im segment seal in-VM, decodes the
Rv32imV2Claim from the seal globals (circuit/rv32im/claim.py semantics),
computes the ReceiptClaim tagged-struct digest with in-VM SHA-256, and
outputs [control_root (echoed input), claim digest] — the exact output
layout SuccinctReceipt verification decodes (receipt/succinct.rs:160-190).
join, union, identity, resolve and the PoVW variants verify succinct seals
in-VM.  The emission is host Python; the commits that give the rv32im
code roots (lift_rv32im*) and the control IDs (``generate``) run on
`device`, the card unless the caller names another.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import os
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np

from ... import field as F
from ...assets import RECURSION_DATA, RECURSION_ZKR, RV32IM_DATA
from ...convert import card
from ...hal.cuda.build import BUILD_DIR
from ...hash.suite import POSEIDON254
from ...prove.prover import PolyGroup
from ..rv32im.circuit import (BUF_GLOBAL, EADD, EADDF, ECONST, EMADD, EMUL,
                              ESCALE, ESCR_RD, ESCR_WR, ESUB, ESUBF, FADD,
                              FCONST, FGLOBAL, FMUL, FSCR_RD, FSCR_WR, FSUB,
                              FSUBE, FTAP)
from ..rv32im.circuit import load_circuit as load_rv32im_circuit
from ..rv32im.verify import RV32IM_SEAL_VERSION
from .asm import Asm
from .circuit import RECURSION_PO2, load_prover_circuit
from .prove import MerkleGroup, Program, _load_zkr, load_keccak_lift
from .zkr_verify import CircuitSpec, Gen, _Rng, _std, gen_verify

P = F.P

# where ``generate`` writes unless told otherwise (git-ignored)
DEFAULT_OUT = str(BUILD_DIR / "predicates")


# ---------------------------------------------------------------------------
# the vendored program set
# ---------------------------------------------------------------------------

def load_own_program(name: str) -> Program:
    """Load a vendored predicate by name (e.g. "lift_rv32im_20", "join")."""
    return _load_zkr(name)


def own_control_ids():
    """({name: control_id}, allowed root) of the vendored predicate set."""
    z = np.load(os.path.join(RECURSION_DATA, "own_control_ids.npz"),
                allow_pickle=True)
    ids = {str(n): z["ids"][i] for i, n in enumerate(z["names"])}
    return ids, z["root"]


def identity_p254_control_id():
    """The identity program's code commitment under the Poseidon254 suite
    (reference control_id.rs BN254_IDENTITY_CONTROL_ID), vendored beside
    the Poseidon2 set."""
    z = np.load(os.path.join(RECURSION_DATA, "own_control_ids.npz"),
                allow_pickle=True)
    return z["identity_p254"]


# ---------------------------------------------------------------------------
# rv32im constraint-poly emission (mirrors Rv32imCircuit.poly_ext, the
# scalar interpreter over the extracted poly_fp IR)
# ---------------------------------------------------------------------------

def _rv32im_poly_ext_emit(circuit):
    # IR tap buffer id -> register group (0=accum, 1=code, 2=data); the
    # recursion circuit taps its code/ctrl group as buffer 4
    buf_to_group = {0: 0, 1: 2, 4: 1}

    def emit(gen: Gen, poly_mix, eval_u, out_cells, mix_cells):
        a = gen.a
        # poly_mix power cache: pm[k] = poly_mix ^ POLY_MIX_POWERS[k]
        pow_cache = {0: a.const(1), 1: poly_mix}

        def pm_pow(e):
            if e in pow_cache:
                return pow_cache[e]
            if e % 2 == 0:
                h = pm_pow(e // 2)
                v = a.mul(h, h)
            else:
                v = a.mul(pm_pow(e - 1), poly_mix)
            pow_cache[e] = v
            return v

        fregs = [None] * circuit.n_f
        eregs = [None] * circuit.n_e
        fscr = [None] * circuit.fscr_size
        escr = [None] * circuit.escr_size

        for op, row in zip(circuit.opcode.tolist(),
                           circuit.operands.tolist()):
            va, b, c, d, e, f_ = row
            if op == FCONST:
                fregs[va] = a.const(b)
            elif op == FTAP:
                fregs[va] = eval_u[circuit._tap_index[
                    (buf_to_group[b], c, d)]]
            elif op == FGLOBAL:
                src = out_cells if b == BUF_GLOBAL else mix_cells
                fregs[va] = src[c]
            elif op == FSCR_RD:
                fregs[va] = fscr[b]
            elif op == FADD:
                fregs[va] = a.add(fregs[b], fregs[c])
            elif op == FSUB:
                fregs[va] = a.sub(fregs[b], fregs[c])
            elif op == FMUL:
                fregs[va] = a.mul(fregs[b], fregs[c])
            elif op == ECONST:
                eregs[va] = gen.const_ext([b, c, d, e])
            elif op == EMADD:
                term = pm_pow(int(circuit.mix_powers[c]))
                if d >= 0:
                    term = a.mul(term, fregs[d])
                if e >= 0:
                    term = a.mul(term, fregs[e])
                if f_ >= 0:
                    term = a.mul(term, eregs[f_])
                eregs[va] = a.add(eregs[b], term)
            elif op == FSCR_WR:
                fscr[va] = fregs[b]
            elif op == ESCR_WR:
                escr[va] = eregs[b]
            elif op == ESCR_RD:
                eregs[va] = escr[b]
            elif op == EADD:
                eregs[va] = a.add(eregs[b], eregs[c])
            elif op == ESUB:
                eregs[va] = a.sub(eregs[b], eregs[c])
            elif op == EMUL:
                eregs[va] = a.mul(eregs[b], eregs[c])
            elif op == ESCALE:
                eregs[va] = a.mul(eregs[b], fregs[c])
            elif op == EADDF:
                eregs[va] = a.add(eregs[b], fregs[c])
            elif op == FSUBE:
                eregs[va] = a.sub(fregs[b], eregs[c])
            elif op == ESUBF:
                eregs[va] = a.sub(eregs[b], fregs[c])
            else:
                raise ValueError(f"bad opcode {op}")
        return eregs[circuit.ret[1]]

    return emit


# ---------------------------------------------------------------------------
# tagged-struct SHA emission (binfmt/src/hash.rs:52-71 semantics)
# ---------------------------------------------------------------------------

def _pairs_const(gen: Gen, data: bytes):
    """Constant message bytes -> (lo,hi) word cells."""
    assert len(data) % 4 == 0
    words = np.frombuffer(data, "<u4")
    return [gen.a.const(int(w) & 0xFFFF, int(w) >> 16) for w in words]


def tagged_sha(gen: Gen, tag: str, down_word_cells, data_word_cells):
    """Emit sha256(tag_digest || downs || data || down_count_le16 + padding).

    down_word_cells: list of 8-cell digests in (lo,hi) pair format;
    data_word_cells: u32 word cells in pair format.  Returns 8 digest cells
    in pair format (sha_fini layout)."""
    a = gen.a
    tag_digest = hashlib.sha256(tag.encode()).digest()
    words = _pairs_const(gen, tag_digest)
    for d in down_word_cells:
        assert len(d) == 8
        words.extend(d)
    words.extend(data_word_cells)
    nbytes = 4 * len(words) + 2   # + down_count u16
    # tail: down_count (le16) then SHA padding to the block boundary
    tail = len(down_word_cells).to_bytes(2, "little") + b"\x80"
    padlen = (56 - (nbytes + 1) % 64) % 64
    tail += b"\x00" * padlen + (8 * nbytes).to_bytes(8, "big")
    words.extend(_pairs_const(gen, tail))
    return a.sha256(words)


# ---------------------------------------------------------------------------
# rv32im claim decode + digest (circuit/rv32im/claim.py in-VM)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _layout():
    with open(os.path.join(RV32IM_DATA, "global_layout.json")) as f:
        return json.load(f)


def _reg(node):
    while isinstance(node, dict):
        node = node["_super"] if "_super" in node else \
            next(iter(node.values()))
    return int(node)


def emit_rv32im_claim_digest(gen: Gen, out_cells):
    """Decode the Rv32imV2Claim from the verified seal's global cells and
    emit its ReceiptClaim tagged digest; returns 8 digest cells (pair
    format)."""
    a = gen.a
    lay = _layout()

    def short(cell):
        # range check: value must equal its low 16 bits
        a.eq(a.bit_and_elem(cell, a.const(0xFFFF)), cell)
        return cell

    def digest_pairs(node):
        pairs = []
        for p in node["values"]:
            lo = short(out_cells[_reg(p["low"])])
            hi = short(out_cells[_reg(p["high"])])
            pairs.append(a.add(lo, a.mul(hi, gen.x_pows()[0])))
        return pairs

    pre = digest_pairs(lay["state_in"])
    post = digest_pairs(lay["state_out"])
    inp = digest_pairs(lay["input"])
    outp = digest_pairs(lay["output"])
    t = out_cells[_reg(lay["is_terminate"])]
    a0_high = short(out_cells[_reg(lay["term_a0high"])])
    a0_low = out_cells[_reg(lay["term_a0low"])]

    one = a.const(1)
    # t in {0,1}; when terminating, halt type in {0,1} (Halted/Paused)
    a.eq(a.mul(t, a.sub(t, one)), a.const(0))
    a.eq(a.mul(t, a.mul(a0_low, a.sub(a0_low, one))), a.const(0))
    not_t = a.sub(one, t)

    sys_exit = a.add(a.mul(t, a0_low), a.mul(not_t, a.const(2)))
    user_exit = a.mul(t, a0_high)
    # halted <=> post state digest pruned to zero (claim/receipt.rs:168-171)
    halted = a.mul(t, a.sub(one, a0_low))
    not_halted = a.sub(one, halted)
    post_sel = [a.mul(not_halted, w) for w in post]
    # output digest: zero unless terminated
    out_sel = [a.mul(t, w) for w in outp]

    zero_pc = [a.const(0)]
    pre_ss = tagged_sha(gen, "risc0.SystemState", [pre], zero_pc)
    post_ss = tagged_sha(gen, "risc0.SystemState", [post_sel], zero_pc)
    return tagged_sha(
        gen, "risc0.ReceiptClaim", [inp, pre_ss, post_ss, out_sel],
        [sys_exit, user_exit])


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def rv32im_spec(po2: int, device="cuda") -> CircuitSpec:
    """Spec for verifying an rv32im segment seal of `po2`; its code root is
    committed on `device`."""
    circuit = load_rv32im_circuit()
    root = _rv32im_code_root(po2, device)

    def check_code(gen, _po2, root_cells):
        for cell, want in zip(root_cells, root):
            gen.a.eq(cell, gen.a.const(want))

    return CircuitSpec(
        taps=circuit.taps, circuit_info=circuit.CIRCUIT_INFO,
        output_size=circuit.OUTPUT_SIZE, mix_size=circuit.MIX_SIZE,
        poly_ext_emit=_rv32im_poly_ext_emit(circuit),
        check_code_emit=check_code, version_word=RV32IM_SEAL_VERSION)


def _rv32im_code_root(po2: int, device="cuda"):
    """The rv32im code group is a zeroized (1, cycles) column; its committed
    Merkle root (zk shifted, as every commit) is a per-po2 constant
    (abstract cells), computed on `device`."""
    code = np.zeros((1, 1 << po2), np.uint32)
    pg = PolyGroup.commit_witness(code, card(device))
    return [_std(w) for w in np.asarray(pg.merkle.root)]


def recursion_spec(check_code_emit) -> CircuitSpec:
    """Spec for verifying a seal of the recursion circuit itself (join/
    resolve inner verifies)."""
    circuit = load_prover_circuit()
    return CircuitSpec(
        taps=circuit.taps, circuit_info=circuit.CIRCUIT_INFO,
        output_size=circuit.OUTPUT_SIZE, mix_size=circuit.MIX_SIZE,
        poly_ext_emit=_rv32im_poly_ext_emit(circuit),
        check_code_emit=check_code_emit, version_word=None)


def _read_raw_words(gen: Gen, n):
    """Read n raw (undecoded) u32 words via k=2 shorts; returns
    (word_cells, pair_cells): recombined full words and (lo,hi) pairs."""
    a = gen.a
    a.read_iop_header(n, k=2)
    pairs = [a.read_iop_body(do_mont=False) for _ in range(n)]
    words = [a.add(a.extract(c, 0),
                   a.mul(a.extract(c, 1), a.const(1 << 16))) for c in pairs]
    return words, pairs


def _read_inclusion_proof(gen: Gen, depth=8):
    """Read [index word, depth sibling digests] from the tape."""
    a = gen.a
    a.read_iop_header(1, k=2)
    idx = a.extract(a.read_iop_body(do_mont=False), 0)
    bits = []
    for i in range(depth):
        raw = a.bit_and_elem(idx, a.const(1 << i))
        bits.append(a.mul(raw, a.const(pow(1 << i, P - 2, P))))
    sibs = [gen.read_elems(8) for _ in range(depth)]
    return bits, sibs


def _emit_control_inclusion(gen: Gen, control_id_cells, root_abs_cells,
                            proof):
    """In-VM MerkleProof verify of a control ID against the allowed root
    (zkvm/src/receipt/merkle.rs:73-103)."""
    a = gen.a
    bits, sibs = proof
    cur = list(control_id_cells)
    for b, sib in zip(bits, sibs):
        cb, sb = cur[0], sib[0]
        lhs = [a.select(b, cb + w, (sb - cb) % P) for w in range(8)]
        rhs = [a.select(b, sb + w, (cb - sb) % P) for w in range(8)]
        # `cur` from p2_store and `sib` from read_elems are contiguous
        cur = gen.hash_pair(lhs, rhs)
    gen.eq_digest(cur, root_abs_cells)


def _read_claim(gen: Gen):
    """Read an untrusted ReceiptClaim body from the tape (our join input
    convention): input/pre/post/output digests as raw words + sys/user
    exit words.  Returns dict with pair cells + digest (computed in-VM)."""
    a = gen.a
    fields = {}
    for name in ("input", "pre", "post", "output"):
        _, pairs = _read_raw_words(gen, 8)
        fields[name] = pairs
    a.read_iop_header(2, k=2)
    sys_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    user_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    fields["sys"] = sys_exit
    fields["user"] = user_exit
    fields["digest"] = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [fields["input"], fields["pre"], fields["post"], fields["output"]],
        [sys_exit, user_exit])
    return fields


def _eq_halfs_vs_pairs(gen: Gen, half_cells16, pair_cells8):
    """EQ 16 half cells (lo,hi interleaved) against 8 (lo,hi) pair cells."""
    a = gen.a
    x1 = gen.x_pows()[0]
    for i in range(8):
        combined = a.add(half_cells16[2 * i],
                         a.mul(half_cells16[2 * i + 1], x1))
        a.eq(combined, pair_cells8[i])


def _verify_inner_succinct(gen: Gen, root_words, root_abs):
    """Verify one recursion seal from the tape + control-ID inclusion +
    output decode (inner side of receipt/succinct.rs:103-190).  Returns the
    inner claim-digest half cells (16).  Tape: [index, 8 siblings] then the
    seal words."""
    # each seal verification is its OWN Fiat-Shamir transcript: start a
    # fresh sponge rng (the host verifier builds a new Poseidon2Rng per
    # seal).  Without this the first inner verify's pool state would chain
    # into the second, and every two-seal predicate (join/union/resolve)
    # would diverge from the prover transcript at the second seal.
    gen.rng = _Rng(gen)
    proof = _read_inclusion_proof(gen)

    def check_code(g, _po2, root_cells):
        _emit_control_inclusion(g, root_cells, root_abs, proof)

    out_cells, _ = gen_verify(gen, recursion_spec(check_code),
                              RECURSION_PO2)
    a = gen.a
    # inner output control root must equal the outer control root (raw
    # words at even slots, zeros at odd)
    for i in range(8):
        a.eq(out_cells[2 * i], root_words[i])
        a.eq(out_cells[2 * i + 1], a.const(0))
    return out_cells[16:32]


def join() -> Program:
    """Join predicate: verify two succinct (recursion) seals, check the
    claims chain, output the joined claim (host/recursion/prove/mod.rs:
    168-190; receipt/composite semantics).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ seal_left
      left claim body (input/pre/post/output digests raw + sys + user)
      [incl index, 8 sibling digests] ++ seal_right
      right claim body
    Output: [control_root | joined claim digest halfs].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    a._flush()
    root_echo = [a.add(w, 0) for w in root_words]
    assert root_echo == list(range(root_echo[0], root_echo[0] + 8))
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    left_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    left = _read_claim(gen)
    _eq_halfs_vs_pairs(gen, left_halfs, left["digest"])

    right_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    right = _read_claim(gen)
    _eq_halfs_vs_pairs(gen, right_halfs, right["digest"])

    # chain: left.post == right.pre; left exit must be SystemSplit (2, 0)
    for lw, rw in zip(left["post"], right["pre"]):
        a.eq(lw, rw)
    a.eq(left["sys"], a.const(2))
    a.eq(left["user"], a.const(0))

    joined = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [left["input"], left["pre"], right["post"], right["output"]],
        [right["sys"], right["user"]])

    a.set_global(root_echo[0], 0)
    a.set_global(root_echo[4], 1)
    a.set_global(joined[0], 2)
    a.set_global(joined[4], 3)
    for c in root_echo + joined:
        a.output(c)
    return a.program(RECURSION_PO2)


def _word_pairs(gen: Gen, word_cells):
    """Split full-word cells into (lo,hi) pair-format cells: lo via
    bit_and_elem, hi via (w - lo) * 2^-16, combined as lo + hi*x."""
    a = gen.a
    x1 = gen.x_pows()[0]
    inv16 = a.const(pow(1 << 16, P - 2, P))
    pairs = []
    for w in word_cells:
        lo = a.bit_and_elem(w, a.const(0xFFFF))
        hi = a.mul(a.sub(w, lo), inv16)
        pairs.append(a.add(lo, a.mul(hi, x1)))
    return pairs


def _pairs_from_halfs(gen: Gen, halfs16):
    """16 half cells -> 8 pair-format digest cells (lo + hi*x)."""
    a = gen.a
    x1 = gen.x_pows()[0]
    return [a.add(halfs16[2 * i], a.mul(halfs16[2 * i + 1], x1))
            for i in range(8)]


def union() -> Program:
    """Union predicate: verify two succinct (recursion) seals and bind
    them into one UnionClaim (reference host/recursion/prove/mod.rs:
    185-213; claim/receipt.rs UnionClaim).  The host sorts the two
    assumption digests (left <= right big-endian) before proving; the
    canonical sorted digest is what MMR consumers expect.

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ left seal
      [incl index, 8 sibling digests] ++ right seal
    Output: [control_root | union claim digest halfs].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    a._flush()
    root_echo = [a.add(w, 0) for w in root_words]
    assert root_echo == list(range(root_echo[0], root_echo[0] + 8))
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]
    root_pairs = _word_pairs(gen, root_words)

    left_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    right_halfs = _verify_inner_succinct(gen, root_words, root_abs)

    # assumption digests: Assumption{claim, control_root=allowed root}
    # (to_assumption(false) semantics, mmr.rs:103-111)
    left_assum = tagged_sha(
        gen, "risc0.Assumption",
        [_pairs_from_halfs(gen, left_halfs), root_pairs], [])
    right_assum = tagged_sha(
        gen, "risc0.Assumption",
        [_pairs_from_halfs(gen, right_halfs), root_pairs], [])
    union_claim = tagged_sha(
        gen, "risc0.UnionClaim", [left_assum, right_assum], [])

    a.set_global(root_echo[0], 0)
    a.set_global(root_echo[4], 1)
    a.set_global(union_claim[0], 2)
    a.set_global(union_claim[4], 3)
    for c in root_echo + union_claim:
        a.output(c)
    return a.program(RECURSION_PO2)


def identity() -> Program:
    """Identity predicate: verify one succinct (recursion) seal and re-emit
    its claim unchanged (reference host/recursion/prove/mod.rs:355-392
    identity_p254; the program itself is hash-suite agnostic — proving it
    under the poseidon254 suite yields the BN254 wrap receipt).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ inner seal
    Output: [control_root | inner claim digest halfs].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    a._flush()
    root_echo = [a.add(w, 0) for w in root_words]
    assert root_echo == list(range(root_echo[0], root_echo[0] + 8))
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    halfs = _verify_inner_succinct(gen, root_words, root_abs)
    # recombine 16 half cells into 8 contiguous pair-format digest cells
    # (lo + hi*x), the same encoding tagged_sha outputs
    x1 = gen.x_pows()[0]
    his = [a.mul(halfs[2 * i + 1], x1) for i in range(8)]
    a._flush()
    claim = [a.add(halfs[2 * i], his[i]) for i in range(8)]
    assert claim == list(range(claim[0], claim[0] + 8))

    a.set_global(root_echo[0], 0)
    a.set_global(root_echo[4], 1)
    a.set_global(claim[0], 2)
    a.set_global(claim[4], 3)
    for c in root_echo + claim:
        a.output(c)
    return a.program(RECURSION_PO2)


def resolve() -> Program:
    """Resolve predicate: remove the head assumption from a conditional
    receipt's claim (reference host/recursion/prove/mod.rs:214-258 +
    receipt_claim resolve semantics).

    The head Assumption is required to have control_root == ZERO (the
    "self" convention used by sys_verify / env::verify assumptions).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ cond seal
      cond fields: input/pre/post digests (raw) + sys + user
      journal digest (8 raw), head assumption claim digest (8 raw),
      rest-of-assumptions digest (8 raw)
      [incl index, 8 sibling digests] ++ assumption seal
    Output: [control_root | resolved claim digest halfs].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    a._flush()
    root_echo = [a.add(w, 0) for w in root_words]
    assert root_echo == list(range(root_echo[0], root_echo[0] + 8))
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    cond_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    fields = {}
    for name in ("input", "pre", "post"):
        _, fields[name] = _read_raw_words(gen, 8)
    a.read_iop_header(2, k=2)
    sys_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    user_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    _, journal = _read_raw_words(gen, 8)
    _, assum_claim = _read_raw_words(gen, 8)
    _, rest = _read_raw_words(gen, 8)

    zero_pairs = [a.const(0)] * 8
    head = tagged_sha(gen, "risc0.Assumption", [assum_claim, zero_pairs], [])
    assumptions = tagged_sha(gen, "risc0.Assumptions", [head, rest], [])
    output_digest = tagged_sha(gen, "risc0.Output", [journal, assumptions],
                               [])
    cond_claim = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [fields["input"], fields["pre"], fields["post"], output_digest],
        [sys_exit, user_exit])
    _eq_halfs_vs_pairs(gen, cond_halfs, cond_claim)

    assum_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    _eq_halfs_vs_pairs(gen, assum_halfs, assum_claim)

    resolved_output = tagged_sha(gen, "risc0.Output", [journal, rest], [])
    resolved = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [fields["input"], fields["pre"], fields["post"], resolved_output],
        [sys_exit, user_exit])

    a.set_global(root_echo[0], 0)
    a.set_global(root_echo[4], 1)
    a.set_global(resolved[0], 2)
    a.set_global(resolved[4], 3)
    for c in root_echo + resolved:
        a.output(c)
    return a.program(RECURSION_PO2)


# ---------------------------------------------------------------------------
# PoVW predicate variants: WorkClaim-wrapped lift/join/resolve + unwrap
# (reference recursion/prove/mod.rs:88-173, 255-332, 336-392 and the
# lift_rv32im_v2_povw_{po2}/join_povw/unwrap_povw zkrs from zkr.rs:70-95)
# ---------------------------------------------------------------------------

def _short_check(a, cell):
    """Range-constrain a cell to 16 bits."""
    a.eq(a.bit_and_elem(cell, a.const(0xFFFF)), cell)
    return cell


def _work_digest(gen: Gen, min_u16s, max_u16s, value_u16s):
    """tagged digest of Work{nonce_min, nonce_max, value}: data words are
    the 16+16+4 u16 limbs (claim/work.rs:231-238 encode_to_seal)."""
    return tagged_sha(gen, "risc0.Work", [],
                      list(min_u16s) + list(max_u16s) + list(value_u16s))


def _read_work(gen: Gen):
    """Read an untrusted Work record from the tape: nonce_min/nonce_max as
    8 raw words each + value as 2 raw words; returns u16 limb cells (LE)
    and the in-VM Work digest."""
    a = gen.a
    out = {}
    for name, n in (("min", 8), ("max", 8), ("value", 2)):
        _, pairs = _read_raw_words(gen, n)
        limbs = []
        for c in pairs:
            limbs.append(a.extract(c, 0))
            limbs.append(a.extract(c, 1))
        out[name] = limbs
    out["digest"] = _work_digest(gen, out["min"], out["max"], out["value"])
    return out


def _work_claim_digest(gen: Gen, claim_pairs, work_digest):
    """tagged digest of WorkClaim{claim, work} (claim/work.rs:55-67)."""
    return tagged_sha(gen, "risc0.WorkClaim", [claim_pairs, work_digest], [])


def _check_contiguous(gen: Gen, lmax_u16s, rmin_u16s):
    """Constrain right.nonce_min == left.nonce_max + 1 over 16-bit limbs
    with in-VM carry propagation; overflow (final carry) is rejected
    (claim/work.rs:146-170 join semantics)."""
    a = gen.a
    inv16 = a.const(pow(1 << 16, P - 2, P))
    mask = a.const(0xFFFF)
    carry = a.const(1)
    for i in range(16):
        s = a.add(lmax_u16s[i], carry)
        low = a.bit_and_elem(s, mask)
        a.eq(low, rmin_u16s[i])
        carry = a.mul(a.sub(s, low), inv16)
    a.eq(carry, a.const(0))


def _sum_u64(gen: Gen, l_u16s, r_u16s):
    """l + r over 4 u16 limbs with carry; overflow rejected.  Returns the
    sum's limb cells."""
    a = gen.a
    inv16 = a.const(pow(1 << 16, P - 2, P))
    mask = a.const(0xFFFF)
    carry = a.const(0)
    out = []
    for j in range(4):
        s = a.add(a.add(l_u16s[j], r_u16s[j]), carry)
        low = a.bit_and_elem(s, mask)
        out.append(low)
        carry = a.mul(a.sub(s, low), inv16)
    a.eq(carry, a.const(0))
    return out


def _emit_output(a, root_echo, claim_cells):
    """Standard predicate output: [control_root | claim digest]."""
    a.set_global(root_echo[0], 0)
    a.set_global(root_echo[4], 1)
    a.set_global(claim_cells[0], 2)
    a.set_global(claim_cells[4], 3)
    for c in root_echo + list(claim_cells):
        a.output(c)


def _contiguous_copy(a, cells, n=8):
    """Copy cells to contiguous WOM addresses (set_global needs a run)."""
    a._flush()
    out = [a.add(c, 0) for c in cells]
    assert out == list(range(out[0], out[0] + n))
    return out


def lift_rv32im_povw(po2: int, device="cuda") -> Program:
    """PoVW lift: verify an rv32im seal and output a WorkClaim binding the
    segment's ReceiptClaim to Work{nonce, nonce, 1 << po2} where the nonce
    comes from the seal's povw_nonce globals (reference
    lift_rv32im_v2_povw_{po2}.zkr; work value = cycles proven, a per-po2
    program constant).

    Input tape: [control_root (8 raw words)] ++ rv32im seal.
    Output: [control_root | WorkClaim digest].  The rv32im code root is
    committed on `device`.
    """
    device = card(device)
    a = Asm()
    gen = Gen(a)
    a.read_iop_header(8, k=2)
    raw = [a.read_iop_body(do_mont=False) for _ in range(8)]
    words = [a.add(a.extract(c, 0),
                   a.mul(a.extract(c, 1), a.const(1 << 16))) for c in raw]
    root_echo = _contiguous_copy(a, words)
    out_cells, _mix = gen_verify(gen, rv32im_spec(po2, device), po2)
    claim = emit_rv32im_claim_digest(gen, out_cells)

    lay = _layout()
    nonce = []
    for pair in lay["povw_nonce"]["values"]:
        for key in ("low", "high"):
            nonce.append(_short_check(a, out_cells[_reg(pair[key])]))
    v = 1 << po2
    value = [a.const((v >> (16 * j)) & 0xFFFF) for j in range(4)]
    work = _work_digest(gen, nonce, nonce, value)
    wclaim = _work_claim_digest(gen, claim, work)
    _emit_output(a, root_echo, wclaim)
    return a.program(RECURSION_PO2)


def join_povw(unwrap: bool = False) -> Program:
    """PoVW join: verify two WorkClaim succinct seals, check the claim
    chain AND that the nonce ranges are contiguous, output the joined
    WorkClaim (or the bare joined ReceiptClaim when `unwrap`, matching
    join_unwrap_povw) (reference recursion/prove/mod.rs:137-173).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ left seal
      left claim body ++ left work (min 8w, max 8w, value 2w)
      [incl index, 8 sibling digests] ++ right seal
      right claim body ++ right work
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    root_echo = _contiguous_copy(a, root_words)
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    sides = []
    for _ in range(2):
        halfs = _verify_inner_succinct(gen, root_words, root_abs)
        claim = _read_claim(gen)
        work = _read_work(gen)
        wc = _work_claim_digest(gen, claim["digest"], work["digest"])
        _eq_halfs_vs_pairs(gen, halfs, wc)
        sides.append((claim, work))
    (left, lwork), (right, rwork) = sides

    for lw, rw in zip(left["post"], right["pre"]):
        a.eq(lw, rw)
    a.eq(left["sys"], a.const(2))
    a.eq(left["user"], a.const(0))
    _check_contiguous(gen, lwork["max"], rwork["min"])
    value = _sum_u64(gen, lwork["value"], rwork["value"])

    joined = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [left["input"], left["pre"], right["post"], right["output"]],
        [right["sys"], right["user"]])
    if unwrap:
        out = joined
    else:
        jwork = _work_digest(gen, lwork["min"], rwork["max"], value)
        out = _work_claim_digest(gen, joined, jwork)
    _emit_output(a, root_echo, out)
    return a.program(RECURSION_PO2)


def unwrap_povw() -> Program:
    """Unwrap: verify one WorkClaim succinct seal and re-emit the inner
    ReceiptClaim digest, discarding the work record (reference
    recursion/prove/mod.rs:336-352).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ inner seal
      claim body ++ work (min 8w, max 8w, value 2w)
    Output: [control_root | inner ReceiptClaim digest].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    root_echo = _contiguous_copy(a, root_words)
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    halfs = _verify_inner_succinct(gen, root_words, root_abs)
    claim = _read_claim(gen)
    work = _read_work(gen)
    wc = _work_claim_digest(gen, claim["digest"], work["digest"])
    _eq_halfs_vs_pairs(gen, halfs, wc)

    _emit_output(a, root_echo, claim["digest"])
    return a.program(RECURSION_PO2)


def resolve_povw(unwrap: bool = False) -> Program:
    """PoVW resolve: remove the head assumption from a WorkClaim-wrapped
    conditional receipt, passing the work record through unchanged; the
    assumption seal is a plain (non-PoVW) succinct receipt (reference
    recursion/prove/mod.rs:255-332).

    Input tape:
      control_root (8 raw words)
      [incl index, 8 sibling digests] ++ cond seal
      cond fields: input/pre/post digests (raw) + sys + user
      journal digest (8 raw), head assumption claim digest (8 raw),
      rest-of-assumptions digest (8 raw)
      cond work (min 8w, max 8w, value 2w)
      [incl index, 8 sibling digests] ++ assumption seal
    Output: [control_root | resolved (Work)Claim digest].
    """
    a = Asm()
    gen = Gen(a)
    root_words, _ = _read_raw_words(gen, 8)
    root_echo = _contiguous_copy(a, root_words)
    root_abs = [a.mul(w, a.const(pow(F.R % P, P - 2, P)))
                for w in root_words]

    cond_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    fields = {}
    for name in ("input", "pre", "post"):
        _, fields[name] = _read_raw_words(gen, 8)
    a.read_iop_header(2, k=2)
    sys_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    user_exit = a.extract(a.read_iop_body(do_mont=False), 0)
    _, journal = _read_raw_words(gen, 8)
    _, assum_claim = _read_raw_words(gen, 8)
    _, rest = _read_raw_words(gen, 8)
    work = _read_work(gen)

    zero_pairs = [a.const(0)] * 8
    head = tagged_sha(gen, "risc0.Assumption", [assum_claim, zero_pairs], [])
    assumptions = tagged_sha(gen, "risc0.Assumptions", [head, rest], [])
    output_digest = tagged_sha(gen, "risc0.Output", [journal, assumptions],
                               [])
    cond_claim = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [fields["input"], fields["pre"], fields["post"], output_digest],
        [sys_exit, user_exit])
    cond_wc = _work_claim_digest(gen, cond_claim, work["digest"])
    _eq_halfs_vs_pairs(gen, cond_halfs, cond_wc)

    assum_halfs = _verify_inner_succinct(gen, root_words, root_abs)
    _eq_halfs_vs_pairs(gen, assum_halfs, assum_claim)

    resolved_output = tagged_sha(gen, "risc0.Output", [journal, rest], [])
    resolved = tagged_sha(
        gen, "risc0.ReceiptClaim",
        [fields["input"], fields["pre"], fields["post"], resolved_output],
        [sys_exit, user_exit])
    if unwrap:
        out = resolved
    else:
        out = _work_claim_digest(gen, resolved, work["digest"])
    _emit_output(a, root_echo, out)
    return a.program(RECURSION_PO2)



def lift_rv32im(po2: int, device="cuda") -> Program:
    """Build the lift predicate for one rv32im segment po2.

    Input tape: [control_root (8 words, raw)] ++ rv32im seal.
    Output globals: [control_root interleaved zeros | claim digest halfs].
    The rv32im code root is committed on `device`.
    """
    device = card(device)
    a = Asm()
    gen = Gen(a)
    # control root input: read as shorts (k=2, no Montgomery decode) and
    # recombine so the echoed output words equal the RAW digest words, as
    # SuccinctReceipt decode expects (receipt/succinct.rs:169-178).
    a.read_iop_header(8, k=2)
    raw = [a.read_iop_body(do_mont=False) for _ in range(8)]
    words = [a.add(a.extract(c, 0),
                   a.mul(a.extract(c, 1), a.const(1 << 16))) for c in raw]
    a._flush()
    root_cells = [a.add(w, 0) for w in words]   # contiguous copy
    assert root_cells == list(range(root_cells[0], root_cells[0] + 8))
    out_cells, _mix = gen_verify(gen, rv32im_spec(po2, device), po2)
    claim = emit_rv32im_claim_digest(gen, out_cells)
    a.set_global(root_cells[0], 0)
    a.set_global(root_cells[4], 1)
    a.set_global(claim[0], 2)
    a.set_global(claim[4], 3)
    for c in root_cells + claim:
        a.output(c)
    return a.program(RECURSION_PO2)


# ---------------------------------------------------------------------------
# the generator: build, write and commit a set of programs
# ---------------------------------------------------------------------------

_BUILDERS = {
    "join": join,
    "union": union,
    "identity": identity,
    "resolve": resolve,
    "join_povw": join_povw,
    "join_unwrap_povw": lambda: join_povw(unwrap=True),
    "unwrap_povw": unwrap_povw,
    "resolve_povw": resolve_povw,
    "resolve_unwrap_povw": lambda: resolve_povw(unwrap=True),
}


def build(name: str, device="cuda") -> Program:
    """The program `name` names: lift_rv32im_{po2} or lift_rv32im_povw_{po2}
    (their code roots committed on `device`), one of the recursion
    predicates (join, union, identity, resolve, join_povw,
    join_unwrap_povw, unwrap_povw, resolve_povw, resolve_unwrap_povw), or
    keccak_lift_{po2}, the released program, which is loaded."""
    for prefix, builder in (("lift_rv32im_povw_", lift_rv32im_povw),
                            ("lift_rv32im_", lift_rv32im)):
        if name.startswith(prefix):
            return builder(int(name[len(prefix):]), device)
    if name.startswith("keccak_lift_"):
        return load_keccak_lift(int(name[len("keccak_lift_"):]))
    if name not in _BUILDERS:
        raise ValueError(f"unknown predicate {name!r}")
    return _BUILDERS[name]()


def _write_zkr(prog: Program, path: str):
    # xz preset 6, as the vendored files: the same words give the same bytes
    with lzma.open(path, "wb", preset=6) as f:
        f.write(prog.code.astype("<u4").tobytes())


def generate(names, device="cuda", out_dir: str = DEFAULT_OUT,
             identity_p254: bool = False, log=None) -> dict:
    """Build each named program (see ``build``), write it to
    ``out_dir/<name>.zkr.xz`` (the released keccak lifts are only loaded;
    the writes compress in threads beside the next builds) and commit its
    control ID on `device`.  Then write
    ``out_dir/own_control_ids.npz``: the set found there before (else the
    vendored one) with these IDs in their places, and its allowed root.
    `identity_p254` also commits the identity program under the
    Poseidon254 suite (its Merkle tree hashed on the host).  `log`, if
    given, receives each program's record as it is done.

    Returns {"programs": [record, ...], "root": the written root,
    "identity_p254": its ID or None}; a record holds name, program, rows,
    sha256, control_id, emit_s and commit_s."""
    device = card(device)
    os.makedirs(out_dir, exist_ok=True)
    records = []
    with ThreadPoolExecutor() as pool:
        writes = []
        for name in names:
            t0 = time.perf_counter()
            prog = build(name, device)
            t1 = time.perf_counter()
            cid = np.asarray(prog.control_id(device), np.uint32)
            rec = {"name": name, "program": prog, "rows": prog.code_rows,
                   "sha256": hashlib.sha256(
                       prog.code.astype("<u4").tobytes()).hexdigest(),
                   "control_id": cid,
                   "emit_s": t1 - t0, "commit_s": time.perf_counter() - t1}
            if not name.startswith("keccak_lift_"):
                writes.append(pool.submit(
                    _write_zkr, prog, os.path.join(out_dir, name + ".zkr.xz")))
            records.append(rec)
            if log:
                log(rec)
        for w in writes:
            w.result()

    p254 = None
    if identity_p254:
        prog = next((r["program"] for r in records if r["name"] == "identity"),
                    None) or load_own_program("identity")
        p254 = np.asarray(prog.control_id(device, suite=POSEIDON254),
                          np.uint32)

    path = os.path.join(out_dir, "own_control_ids.npz")
    z = np.load(path if os.path.exists(path) else
                os.path.join(RECURSION_DATA, "own_control_ids.npz"),
                allow_pickle=True)
    ids = {str(n): z["ids"][i] for i, n in enumerate(z["names"])}
    extra = {k: z[k] for k in z.files if k not in ("names", "ids", "root")}
    ids.update((r["name"], r["control_id"]) for r in records)
    if p254 is not None:
        extra["identity_p254"] = p254
    all_names = sorted(ids)
    all_ids = np.stack([ids[n] for n in all_names])
    root = MerkleGroup(list(all_ids)).calc_root()
    np.savez(path, names=np.array(all_names), ids=all_ids, root=root,
             **extra)
    return {"programs": records, "root": root, "identity_p254": p254}


def compare_vendored(result: dict) -> list:
    """What differs between ``generate``'s result and the vendored set:
    each program word for word and its control ID, the allowed root
    rebuilt from the vendored ID list with the generated IDs in their
    places, and the identity_p254 ID if it was made.  Empty when all
    agree."""
    ids, root = own_control_ids()
    diffs = []
    for r in result["programs"]:
        name = r["name"]
        if not os.path.exists(os.path.join(RECURSION_ZKR, name + ".zkr.xz")):
            diffs.append(f"{name}: no vendored program")
            continue
        want = _load_zkr(name)
        if not np.array_equal(r["program"].code, want.code):
            diffs.append(f"{name}: {r['rows']} rows differ from the vendored "
                         f"program ({want.code_rows} rows)")
        if name not in ids:
            diffs.append(f"{name}: not in the vendored set")
        elif not np.array_equal(r["control_id"], ids[name]):
            diffs.append(f"{name}: control ID "
                         f"{r['control_id'].tobytes().hex()} != vendored "
                         f"{ids[name].tobytes().hex()}")
    merged = dict(ids)
    merged.update((r["name"], r["control_id"]) for r in result["programs"])
    got = MerkleGroup([merged[n] for n in sorted(merged)]).calc_root()
    if not np.array_equal(got, root):
        diffs.append(f"allowed root {got.tobytes().hex()} != vendored "
                     f"{np.asarray(root).tobytes().hex()}")
    p254 = result.get("identity_p254")
    if p254 is not None and not np.array_equal(p254,
                                               identity_p254_control_id()):
        diffs.append(f"identity_p254 control ID {p254.tobytes().hex()} "
                     "differs from the vendored one")
    return diffs
