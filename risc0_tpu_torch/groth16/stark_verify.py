"""stark_verify circuit: the full recursion-STARK verifier as an R1CS (counterpart of
``risc0_tpu/groth16/stark_verify.py``).

Builds, constraint by constraint, the same transcript replay that
verify/verifier.py performs over an identity_p254 seal (poseidon254 suite):
Fiat-Shamir draws, Merkle openings, the check-polynomial identity (via the
recursion circuit's PolyExt IR), DEEP-ALI combo quotients, and FRI — with
the control root, claim digest, and identity control ID exposed as the five
Groth16 public inputs [a0, a1, c0, c1, id_bn254] (matching the reference's
groth16_proof/groth16/stark_verify.circom + verifier.rs:92-106 interface,
circuit authored independently here from the verifier semantics).

The witness layout is the seal transcript itself (one Fr per field element,
one Fr per digest), exactly seal_to_json's `iop` array, so the same
seal-to-witness mapping feeds the circom toolchain and this module.
"""

from __future__ import annotations

import numpy as np

from .. import field as F
from ..hash import poseidon254 as p254
from ..prove.merkle import merkle_params
from ..taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                    REGISTER_GROUP_DATA)
from ..verify.verifier import (CHECK_SIZE, EXT_SIZE, FRI_FOLD,
                               FRI_MIN_DEGREE, INV_RATE, QUERIES,
                               PROOF_SYSTEM_INFO, _ext_intt16)
from . import gadgets as G
from .gadgets import BB
from .r1cs import CS, Sig


def _log2(n: int) -> int:
    b = n.bit_length() - 1
    if 1 << b != n:
        raise ValueError(f"{n} not a power of two")
    return b


class IopGadget:
    """ReadIOP over the seal-as-witness (verify/read_iop.rs semantics)."""

    def __init__(self, cs: CS, seal: np.ndarray):
        self.cs = cs
        self.seal = np.asarray(seal, np.uint32)
        self.pos = 0
        self.rng = G.RngGadget(cs)

    def read_field_elems(self, n: int) -> list[BB]:
        out = []
        for i in range(n):
            word = int(self.seal[self.pos + i])
            if word >= F.P:
                raise ValueError("invalid field element in seal")
            out.append(G.bb_input(self.cs, F.s_decode(word)))
        self.pos += n
        return out

    def read_digests(self, n: int) -> list[Sig]:
        out = []
        for i in range(n):
            words = self.seal[self.pos + 8 * i: self.pos + 8 * i + 8]
            out.append(self.cs.witness(p254.digest_to_fr(words)))
        self.pos += 8 * n
        return out

    def commit(self, digest: Sig):
        self.rng.mix(digest)

    def verify_complete(self):
        if self.pos != len(self.seal):
            raise ValueError(
                f"seal not fully consumed: {self.pos} != {len(self.seal)}")


def _const_digest(cs: CS, data: np.ndarray) -> Sig:
    """Constant digest of constant data (transcript headers)."""
    from ..hash.suite import POSEIDON254

    return cs.const(p254.digest_to_fr(POSEIDON254.hash_elem_slice(data)))


class MerkleGadget:
    """MerkleTreeVerifier (verify/merkle.rs) with static depth and a
    top-layer mux."""

    def __init__(self, cs: CS, iop: IopGadget, row_size: int, col_size: int,
                 queries: int = QUERIES):
        self.cs = cs
        self.row_size = row_size
        self.col_size = col_size
        _, self.top_size = merkle_params(row_size, queries)
        top = iop.read_digests(self.top_size)
        rest: list = [None] * max(self.top_size - 1, 0)
        for i in range(self.top_size - 1, 0, -1):
            if 2 * i >= self.top_size:
                a, b = top[2 * i - self.top_size], top[2 * i + 1 - self.top_size]
            else:
                a, b = rest[2 * i - 1], rest[2 * i]
            rest[i - 1] = G.p254_hash_pair(cs, a, b)
        self.top = top
        self.root = top[0] if self.top_size == 1 else rest[0]
        iop.commit(self.root)

    def verify(self, iop: IopGadget, pos_bits: list[Sig]) -> list[BB]:
        cs = self.cs
        levels = _log2(self.row_size) - _log2(self.top_size)
        if len(pos_bits) != _log2(self.row_size):
            raise ValueError(f"{len(pos_bits)} position bits")
        out = iop.read_field_elems(self.col_size)
        cur = G.p254_hash_slice(cs, out)
        for lvl in range(levels):
            bit = pos_bits[lvl]
            other = iop.read_digests(1)[0]
            # bit == 1 -> cur is the right child
            delta = other - cur
            left = cur + cs.mul(bit, delta)          # bit ? other : cur
            right = other - cs.mul(bit, delta)       # bit ? cur : other
            cur = G.p254_hash_pair(cs, left, right)
        sel = pos_bits[levels:]
        expected = cs.mux(sel, self.top)
        cs.assert_eq(cur, expected)
        return out


def _pow_bits(cs: CS, base: int, bits: list[Sig]) -> BB:
    """base^(value of bits) as a BB, via per-bit constant factors."""
    acc = G.bb_const(cs, 1)
    for i, b in enumerate(bits):
        c = pow(base, 1 << i, F.P)
        # factor = 1 + b*(c - 1)
        fac = BB(cs.one() + b.scale(c - 1), max(c, 1))
        acc = G.bb_mul(cs, acc, fac)
        if acc.bound > (1 << 160):
            acc = G.bb_reduce(cs, acc)
    return acc


_INTT16 = None


def _intt16_matrix() -> np.ndarray:
    """Constant 16x16 standard-form matrix of verify/fri.rs fold's
    iNTT+bit-reverse (derived by probing _ext_intt16 with basis vectors)."""
    global _INTT16
    if _INTT16 is None:
        m = np.zeros((16, 16), np.uint32)
        for j in range(16):
            basis = np.zeros((16, 4), np.uint32)
            basis[j, 0] = F.R % F.P  # Montgomery ONE
            col = _ext_intt16(basis)[:, 0]
            m[:, j] = F.decode_np(col)
        _INTT16 = m
    return _INTT16


class FriRoundGadget:
    def __init__(self, cs: CS, iop: IopGadget, in_domain: int):
        self.cs = cs
        self.in_domain = in_domain
        self.domain = in_domain // FRI_FOLD
        self.merkle = MerkleGadget(cs, iop, self.domain,
                                   FRI_FOLD * EXT_SIZE)
        self.mix = iop.rng.random_ext_elem()

    def verify_query(self, iop: IopGadget, pos_bits: list[Sig], goal):
        cs = self.cs
        gbits = _log2(self.domain)
        group_bits = pos_bits[:gbits]
        quot_bits = pos_bits[gbits:]
        if len(quot_bits) != 4:
            raise ValueError(f"{len(quot_bits)} quotient bits")
        data = self.merkle.verify(iop, group_bits)   # 64 canonical BBs
        # data_ext[i][c] = data[c*16 + i]
        data_ext = [[data[c * FRI_FOLD + i] for c in range(EXT_SIZE)]
                    for i in range(FRI_FOLD)]
        # data_ext[quot] == goal
        for c in range(EXT_SIZE):
            selected = cs.mux(quot_bits,
                              [data_ext[i][c].sig for i in range(FRI_FOLD)])
            G.bb_assert_eq(cs, BB(selected, F.P - 1), goal[c])
        root_po2 = _log2(self.in_domain)
        inv_wk = _pow_bits(cs, F.ROU_REV[root_po2], group_bits)
        # coeffs = iNTT16(data_ext): linear with the constant matrix
        M = _intt16_matrix()
        coeffs = []
        for j in range(FRI_FOLD):
            row = []
            for c in range(EXT_SIZE):
                acc = G.bb_const(cs, 0)
                for i in range(FRI_FOLD):
                    acc = G.bb_add(acc, G.bb_scale(data_ext[i][c],
                                                   int(M[j, i])))
                row.append(acc)
            coeffs.append(row)
        x = G.ext_mul_base(cs, self.mix, inv_wk)
        new_goal = G.poly_eval_ext(cs, coeffs, x)
        return group_bits, new_goal


class StarkVerifyBuilder:
    """Builds the verifier R1CS over a concrete seal; the constraint
    structure depends only on (circuit, po2), so the same CRS serves every
    identity_p254 receipt."""

    def __init__(self, seal, po2: int | None = None, circuit=None,
                 check: bool = False, poly_ext_gadget=None,
                 bind_publics=None):
        from ..circuit.recursion.circuit import RECURSION_PO2, load_circuit

        self.circuit = circuit or load_circuit()
        self.po2 = po2 if po2 is not None else RECURSION_PO2
        self._poly_ext_gadget = poly_ext_gadget
        self._bind_publics_fn = bind_publics
        cs = self.cs = CS(check=check)
        self.pub_a0 = cs.alloc_public()
        self.pub_a1 = cs.alloc_public()
        self.pub_c0 = cs.alloc_public()
        self.pub_c1 = cs.alloc_public()
        self.pub_id = cs.alloc_public()
        self.iop = IopGadget(cs, seal)
        self._build()

    # -- protocol stages ---------------------------------------------------

    def _build(self):
        cs, iop, taps = self.cs, self.iop, self.circuit.taps
        po2 = self.po2
        tot_cycles = 1 << po2
        domain = INV_RATE * tot_cycles

        # commit_circuit_info (constant digests)
        for info in (PROOF_SYSTEM_INFO, self.circuit.CIRCUIT_INFO):
            enc = F.encode_np(np.frombuffer(
                info.ljust(16, b"\0")[:16], np.uint8).astype(np.uint32))
            iop.commit(_const_digest(cs, enc))

        # globals + po2
        slice_ = iop.read_field_elems(self.circuit.OUTPUT_SIZE + 1)
        flat = slice_
        iop.commit(G.p254_hash_slice(cs, flat))
        self.out = slice_[: self.circuit.OUTPUT_SIZE]
        # the po2 word is RAW in the seal (prove writes Val::new_raw(po2));
        # the witness carries decoded values, so raw == po2 <=> witness
        # value == decode(po2)
        G.bb_assert_eq(cs, slice_[-1], G.bb_const(cs, F.s_decode(po2)))

        # group commits: CODE (root -> public id), DATA, mix, ACCUM
        merkles: list = [None] * taps.num_groups
        merkles[REGISTER_GROUP_CODE] = MerkleGadget(
            cs, iop, domain, taps.group_size(REGISTER_GROUP_CODE))
        self.code_root = merkles[REGISTER_GROUP_CODE].root
        merkles[REGISTER_GROUP_DATA] = MerkleGadget(
            cs, iop, domain, taps.group_size(REGISTER_GROUP_DATA))
        self.mix_elems = [iop.rng.random_elem()
                          for _ in range(self.circuit.MIX_SIZE)]
        merkles[REGISTER_GROUP_ACCUM] = MerkleGadget(
            cs, iop, domain, taps.group_size(REGISTER_GROUP_ACCUM))
        self.merkles = merkles

        self._verify_validity(domain, tot_cycles)
        iop.verify_complete()
        if self._bind_publics_fn is not None:
            self._bind_publics_fn(self)
        else:
            self._bind_publics()
        cs.finalize()

    def _verify_validity(self, domain: int, tot_cycles: int):
        cs, iop, taps = self.cs, self.iop, self.circuit.taps
        poly_mix = iop.rng.random_ext_elem()
        check_merkle = MerkleGadget(cs, iop, domain, CHECK_SIZE)
        z = iop.rng.random_ext_elem()
        back_one = F.ROU_REV[self.po2]

        num_taps = taps.tap_size
        coeff_flat = iop.read_field_elems((num_taps + CHECK_SIZE) * EXT_SIZE)
        iop.commit(G.p254_hash_slice(cs, coeff_flat))
        coeff_u = [coeff_flat[4 * i: 4 * i + 4]
                   for i in range(num_taps + CHECK_SIZE)]

        # per-tap evaluations at z * back_one^back
        cur_pos = 0
        eval_u = []
        for reg in taps.regs:
            for i in range(reg.size):
                xs = G.ext_scale(z, pow(back_one, reg.backs[i], F.P))
                eval_u.append(G.poly_eval_ext(
                    cs, coeff_u[cur_pos: cur_pos + reg.size], xs))
            cur_pos += reg.size

        if self._poly_ext_gadget is not None:
            result = self._poly_ext_gadget(self, poly_mix, eval_u)
        else:
            result = self._poly_ext(poly_mix, eval_u)

        # check-poly reconstruction (verify/mod.rs:371-396)
        remap = [0, 2, 1, 3]
        check = G.ext_zero(cs)
        zpows = [G.ext_one(cs)]  # zpows[i] = z^i
        for _ in range(3):
            zpows.append(G.ext_mul(cs, zpows[-1], z))
        for i, rmi in enumerate(remap):
            for j in range(4):
                term = G.ext_mul(cs, coeff_u[num_taps + rmi + 4 * j],
                                 zpows[i])
                basis = [0, 0, 0, 0]
                basis[j] = 1
                term = G.ext_mul(cs, term, G.ext_const(cs, basis))
                check = G.ext_add(check, term)
        tz = G.ext_scale(z, 3)
        factor = G.ext_sub(G.ext_pow2k(cs, tz, self.po2), G.ext_one(cs))
        check = G.ext_mul(cs, check, factor)
        G.ext_assert_eq(cs, check, result)

        mix = iop.rng.random_ext_elem()

        # combo_u + mix powers (verify/mod.rs:402-441)
        combo_u = [G.ext_zero(cs)
                   for _ in range(taps.tot_combo_backs + 1)]
        cur_mix = G.ext_one(cs)
        cur_pos = 0
        tap_mix_pows = []
        for reg in taps.regs:
            for i in range(reg.size):
                cb = taps.combo_begin[reg.combo_id] + i
                combo_u[cb] = G.ext_add(
                    combo_u[cb], G.ext_mul(cs, cur_mix, coeff_u[cur_pos + i]))
            tap_mix_pows.append(cur_mix)
            cur_mix = G.ext_mul(cs, cur_mix, mix)
            cur_pos += reg.size
        check_mix_pows = []
        for _ in range(CHECK_SIZE):
            combo_u[taps.tot_combo_backs] = G.ext_add(
                combo_u[taps.tot_combo_backs],
                G.ext_mul(cs, cur_mix, coeff_u[cur_pos]))
            cur_pos += 1
            check_mix_pows.append(cur_mix)
            cur_mix = G.ext_mul(cs, cur_mix, mix)
        # normalize accumulated combo rows
        combo_u = [G.ext_reduce(cs, row) for row in combo_u]
        tap_mix_pows = [G.ext_reduce(cs, e) for e in tap_mix_pows]
        check_mix_pows = [G.ext_reduce(cs, e) for e in check_mix_pows]

        gen = F.ROU_FWD[_log2(domain)]

        def inner(pos_bits):
            rows = [m.verify(iop, pos_bits) for m in self.merkles]
            check_row = check_merkle.verify(iop, pos_bits)
            x = _pow_bits(cs, gen, pos_bits)
            return self._fri_eval_taps(
                combo_u, check_row, back_one, x, z, rows,
                tap_mix_pows, check_mix_pows)

        self._fri_verify(inner, tot_cycles, domain)

    def _poly_ext(self, poly_mix, eval_u):
        """PolyExtStep IR interpreter over ext gadget values
        (circuit/recursion/circuit.py:44-97)."""
        from ..circuit.recursion.circuit import (ADD, ANDCOND, ANDEQZ, CONST,
                                                 CONSTEXT, GET, GETGLOBAL,
                                                 MUL, SUB, TRUE)

        cs = self.cs
        args = [self.out, self.mix_elems]
        fp_vars = []
        mix_vars = []
        for op, row in zip(self.circuit.opcode, self.circuit.operands):
            a, b, c, d = (int(x) for x in row)
            if op == CONST:
                fp_vars.append(G.ext_const(cs, [a, 0, 0, 0]))
            elif op == CONSTEXT:
                fp_vars.append(G.ext_const(cs, [a, b, c, d]))
            elif op == GET:
                fp_vars.append(eval_u[a])
            elif op == GETGLOBAL:
                fp_vars.append(G.ext_from_base(args[a][b], cs))
            elif op == ADD:
                fp_vars.append(G.ext_add(fp_vars[a], fp_vars[b]))
            elif op == SUB:
                fp_vars.append(G.ext_sub(fp_vars[a], fp_vars[b]))
            elif op == MUL:
                fp_vars.append(G.ext_mul(cs, fp_vars[a], fp_vars[b]))
            elif op == TRUE:
                mix_vars.append((G.ext_zero(cs), G.ext_one(cs)))
            elif op == ANDEQZ:
                tot, mul = mix_vars[a]
                inner = fp_vars[b]
                mix_vars.append((G.ext_add(tot, G.ext_mul(cs, mul, inner)),
                                 G.ext_mul(cs, mul, poly_mix)))
            elif op == ANDCOND:
                tot, mul = mix_vars[a]
                cond = fp_vars[b]
                itot, imul = mix_vars[c]
                mix_vars.append((
                    G.ext_add(tot, G.ext_mul(
                        cs, G.ext_mul(cs, cond, itot), mul)),
                    G.ext_mul(cs, mul, imul)))
            else:
                raise ValueError(f"bad poly_ext opcode {op}")
        return mix_vars[int(self.circuit.ret)][0]

    def _fri_eval_taps(self, combo_u, check_row, back_one, x: BB, z, rows,
                       tap_mix_pows, check_mix_pows):
        """verify/mod.rs:246-285."""
        cs, taps = self.cs, self.circuit.taps
        combo_count = taps.combos_size
        tot = [G.ext_zero(cs) for _ in range(combo_count + 1)]
        for reg, cur in zip(taps.regs, tap_mix_pows):
            val = rows[reg.group][reg.offset]
            tot[reg.combo_id] = G.ext_add(tot[reg.combo_id],
                                          G.ext_mul_base(cs, cur, val))
        for i in range(CHECK_SIZE):
            tot[combo_count] = G.ext_add(
                tot[combo_count],
                G.ext_mul_base(cs, check_mix_pows[i], check_row[i]))
        ret = G.ext_zero(cs)
        x_ext = G.ext_from_base(x, cs)
        for i in range(combo_count):
            num = G.ext_sub(
                tot[i],
                G.poly_eval_ext(
                    cs, combo_u[taps.combo_begin[i]: taps.combo_begin[i + 1]],
                    x_ext))
            divisor = G.ext_one(cs)
            for back in taps.combos[i]:
                divisor = G.ext_mul(
                    cs, divisor,
                    G.ext_sub(x_ext,
                              G.ext_scale(z, pow(back_one, back, F.P))))
            ret = G.ext_add(ret, G.ext_mul(cs, num, G.ext_inv(cs, divisor)))
        check_num = G.ext_sub(tot[combo_count], combo_u[taps.tot_combo_backs])
        zp4 = G.ext_pow2k(cs, z, 2)  # z^INV_RATE, INV_RATE = 4
        check_div = G.ext_sub(x_ext, zp4)
        ret = G.ext_add(ret, G.ext_mul(cs, check_num,
                                       G.ext_inv(cs, check_div)))
        return ret

    def _fri_verify(self, inner, degree: int, orig_domain: int):
        """verify/fri.rs:98-160."""
        cs, iop = self.cs, self.iop
        domain = orig_domain
        rounds = []
        while degree > FRI_MIN_DEGREE:
            rounds.append(FriRoundGadget(cs, iop, domain))
            domain //= FRI_FOLD
            degree //= FRI_FOLD
        final_flat = iop.read_field_elems(EXT_SIZE * degree)
        iop.commit(G.p254_hash_slice(cs, final_flat))
        # final_ext[i][c] = final_flat[c*degree + i]
        final_ext = [[final_flat[c * degree + i] for c in range(EXT_SIZE)]
                     for i in range(degree)]
        gen = F.ROU_FWD[_log2(domain)]
        for _ in range(QUERIES):
            pos_bits = iop.rng.random_bits(_log2(orig_domain))
            goal = inner(pos_bits)
            for rnd in rounds:
                pos_bits, goal = rnd.verify_query(iop, pos_bits, goal)
            x = _pow_bits(cs, gen, pos_bits)
            fx = G.poly_eval_ext(cs, final_ext, G.ext_from_base(x, cs))
            G.ext_assert_eq(cs, fx, goal)

    def _bind_publics(self):
        """Public-input binding: (a0, a1) = split control root (globals even
        slots), (c0, c1) = split claim digest (globals[16:32] sha halfs),
        id_bn254 = CODE group root (receipt.py:187-199 + verifier.rs
        split_digest semantics)."""
        cs = self.cs
        # control root: 8 u32 words at out[0:16:2]
        root_words = [self.out[2 * i] for i in range(8)]
        a0 = cs.zero()
        a1 = cs.zero()
        for i in range(4):
            a0 = a0 + root_words[i].sig.scale(1 << (32 * i))
            a1 = a1 + root_words[4 + i].sig.scale(1 << (32 * i))
        cs.bind_public(self.pub_a0, a0)
        cs.bind_public(self.pub_a1, a1)
        # claim digest: 16 shorts at out[16:32]
        halfs = self.out[16:32]
        for h in halfs:
            cs.bits(h.sig, 16)  # canonical BB < P, additionally < 2^16
        c0 = cs.zero()
        c1 = cs.zero()
        for j in range(8):
            c0 = c0 + halfs[j].sig.scale(1 << (16 * j))
            c1 = c1 + halfs[8 + j].sig.scale(1 << (16 * j))
        cs.bind_public(self.pub_c0, c0)
        cs.bind_public(self.pub_c1, c1)
        cs.bind_public(self.pub_id, self.code_root)

    # -- results -------------------------------------------------------------

    def public_values(self) -> list[int]:
        return self.cs.values[1:6]
