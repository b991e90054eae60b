"""STARK verifier (host side; counterpart of risc0_tpu/verify/verifier.py).

Mirrors the reference no_std verifier (risc0/zkp/src/verify/{mod,fri,merkle,
read_iop}.rs): replays the transcript, checks Merkle openings, recomputes the
check polynomial via the circuit's poly_ext, and verifies FRI.
"""

from __future__ import annotations

import numpy as np

from .. import field as F
from ..core import poly
from ..core.ntt import _bitrev_perm, _twiddles
from ..prove.merkle import merkle_params
from ..taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                    REGISTER_GROUP_DATA)

INV_RATE = 4
EXT_SIZE = 4
CHECK_SIZE = INV_RATE * EXT_SIZE
QUERIES = 50
FRI_FOLD = 16
FRI_MIN_DEGREE = 256
MAX_CYCLES_PO2 = 24

PROOF_SYSTEM_INFO = b"RISC0_STARK:v1__"


class VerificationError(Exception):
    pass


class ReadIOP:
    """reference: risc0/zkp/src/verify/read_iop.rs"""

    def __init__(self, suite, seal: np.ndarray):
        self.suite = suite
        self.rng = suite.new_rng()
        self.seal = np.asarray(seal, np.uint32)
        self.pos = 0

    def read_u32s(self, n: int) -> np.ndarray:
        if self.pos + n > len(self.seal):
            raise VerificationError("seal too short")
        out = self.seal[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_field_elems(self, n: int) -> np.ndarray:
        out = self.read_u32s(n)
        if np.any(out >= F.P):
            raise VerificationError("invalid field element in seal")
        return out

    def read_digests(self, n: int) -> np.ndarray:
        return self.read_u32s(n * 8).reshape(n, 8)

    def commit(self, digest):
        self.rng.mix(digest)

    def verify_complete(self):
        if self.pos != len(self.seal):
            raise VerificationError(
                f"seal not fully consumed: {self.pos} != {len(self.seal)}")

    def random_bits(self, bits):
        return self.rng.random_bits(bits)

    def random_elem(self):
        return self.rng.random_elem()

    def random_ext_elem(self):
        return self.rng.random_ext_elem()


class MerkleTreeVerifier:
    """reference: risc0/zkp/src/verify/merkle.rs"""

    def __init__(self, iop: ReadIOP, row_size: int, col_size: int, queries: int = QUERIES):
        self.suite = iop.suite
        self.row_size = row_size
        self.col_size = col_size
        _, self.top_size = merkle_params(row_size, queries)
        top = iop.read_digests(self.top_size)
        # rest[i] = digest at virtual heap index i+1, i in [0, top_size-1)
        rest = [None] * max(self.top_size - 1, 0)
        for i in range(self.top_size - 1, 0, -1):
            if 2 * i >= self.top_size:
                a, b = top[2 * i - self.top_size], top[2 * i + 1 - self.top_size]
            else:
                a, b = rest[2 * i - 1], rest[2 * i]
            rest[i - 1] = self.suite.hash_pair(a, b)
        self.top = top
        self.rest = rest
        self._root = top[0] if self.top_size == 1 else rest[0]
        iop.commit(self._root)

    def root(self):
        return self._root

    def verify(self, iop: ReadIOP, idx: int) -> np.ndarray:
        if idx >= self.row_size:
            raise VerificationError("merkle query out of range")
        out = iop.read_field_elems(self.col_size)
        cur = self.suite.hash_elem_slice(out)
        idx += self.row_size
        while idx >= 2 * self.top_size:
            low_bit = idx % 2
            other = iop.read_digests(1)[0]
            idx //= 2
            if low_bit:
                cur = self.suite.hash_pair(other, cur)
            else:
                cur = self.suite.hash_pair(cur, other)
        expected = self.top[idx - self.top_size] if idx >= self.top_size else self.rest[idx - 1]
        if not np.array_equal(np.asarray(expected), cur):
            raise VerificationError("merkle branch mismatch")
        return out


def _ext_intt16(data):
    """iNTT + bit-reverse of 16 ext elems (verify/fri.rs:73-78)."""
    x = np.asarray(data, np.uint32)  # (16, 4)
    n_bits = 4
    for l in range(n_bits, 0, -1):
        half = 1 << (l - 1)
        stride = 1 << (n_bits - l)
        tw = _twiddles(n_bits, fwd=False)[::stride]  # (half,)
        y = x.reshape(-1, 2, half, 4)
        a, b = y[:, 0], y[:, 1]
        y = np.stack([F.add_np(a, b), F.mul_np(F.sub_np(a, b), tw[None, :, None])], axis=1)
        x = y.reshape(16, 4)
    norm = F.s_inv(F.s_encode(16))
    x = F.mul_np(x, np.uint32(norm))
    return x[_bitrev_perm(4)]


class _FriRoundVerifier:
    def __init__(self, iop: ReadIOP, in_domain: int):
        self.domain = in_domain // FRI_FOLD
        self.merkle = MerkleTreeVerifier(iop, self.domain, FRI_FOLD * EXT_SIZE)
        self.mix = iop.random_ext_elem()

    def verify_query(self, iop: ReadIOP, pos: int, goal):
        quot, group = divmod(pos, self.domain)
        data = self.merkle.verify(iop, group)
        data_ext = data.reshape(EXT_SIZE, FRI_FOLD).T.copy()  # (16, 4)
        if not np.array_equal(data_ext[quot], goal):
            raise VerificationError("FRI fold mismatch")
        root_po2 = (FRI_FOLD * self.domain).bit_length() - 1
        inv_wk = F.s_pow(F.s_encode(F.ROU_REV[root_po2]), group)
        coeffs = _ext_intt16(data_ext)
        x = F.mul_np(self.mix, np.uint32(inv_wk))
        new_goal = poly.poly_eval(coeffs, x)
        return group, new_goal


class Verifier:
    """reference: risc0/zkp/src/verify/mod.rs:160-492"""

    def __init__(self, taps, suite, seal, iop_cls=ReadIOP):
        self.taps = taps
        self.suite = suite
        self.iop = iop_cls(suite, seal)
        self.po2 = None
        self.tot_cycles = 0
        self.merkle_verifiers = [None] * taps.num_groups

    def commit_circuit_info(self, circuit_info: bytes):
        enc = F.encode_np(np.frombuffer(PROOF_SYSTEM_INFO.ljust(16, b"\0")[:16], np.uint8).astype(np.uint32))
        self.iop.commit(self.suite.hash_elem_slice(enc))
        enc = F.encode_np(np.frombuffer(circuit_info.ljust(16, b"\0")[:16], np.uint8).astype(np.uint32))
        self.iop.commit(self.suite.hash_elem_slice(enc))

    def read_slice_with_po2(self, size: int):
        slice_ = self.iop.read_field_elems(size + 1)
        self.iop.commit(self.suite.hash_elem_slice(slice_))
        # po2 is written as a *raw* word (reference rv32im prove/hal/mod.rs:
        # Val::new_raw(po2); verify/mod.rs reads to_u32_words() undecoded)
        out, po2_elem = slice_[:size], slice_[size]
        po2 = int(po2_elem)
        if po2 > MAX_CYCLES_PO2:
            raise VerificationError(f"po2 {po2} out of range")
        self.po2 = po2
        self.tot_cycles = 1 << po2
        return out, po2

    def verify_group(self, group_id: int):
        assert self.merkle_verifiers[group_id] is None
        domain = INV_RATE * self.tot_cycles
        mv = MerkleTreeVerifier(self.iop, domain, self.taps.group_size(group_id))
        self.merkle_verifiers[group_id] = mv
        return mv.root()

    def read_rng(self, n: int) -> np.ndarray:
        return np.array([self.iop.random_elem() for _ in range(n)], np.uint32)

    def verify_validity(self, validity_fn):
        taps = self.taps
        iop = self.iop
        assert all(m is not None for m in self.merkle_verifiers)
        poly_mix = iop.random_ext_elem()
        domain = INV_RATE * self.tot_cycles
        check_merkle = MerkleTreeVerifier(iop, domain, CHECK_SIZE)
        z = iop.random_ext_elem()
        back_one = F.s_encode(F.ROU_REV[self.po2])

        num_taps = taps.tap_size
        coeff_u = iop.read_field_elems((num_taps + CHECK_SIZE) * EXT_SIZE)
        iop.commit(self.suite.hash_elem_slice(coeff_u))
        coeff_u = coeff_u.reshape(-1, EXT_SIZE)

        # openings -> evaluations per tap
        cur_pos = 0
        eval_u = []
        for reg in taps.regs:
            for i in range(reg.size):
                x = F.ext_mul_np(_pow_ext(back_one, reg.backs[i]), z)
                eval_u.append(poly.poly_eval(coeff_u[cur_pos : cur_pos + reg.size], x))
            cur_pos += reg.size
        eval_u = np.stack(eval_u)

        result = validity_fn(poly_mix, eval_u)

        # reconstruct check value from check-poly openings (verify/mod.rs:371-396)
        remap = [0, 2, 1, 3]
        check = poly.ext_zero()
        for i, rmi in enumerate(remap):
            zi = F.ext_pow_np(z, i)
            for j in range(4):
                basis = np.zeros(4, np.uint32)
                basis[j] = F.R % F.P  # ONE in ext slot j
                term = F.ext_mul_np(
                    F.ext_mul_np(coeff_u[num_taps + rmi + 4 * j], zi), basis)
                check = F.add_np(check, term)
        three = F.s_encode(3)
        tz = F.ext_mul_np(_pow_ext(three, 1), z)
        factor = F.sub_np(F.ext_pow_np(tz, self.tot_cycles), poly.ext_one())
        check = F.ext_mul_np(check, factor)
        if not np.array_equal(check, result):
            raise VerificationError("check polynomial mismatch")

        mix = iop.random_ext_elem()

        # build combo_u + mix powers (verify/mod.rs:402-441)
        combo_u = np.zeros((taps.tot_combo_backs + 1, 4), np.uint32)
        cur_mix = poly.ext_one()
        cur_pos = 0
        tap_mix_pows = []
        for reg in taps.regs:
            for i in range(reg.size):
                cb = taps.combo_begin[reg.combo_id] + i
                combo_u[cb] = F.add_np(combo_u[cb], F.ext_mul_np(cur_mix, coeff_u[cur_pos + i]))
            tap_mix_pows.append(cur_mix)
            cur_mix = F.ext_mul_np(cur_mix, mix)
            cur_pos += reg.size
        check_mix_pows = []
        for _ in range(CHECK_SIZE):
            combo_u[taps.tot_combo_backs] = F.add_np(
                combo_u[taps.tot_combo_backs], F.ext_mul_np(cur_mix, coeff_u[cur_pos]))
            cur_pos += 1
            check_mix_pows.append(cur_mix)
            cur_mix = F.ext_mul_np(cur_mix, mix)

        gen = F.s_encode(F.ROU_FWD[domain.bit_length() - 1])

        def inner(idx):
            rows = [m.verify(iop, idx) for m in self.merkle_verifiers]
            check_row = check_merkle.verify(iop, idx)
            return self._fri_eval_taps(
                combo_u, check_row, back_one, F.s_pow(gen, idx), z, rows,
                tap_mix_pows, check_mix_pows)

        self._fri_verify(inner)

    def _fri_eval_taps(self, combo_u, check_row, back_one, x, z, rows,
                       tap_mix_pows, check_mix_pows):
        """reference: verify/mod.rs:246-285"""
        taps = self.taps
        combo_count = taps.combos_size
        tot = np.zeros((combo_count + 1, 4), np.uint32)
        for reg, cur in zip(taps.regs, tap_mix_pows):
            val = rows[reg.group][reg.offset]
            tot[reg.combo_id] = F.add_np(tot[reg.combo_id], F.mul_np(cur, np.uint32(val)))
        for i in range(CHECK_SIZE):
            tot[combo_count] = F.add_np(
                tot[combo_count], F.mul_np(check_mix_pows[i], np.uint32(check_row[i])))
        ret = poly.ext_zero()
        x_ext = _scalar_ext(x)
        for i in range(combo_count):
            num = F.sub_np(
                tot[i],
                poly.poly_eval(combo_u[taps.combo_begin[i] : taps.combo_begin[i + 1]], x_ext))
            divisor = poly.ext_one()
            for back in taps.combos[i]:
                divisor = F.ext_mul_np(
                    divisor, F.sub_np(x_ext, F.ext_mul_np(z, _pow_ext(back_one, back))))
            ret = F.add_np(ret, F.ext_mul_np(num, F.ext_inv_np(divisor)))
        check_num = F.sub_np(tot[combo_count], combo_u[taps.tot_combo_backs])
        check_div = F.sub_np(x_ext, F.ext_pow_np(z, INV_RATE))
        ret = F.add_np(ret, F.ext_mul_np(check_num, F.ext_inv_np(check_div)))
        return ret

    def _fri_verify(self, inner):
        """reference: verify/fri.rs:98-160"""
        iop = self.iop
        degree = self.tot_cycles
        orig_domain = INV_RATE * degree
        domain = orig_domain
        rounds = []
        while degree > FRI_MIN_DEGREE:
            rounds.append(_FriRoundVerifier(iop, domain))
            domain //= FRI_FOLD
            degree //= FRI_FOLD
        final_coeffs = iop.read_field_elems(EXT_SIZE * degree)
        iop.commit(self.suite.hash_elem_slice(final_coeffs))
        final_ext = final_coeffs.reshape(EXT_SIZE, degree).T.copy()  # (degree, 4)
        gen = F.s_encode(F.ROU_FWD[domain.bit_length() - 1])
        for _ in range(QUERIES):
            pos = iop.random_bits(orig_domain.bit_length() - 1)
            goal = inner(pos)
            for rnd in rounds:
                pos, goal = rnd.verify_query(iop, pos, goal)
            x = F.s_pow(gen, pos)
            fx = poly.poly_eval(final_ext, _scalar_ext(x))
            if not np.array_equal(fx, goal):
                raise VerificationError("final FRI poly mismatch")


def _pow_ext(base_mont: int, e: int) -> np.ndarray:
    out = np.zeros(4, np.uint32)
    out[0] = F.s_pow(base_mont, e)
    return out


def _scalar_ext(x_mont: int) -> np.ndarray:
    out = np.zeros(4, np.uint32)
    out[0] = x_mont
    return out


def verify(circuit, suite, seal, check_code, iop_cls=ReadIOP):
    """Full protocol entry (reference verify/mod.rs:500-563).

    circuit must provide: taps, CIRCUIT_INFO (bytes), OUTPUT_SIZE, MIX_SIZE,
    poly_ext(poly_mix, eval_u, out, mix) -> ext value.
    check_code(po2, code_root) raises on mismatch.  `iop_cls` reads the
    seal (a ReadIOP subclass may record what each read takes, as
    ``groth16/seal_to_json.py`` does).
    """
    if len(seal) == 0:
        raise VerificationError("empty seal")
    v = Verifier(circuit.taps, suite, seal, iop_cls=iop_cls)
    try:
        v.commit_circuit_info(circuit.CIRCUIT_INFO)
        out, po2 = v.read_slice_with_po2(circuit.OUTPUT_SIZE)
        code_root = v.verify_group(REGISTER_GROUP_CODE)
        check_code(po2, code_root)
        v.verify_group(REGISTER_GROUP_DATA)
        mix = v.read_rng(circuit.MIX_SIZE)
        v.verify_group(REGISTER_GROUP_ACCUM)
        v.verify_validity(lambda poly_mix, eval_u: circuit.poly_ext(
            poly_mix, eval_u, out, mix))
    except ValueError as e:
        # a seal digest that the suite cannot read (Poseidon254 takes
        # only canonical BN254 scalars)
        raise VerificationError(f"malformed seal: {e}") from e
    v.iop.verify_complete()
    return out
