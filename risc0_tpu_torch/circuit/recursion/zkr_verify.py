"""In-VM STARK verifier generator: compile the host verifier into
recursion-VM code rows (the port's host copy of
``risc0_tpu/circuit/recursion/zkr_verify.py``; our equivalent of zirgen's
predicates).

This module traces the host verifier algorithm (verify/verifier.py, ==
risc0/zkp/src/verify/mod.rs) for a FIXED (circuit, po2) and emits
recursion-VM micro/macro/poseidon rows via the assembler.  The emitted
program reads a seal from the VM input tape, replays the Fiat-Shamir
transcript with in-VM Poseidon2 sponge rows, verifies all Merkle openings
and FRI, and evaluates the circuit's constraint polynomial at the DEEP
point.

Form convention: every WOM value is the ABSTRACT (standard-form) field value;
seal words are read with do_mont=0 (the k=1 IOP read decodes the Montgomery
raw word), poseidon loads/stores use do_mont=0, so in-VM sponge state equals
decode(host Montgomery state) cell-by-cell.  Constants stay Python ints.
"""

from __future__ import annotations

import numpy as np

from ... import field as F
from ...hash.suite import POSEIDON2
from ...prove.merkle import merkle_params
from ...verify.verifier import (CHECK_SIZE, EXT_SIZE, FRI_FOLD,
                                FRI_MIN_DEGREE, INV_RATE, PROOF_SYSTEM_INFO,
                                QUERIES)
from .asm import Asm

P = F.P
R_INV = pow(F.R % P, P - 2, P)


def _std(x):
    """abstract value of a Montgomery word."""
    return int(x) * R_INV % P


def _info_digest_std(info: bytes):
    """abstract cells of hash_elem_slice(encode(info bytes))."""
    enc = F.encode_np(np.frombuffer(
        info.ljust(16, b"\0")[:16], np.uint8).astype(np.uint32))
    d = POSEIDON2.hash_elem_slice(enc)
    return [_std(w) for w in d]


class Gen:
    """Emission context: sponge/RNG/merkle/poly helpers over an Asm."""

    def __init__(self, asm: Asm):
        self.a = asm
        self.rng = _Rng(self)

    # ---- ext helpers ------------------------------------------------------

    def x_pows(self):
        a = self.a
        if not hasattr(self, "_xp"):
            x1 = a.const(0, 1)
            x2 = a.mul(x1, x1)
            x3 = a.mul(x2, x1)
            self._xp = (x1, x2, x3)
        return self._xp

    def combine4(self, c0, c1, c2, c3):
        """4 base cells -> ext value c0 + c1 x + c2 x^2 + c3 x^3."""
        a = self.a
        x1, x2, x3 = self.x_pows()
        lo = a.add(c0, a.mul(c1, x1))
        hi = a.add(a.mul(c2, x2), a.mul(c3, x3))
        return a.add(lo, hi)

    def const_ext(self, vals):
        return self.a.const_ext(vals)

    def pow_static(self, base, e: int):
        """base^e for a dynamic base and static exponent."""
        a = self.a
        if e == 0:
            return a.const(1)
        sq, acc = base, None
        while e:
            if e & 1:
                acc = sq if acc is None else a.mul(acc, sq)
            e >>= 1
            if e:
                sq = a.mul(sq, sq)
        return acc

    def pow_sq(self, base, log2e: int):
        """base^(2^log2e)."""
        a = self.a
        for _ in range(log2e):
            base = a.mul(base, base)
        return base

    def pow_bits(self, base_std: int, bits):
        """(const base)^(dynamic exponent given by normalized bit cells):
        product over i of select(bits[i], [1, base^(2^i)])."""
        a = self.a
        acc = None
        cur = base_std % P
        for b in bits:
            one = a.const(1)
            pw = a.const(cur)
            # contiguous pair [1, pw] not guaranteed; use arithmetic select:
            # f = 1 + b*(pw - 1)
            f = a.add(one, a.mul(b, a.sub(pw, one)))
            acc = f if acc is None else a.mul(acc, f)
            cur = cur * cur % P
        return acc if acc is not None else a.const(1)

    def poly_eval(self, coeffs, x):
        """Horner over ext coeff addrs at dynamic ext x."""
        a = self.a
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = a.add(a.mul(acc, x), c)
        return acc

    def eq_digest(self, d1, d2):
        for w1, w2 in zip(d1, d2):
            self.a.eq(w1, w2)

    # ---- IOP reads ----------------------------------------------------------

    def read_elems(self, n):
        """n abstract field cells from the tape (k=1 decode reads)."""
        a = self.a
        out = []
        left = n
        while left:
            take = min(left, 65535)
            a.read_iop_header(take, k=1)
            out.extend(a.read_iop_body(do_mont=False) for _ in range(take))
            left -= take
        return out

    def read_digests(self, n):
        cells = self.read_elems(8 * n)
        return [cells[8 * i: 8 * i + 8] for i in range(n)]

    # ---- sponge -------------------------------------------------------------

    def absorb(self, addrs, first, last_prep=True):
        """Absorb len<=16 cells: SET into rate (keep_upper keeps capacity)."""
        a = self.a
        blk = list(addrs) + [0] * (16 - len(addrs))
        a.p2_load(blk[:8], group=0, do_mont=0, keep_state=0,
                  keep_upper=0 if first else 1)
        a.p2_load(blk[8:], group=1, do_mont=0, keep_state=1, keep_upper=1,
                  prep_full=last_prep)

    def hash_elems(self, addrs):
        """unpadded sponge hash; returns 8 contiguous digest cells."""
        a = self.a
        n = len(addrs)
        first = True
        i = 0
        while i < n:
            self.absorb(addrs[i:i + 16], first)
            a.p2_permute()
            first = False
            i += 16
        base = a.p2_store(group=0, do_mont=0)
        return list(range(base, base + 8))

    def hash_pair(self, d1, d2):
        a = self.a
        a.p2_load(d1, group=0, do_mont=0, keep_state=0, keep_upper=0)
        a.p2_load(d2, group=1, do_mont=0, keep_state=1, keep_upper=1,
                  prep_full=True)
        a.p2_permute()
        base = a.p2_store(group=0, do_mont=0)
        return list(range(base, base + 8))

    # ---- merkle -------------------------------------------------------------

    def merkle_group(self, row_size, col_size, queries=QUERIES):
        return _Merkle(self, row_size, col_size, queries)


class _Rng:
    """In-VM Poseidon2Rng (risc0/zkp/src/core/hash/poseidon2/rng.rs).

    Pool state is persisted to WOM (standard form) after each permute so
    interleaved sponge hashing can't clobber it."""

    def __init__(self, gen: Gen):
        self.g = gen
        self.state = None       # (g0, g1, g2) std store bases or None (zero)
        self.pool_used = 0

    def _reload(self, digest=None):
        """Restore pool state into the p2 unit, optionally adding a digest
        into cells 0..8 (mix), then permute + store."""
        a = self.g.a
        if self.state is None:
            if digest is None:
                a.p2_load([0] * 8, group=0, do_mont=0, keep_state=0,
                          keep_upper=0, prep_full=True)
            else:
                a.p2_load(digest, group=0, do_mont=0, keep_state=0,
                          keep_upper=0, prep_full=True)
        else:
            # prep_full applies the external-matrix prep AT ITS ROW, so it
            # must sit on the LAST load before the permute (the witgen
            # kernel computes per-row; poseidon2.cpp:78-87)
            g0, g1, g2 = self.state
            a.p2_load(list(range(g0, g0 + 8)), group=0, do_mont=0,
                      keep_state=0, keep_upper=0)
            a.p2_load(list(range(g1, g1 + 8)), group=1, do_mont=0,
                      keep_state=1, keep_upper=1)
            a.p2_load(list(range(g2, g2 + 8)), group=2, do_mont=0,
                      keep_state=1, keep_upper=1,
                      prep_full=digest is None)
            if digest is not None:
                a.p2_load(digest, group=0, do_mont=0, keep_state=1,
                          keep_upper=1, prep_full=True)
        a.p2_permute()
        g0 = a.p2_store(group=0, do_mont=0)
        g1 = a.p2_store(group=1, do_mont=0)
        g2 = a.p2_store(group=2, do_mont=0)
        self.state = (g0, g1, g2)
        self.pool_used = 0

    def mix(self, digest):
        if self.pool_used != 0:
            self._reload()
        self._reload(digest=digest)

    def elem(self):
        """One pool draw (abstract cell addr)."""
        if self.state is None or self.pool_used == 16:
            self._reload()
        g0, g1, _ = self.state
        i = self.pool_used
        self.pool_used += 1
        return (g0 + i) if i < 8 else (g1 + i - 8)

    def ext_elem(self):
        c = [self.elem() for _ in range(4)]
        return self.g.combine4(*c)

    def bits(self, nbits):
        """random_bits: 4 draws, first nonzero, mask low nbits."""
        a = self.g.a
        v = [self.elem() for _ in range(4)]
        val = a.add(v[2], a.mul(a.iszero(v[2]), v[3]))
        val = a.add(v[1], a.mul(a.iszero(v[1]), val))
        val = a.add(v[0], a.mul(a.iszero(v[0]), val))
        return a.bit_and_elem(val, a.const((1 << nbits) - 1))


class _Merkle:
    """In-VM MerkleTreeVerifier (reference zkp/src/verify/merkle.rs)."""

    def __init__(self, gen: Gen, row_size, col_size, queries):
        self.g = gen
        self.row_size = row_size
        self.col_size = col_size
        _, self.top_size = merkle_params(row_size, queries)
        tops = gen.read_digests(self.top_size)
        self.top_base = tops[0][0]
        # fold the committed top layer to the root (host builds `rest`;
        # queries always terminate in the top layer, so only the root is
        # needed in-VM)
        layer = tops
        while len(layer) > 1:
            layer = [gen.hash_pair(layer[2 * i], layer[2 * i + 1])
                     for i in range(len(layer) // 2)]
        self.root = layer[0]
        gen.rng.mix(self.root)

    def verify(self, bits, pos_strips):
        """One query: bits = normalized pos bit cells (LSB first),
        pos_strips[j] = cell holding pos >> j.  Returns col_size value
        cells (contiguous)."""
        g, a = self.g, self.g.a
        out = g.read_elems(self.col_size)
        cur = g.hash_elems(out)
        levels = (self.row_size // self.top_size).bit_length() - 1
        for j in range(levels):
            sib = g.read_digests(1)[0]
            b = bits[j]
            lhs, rhs = [], []
            cb, sb = cur[0], sib[0]
            for w in range(8):
                lhs.append(a.select(b, cb + w, (sb - cb) % P))
                rhs.append(a.select(b, sb + w, (cb - sb) % P))
            cur = g.hash_pair(lhs, rhs)
        t = pos_strips[levels]   # pos >> levels = final idx - top_size
        for w in range(8):
            exp = a.select(t, self.top_base + w, 8)
            a.eq(exp, cur[w])
        return out


def decompose_bits(gen: Gen, val, nbits):
    """Normalized {0,1} bit cells of `val` (LSB first)."""
    a = gen.a
    bits = []
    for i in range(nbits):
        raw = a.bit_and_elem(val, a.const(1 << i))
        bits.append(a.mul(raw, a.const(pow(1 << i, P - 2, P))))
    return bits


class CircuitSpec:
    """What the generator needs to know about the verified circuit."""

    def __init__(self, taps, circuit_info: bytes, output_size: int,
                 mix_size: int, poly_ext_emit, check_code_emit,
                 version_word=None):
        self.taps = taps
        self.circuit_info = circuit_info
        self.output_size = output_size
        self.mix_size = mix_size
        # (gen, poly_mix, eval_u, out, mix) -> ext addr
        self.poly_ext_emit = poly_ext_emit
        # (gen, po2, root_cells) -> None
        self.check_code_emit = check_code_emit
        self.version_word = version_word


def gen_verify(gen: Gen, spec: CircuitSpec, po2: int):
    """Emit the full STARK verify of one seal read from the input tape.
    Returns (out_cells, mix_cells): the circuit output globals and the
    accum mix, as abstract value cells."""
    a = gen.a
    rng = gen.rng
    taps = spec.taps
    tot_cycles = 1 << po2
    domain = INV_RATE * tot_cycles

    if spec.version_word is not None:
        a.read_iop_header(1, k=1)
        ver = a.read_iop_body(do_mont=False)
        a.eq(ver, a.const(_std(spec.version_word)))

    rng.mix([a.const(v) for v in _info_digest_std(PROOF_SYSTEM_INFO)])
    rng.mix([a.const(v) for v in _info_digest_std(spec.circuit_info)])

    # out globals + po2 word
    slice_ = gen.read_elems(spec.output_size + 1)
    out_cells, po2_cell = slice_[:-1], slice_[-1]
    a.eq(po2_cell, a.const(_std(po2)))
    rng.mix(gen.hash_elems(slice_))

    # groups: code, data, mix draws, accum (order per verify/mod.rs:500-563)
    m_code = gen.merkle_group(domain, taps.group_size(1))
    spec.check_code_emit(gen, po2, m_code.root)
    m_data = gen.merkle_group(domain, taps.group_size(2))
    mix_cells = [rng.elem() for _ in range(spec.mix_size)]
    m_accum = gen.merkle_group(domain, taps.group_size(0))
    merkles = [m_accum, m_code, m_data]   # group order accum/code/data

    # ---- verify_validity ----------------------------------------------------
    poly_mix = rng.ext_elem()
    m_check = gen.merkle_group(domain, CHECK_SIZE)
    z = rng.ext_elem()
    back_one = int(F.ROU_REV[po2])  # abstract

    num_taps = taps.tap_size
    cu_cells = gen.read_elems((num_taps + CHECK_SIZE) * EXT_SIZE)
    rng.mix(gen.hash_elems(cu_cells))
    coeff_u = [gen.combine4(*cu_cells[4 * i: 4 * i + 4])
               for i in range(num_taps + CHECK_SIZE)]

    # eval_u per tap: evaluate the reg's coeff poly at z * back_one^back
    cur_pos = 0
    eval_u = []
    for reg in taps.regs:
        for i in range(reg.size):
            xz = a.mul(z, a.const(pow(back_one, reg.backs[i], P)))
            eval_u.append(gen.poly_eval(
                coeff_u[cur_pos: cur_pos + reg.size], xz))
        cur_pos += reg.size

    result = spec.poly_ext_emit(gen, poly_mix, eval_u, out_cells, mix_cells)

    # reconstruct check value from check-poly openings (verify/mod.rs:371-396)
    remap = [0, 2, 1, 3]
    check = a.const(0)
    zi = a.const(1)
    for i, rmi in enumerate(remap):
        for j in range(4):
            basis = gen.const_ext([1 if k == j else 0 for k in range(4)])
            term = a.mul(a.mul(coeff_u[num_taps + rmi + 4 * j], zi), basis)
            check = a.add(check, term)
        if i < 3:
            zi = a.mul(zi, z)
    tz = a.mul(z, a.const(3))
    factor = a.sub(gen.pow_sq(tz, po2), a.const(1))
    check = a.mul(check, factor)
    a.eq(check, result)

    mix = rng.ext_elem()

    # combo_u + mix powers (verify/mod.rs:402-441)
    combo_u = [a.const(0)] * (taps.tot_combo_backs + 1)
    cur_mix = a.const(1)
    cur_pos = 0
    tap_mix_pows = []
    for reg in taps.regs:
        for i in range(reg.size):
            cb = taps.combo_begin[reg.combo_id] + i
            combo_u[cb] = a.add(combo_u[cb],
                                a.mul(cur_mix, coeff_u[cur_pos + i]))
        tap_mix_pows.append(cur_mix)
        cur_mix = a.mul(cur_mix, mix)
        cur_pos += reg.size
    check_mix_pows = []
    for _ in range(CHECK_SIZE):
        combo_u[taps.tot_combo_backs] = a.add(
            combo_u[taps.tot_combo_backs],
            a.mul(cur_mix, coeff_u[cur_pos]))
        cur_pos += 1
        check_mix_pows.append(cur_mix)
        cur_mix = a.mul(cur_mix, mix)

    gen_std = int(F.ROU_FWD[domain.bit_length() - 1])

    # ---- FRI ---------------------------------------------------------------
    rounds = []
    deg, dom = tot_cycles, domain
    while deg > FRI_MIN_DEGREE:
        rounds.append(_FriRound(gen, dom))
        dom //= FRI_FOLD
        deg //= FRI_FOLD
    fc_cells = gen.read_elems(EXT_SIZE * deg)
    rng.mix(gen.hash_elems(fc_cells))
    # final poly ext coeffs: planar layout (4, deg)
    final_ext = [gen.combine4(*[fc_cells[c * deg + i] for c in range(4)])
                 for i in range(deg)]
    gen_final_std = int(F.ROU_FWD[dom.bit_length() - 1])

    nbits = domain.bit_length() - 1
    for _q in range(QUERIES):
        pos = rng.bits(nbits)
        bits = decompose_bits(gen, pos, nbits)
        strips = _pos_strips(gen, pos, bits)

        # ---- inner: group rows + check row + fri_eval_taps -----------------
        rows = [m.verify(bits, strips) for m in merkles]
        check_row = m_check.verify(bits, strips)
        goal = _fri_eval_taps(
            gen, taps, combo_u, check_row, back_one, gen_std, bits, z, rows,
            tap_mix_pows, check_mix_pows)

        # ---- per-round fold -------------------------------------------------
        # pos is only ever truncated (group = pos mod smaller domain), so one
        # bit decomposition serves every round: group bits are bits[0:k].
        cur_dom = domain
        for rnd in rounds:
            cur_dom //= FRI_FOLD
            k = cur_dom.bit_length() - 1
            group_bits = bits[:k]
            qb = bits[k:k + 4]   # quot = pos >> k, 4 bits
            quot = a.add(a.add(qb[0], a.mul(qb[1], a.const(2))),
                         a.add(a.mul(qb[2], a.const(4)),
                               a.mul(qb[3], a.const(8))))
            group = a.bit_and_elem(pos, a.const(cur_dom - 1))
            # strips must be of the MASKED group, not the full pos (the
            # final top-layer select indexes with group >> levels)
            group_strips = _pos_strips(gen, group, group_bits)
            goal = rnd.verify_query(gen, group, group_bits, group_strips,
                                    quot, goal)
            pos = group
            strips = group_strips
            bits = group_bits

        # final: evaluate final poly at gen_final^pos
        x = gen.pow_bits(gen_final_std, bits)
        x_ext = x
        fx = gen.poly_eval(final_ext, x_ext)
        a.eq(fx, goal)

    return out_cells, mix_cells


def _pos_strips(gen: Gen, val, bits):
    """strips[j] = val >> j (field cells), via (v - b) * inv2."""
    a = gen.a
    inv2 = pow(2, P - 2, P)
    strips = [val]
    cur = val
    for b in bits:
        cur = a.mul(a.sub(cur, b), a.const(inv2))
        strips.append(cur)
    return strips


class _FriRound:
    """One FRI round commitment (reference zkp/src/verify/fri.rs:60-96)."""

    def __init__(self, gen: Gen, in_domain):
        self.domain = in_domain // FRI_FOLD
        self.merkle = gen.merkle_group(self.domain, FRI_FOLD * EXT_SIZE)
        self.mix = gen.rng.ext_elem()

    def verify_query(self, gen: Gen, group, group_bits, group_strips, quot,
                     goal):
        a = gen.a
        data = self.merkle.verify(group_bits, group_strips)
        d = data[0]
        # select entry `quot` of data_ext (data layout: component c at
        # d + c*16 + q)
        comps = [a.select(quot, d + c * 16, 1) for c in range(4)]
        sel = gen.combine4(*comps)
        a.eq(sel, goal)

        root_po2 = (FRI_FOLD * self.domain).bit_length() - 1
        inv_wk = gen.pow_bits(
            int(F.ROU_REV[root_po2]), group_bits)
        x = a.mul(self.mix, inv_wk)
        # new_goal = poly_eval(intt16(data_ext), x), via the barycentric
        # form p(x) = (x^16-1)/16 * sum_i d_i w^i/(x - w^i)  (w = 16th root;
        # verified against verify/_ext_intt16 on host).  x lands on a root
        # only with negligible probability (INV(0)=0 would then fail the EQ).
        w = int(F.ROU_FWD[4])
        x16 = gen.pow_sq(x, 4)
        front = a.mul(a.sub(x16, a.const(1)),
                      a.const(pow(16, P - 2, P)))
        tot = None
        for i in range(16):
            wi = pow(w, i, P)
            ei = gen.combine4(d + 0 * 16 + i, d + 1 * 16 + i,
                              d + 2 * 16 + i, d + 3 * 16 + i)
            term = a.mul(ei, a.mul(a.const(wi),
                                   a.inv(a.sub(x, a.const(wi)))))
            tot = term if tot is None else a.add(tot, term)
        return a.mul(front, tot)


def _fri_eval_taps(gen: Gen, taps, combo_u, check_row, back_one, gen_std,
                   bits, z, rows, tap_mix_pows, check_mix_pows):
    """reference verify/mod.rs:246-285."""
    a = gen.a
    combo_count = taps.combos_size
    tot = [a.const(0)] * (combo_count + 1)
    for reg, cur in zip(taps.regs, tap_mix_pows):
        val = rows[reg.group][reg.offset]
        tot[reg.combo_id] = a.add(tot[reg.combo_id], a.mul(cur, val))
    for i in range(CHECK_SIZE):
        tot[combo_count] = a.add(tot[combo_count],
                                 a.mul(check_mix_pows[i], check_row[i]))
    x = gen.pow_bits(gen_std, bits)
    ret = a.const(0)
    for i in range(combo_count):
        num = a.sub(tot[i], gen.poly_eval(
            combo_u[taps.combo_begin[i]: taps.combo_begin[i + 1]], x))
        divisor = a.const(1)
        for back in taps.combos[i]:
            divisor = a.mul(divisor, a.sub(
                x, a.mul(z, a.const(pow(back_one, back, P)))))
        ret = a.add(ret, a.mul(num, a.inv(divisor)))
    z4 = a.mul(a.mul(z, z), a.mul(z, z))
    check_num = a.sub(tot[combo_count], combo_u[taps.tot_combo_backs])
    check_div = a.sub(x, z4)
    ret = a.add(ret, a.mul(check_num, a.inv(check_div)))
    return ret
