"""A plain verifier of risc0's DEEP-ALI + FRI STARK seals under Poseidon2
(risc0 zkp/src/verify/{mod,fri,merkle,read_iop}.rs), on canonical values.

It replays the transcript, checks every Merkle opening against the
committed roots (data, accum, code and check groups, each FRI round),
recomputes the constraint polynomial at the DEEP point from the openings
with the circuit's own evaluator, checks the DEEP quotients at each query
and the FRI folds down to the final polynomial, and requires the seal to
be read to its last word.  It returns the globals and the po2.
"""

from . import field as F
from .poseidon2 import Transcript, hash_elems, hash_pair

INV_RATE = 4
EXT = 4
CHECK_SIZE = INV_RATE * EXT
QUERIES = 50
FOLD = 16
MIN_DEGREE = 256
MAX_PO2 = 24
PROOF_SYSTEM_INFO = b"RISC0_STARK:v1__"
GROUP_ACCUM, GROUP_CODE, GROUP_DATA = 0, 1, 2


class Rejected(Exception):
    """The seal does not verify."""


class Reader:
    def __init__(self, seal):
        self.seal = [int(w) for w in seal]
        self.pos = 0
        self.t = Transcript()

    def raw(self, n):
        if self.pos + n > len(self.seal):
            raise Rejected("seal too short")
        out = self.seal[self.pos:self.pos + n]
        self.pos += n
        return out

    def elems(self, n):
        words = self.raw(n)
        if any(w >= F.P for w in words):
            raise Rejected("a word of the seal is not a field element")
        return [F.decode(w) for w in words]

    def digests(self, n):
        v = self.elems(8 * n)
        return [tuple(v[8 * i:8 * i + 8]) for i in range(n)]


def _top_size(rows: int) -> int:
    """The largest layer of at most QUERIES nodes below the root, which the
    seal carries whole."""
    layers = rows.bit_length() - 1
    if 1 << layers != rows:
        raise Rejected(f"{rows} rows is not a power of two")
    top = 0
    for i in range(1, layers):
        if 1 << i > QUERIES:
            break
        top = i
    return 1 << top


class Tree:
    """A committed Merkle tree: its top layer read, its root mixed in."""

    def __init__(self, rd: Reader, rows: int, cols: int):
        self.rows, self.cols = rows, cols
        self.top = _top_size(rows)
        layer = rd.digests(self.top)
        self.nodes = {self.top + i: d for i, d in enumerate(layer)}
        for i in range(self.top - 1, 0, -1):
            self.nodes[i] = hash_pair(self.nodes[2 * i], self.nodes[2 * i + 1])
        rd.t.mix(self.nodes[1])  # the root

    def open(self, rd: Reader, row: int):
        if row >= self.rows:
            raise Rejected("query out of range")
        values = rd.elems(self.cols)
        cur = hash_elems(values)
        idx = row + self.rows
        while idx >= 2 * self.top:
            other = rd.digests(1)[0]
            cur = hash_pair(other, cur) if idx & 1 else hash_pair(cur, other)
            idx //= 2
        if self.nodes[idx] != cur:
            raise Rejected("Merkle branch mismatch")
        return values


def _info_digest(info: bytes):
    return hash_elems(list(info.ljust(16, b"\0")[:16]))


def _fold_coeffs(values):
    """Coefficients c_r of the 16 evaluations v_q = f(x w^q), w the 16th
    root of unity: c_r = (1/16) sum_q v_q w^(-rq)."""
    w_inv = F.rou_inv(4)
    n_inv = F.inv(FOLD)
    out = []
    for r in range(FOLD):
        acc = F.ZERO
        for q, v in enumerate(values):
            acc = F.eadd(acc, F.escale(v, pow(w_inv, r * q, F.P)))
        out.append(F.escale(acc, n_inv))
    return out


def verify(seal, circuit, check_code=None):
    """Verify `seal` (the STARK part, after any version word) against
    `circuit` (a circuits.Circuit); returns (globals, po2).  `check_code`
    receives (po2, code root) and raises Rejected where the code is not
    allowed."""
    if len(seal) == 0:
        raise Rejected("empty seal")
    rd = Reader(seal)
    t = rd.t
    t.mix(_info_digest(PROOF_SYSTEM_INFO))
    t.mix(_info_digest(circuit.info))
    header_words = rd.raw(circuit.output_size + 1)
    if any(w >= F.P for w in header_words):
        raise Rejected("a word of the header is not a field element")
    t.mix(hash_elems([F.decode(w) for w in header_words]))
    globals_ = [F.decode(w) for w in header_words[:-1]]
    po2 = header_words[-1]
    if po2 > MAX_PO2:
        raise Rejected(f"po2 {po2} out of range")
    n = 1 << po2
    domain = INV_RATE * n

    trees = {}
    trees[GROUP_CODE] = Tree(rd, domain, circuit.group_size(GROUP_CODE))
    if check_code is not None:
        check_code(po2, trees[GROUP_CODE].nodes[1])
    trees[GROUP_DATA] = Tree(rd, domain, circuit.group_size(GROUP_DATA))
    mix = [t.elem() for _ in range(circuit.mix_size)]
    trees[GROUP_ACCUM] = Tree(rd, domain, circuit.group_size(GROUP_ACCUM))

    poly_mix = t.ext_elem()
    check_tree = Tree(rd, domain, CHECK_SIZE)
    z = t.ext_elem()
    back_one = F.rou_inv(po2)

    regs = circuit.regs
    num_taps = sum(len(r.backs) for r in regs)
    coeff_flat = rd.elems((num_taps + CHECK_SIZE) * EXT)
    t.mix(hash_elems(coeff_flat))
    coeff = [tuple(coeff_flat[4 * i:4 * i + 4])
             for i in range(num_taps + CHECK_SIZE)]

    # the openings at z * w^-back, register by register
    evals = []
    pos = 0
    for reg in regs:
        c = coeff[pos:pos + len(reg.backs)]
        for b in reg.backs:
            evals.append(F.poly_eval(c, F.escale(z, pow(back_one, b, F.P))))
        pos += len(reg.backs)
    result = circuit.poly_ext(poly_mix, evals, globals_, mix)

    # the check polynomial at z from its 16 openings, times (3z)^n - 1
    check = F.ZERO
    for i, r in enumerate((0, 2, 1, 3)):
        zi = F.epow(z, i)
        for j in range(4):
            basis = tuple(1 if k == j else 0 for k in range(4))
            check = F.eadd(check, F.emul(F.emul(coeff[num_taps + r + 4 * j],
                                                zi), basis))
    check = F.emul(check, F.esub(F.epow(F.escale(z, 3), n), F.ONE))
    if check != result:
        raise Rejected("the check polynomial does not match the "
                       "constraints at z")

    mix2 = t.ext_elem()
    combos = circuit.combos
    begin = [0]
    for c in combos:
        begin.append(begin[-1] + len(c))
    combo_u = [F.ZERO] * (begin[-1] + 1)
    cur = F.ONE
    pos = 0
    reg_mix = []
    for reg in regs:
        for i in range(len(reg.backs)):
            k = begin[reg.combo] + i
            combo_u[k] = F.eadd(combo_u[k], F.emul(cur, coeff[pos + i]))
        reg_mix.append(cur)
        cur = F.emul(cur, mix2)
        pos += len(reg.backs)
    check_mix = []
    for _ in range(CHECK_SIZE):
        combo_u[-1] = F.eadd(combo_u[-1], F.emul(cur, coeff[pos]))
        pos += 1
        check_mix.append(cur)
        cur = F.emul(cur, mix2)
    z4 = F.epow(z, INV_RATE)
    combo_points = [[F.escale(z, pow(back_one, b, F.P)) for b in c]
                    for c in combos]
    gen = F.rou(domain.bit_length() - 1)

    def deep(idx):
        rows = {g: trees[g].open(rd, idx)
                for g in (GROUP_ACCUM, GROUP_CODE, GROUP_DATA)}
        check_row = check_tree.open(rd, idx)
        x = F.ext(pow(gen, idx, F.P))
        tot = [F.ZERO] * (len(combos) + 1)
        for reg, m in zip(regs, reg_mix):
            tot[reg.combo] = F.eadd(tot[reg.combo],
                                    F.escale(m, rows[reg.group][reg.offset]))
        for m, v in zip(check_mix, check_row):
            tot[-1] = F.eadd(tot[-1], F.escale(m, v))
        ret = F.ZERO
        for i, points in enumerate(combo_points):
            num = F.esub(tot[i], F.poly_eval(combo_u[begin[i]:begin[i + 1]],
                                             x))
            div = F.ONE
            for pt in points:
                div = F.emul(div, F.esub(x, pt))
            ret = F.eadd(ret, F.emul(num, F.einv(div)))
        num = F.esub(tot[-1], combo_u[-1])
        return F.eadd(ret, F.emul(num, F.einv(F.esub(x, z4))))

    # FRI: one committed round per fold of 16 down to 256 coefficients
    degree, size = n, domain
    rounds = []
    while degree > MIN_DEGREE:
        size //= FOLD
        tree = Tree(rd, size, FOLD * EXT)
        rounds.append((size, tree, t.ext_elem()))
        degree //= FOLD
    final_flat = rd.elems(EXT * degree)
    t.mix(hash_elems(final_flat))
    final = [tuple(final_flat[k * degree + j] for k in range(EXT))
             for j in range(degree)]
    final_gen = F.rou(size.bit_length() - 1)
    for _ in range(QUERIES):
        pos = t.bits(domain.bit_length() - 1)
        goal = deep(pos)
        for size_r, tree, fold_mix in rounds:
            quot, group = divmod(pos, size_r)
            data = tree.open(rd, group)
            values = [tuple(data[k * FOLD + q] for k in range(EXT))
                      for q in range(FOLD)]
            if values[quot] != goal:
                raise Rejected("FRI fold mismatch")
            x_inv = pow(F.rou_inv((FOLD * size_r).bit_length() - 1), group,
                        F.P)
            goal = F.poly_eval(_fold_coeffs(values), F.escale(fold_mix, x_inv))
            pos = group
        if F.poly_eval(final, F.ext(pow(final_gen, pos, F.P))) != goal:
            raise Rejected("final FRI polynomial mismatch")
    if rd.pos != len(rd.seal):
        raise Rejected(f"seal not read to its end: {rd.pos} of "
                       f"{len(rd.seal)} words")
    return globals_, po2
