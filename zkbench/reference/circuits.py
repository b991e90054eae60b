"""The two circuits a receipt of this benchmark proves, read from the
repository's extracted circuit tables (raw data files, not code): their
taps and the interpreters of their constraint polynomials at one point.

- rv32im (risc0 circuit/rv32im): taps.npz and poly_fp_ir.npz, a flat SSA
  program over base and extension registers, scratch and mix powers.
- recursion (risc0 circuit/recursion): taps.npz and poly_ext.npz, the
  PolyExtStep program (risc0 zkp/src/adapter.rs).

Both evaluators work on canonical values (see field.py).
"""

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import field as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RV32IM_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "rv32im", "data")
RECURSION_DATA = os.path.join(ROOT, "risc0_tpu", "circuit", "recursion",
                              "data")


@dataclass(frozen=True)
class Reg:
    group: int
    offset: int
    combo: int
    backs: tuple


def _regs(path):
    """Registers sorted by (group, offset), each with its sorted backs and
    combo, and the combos' back sets."""
    z = np.load(path)
    found = {}
    for offset, back, group, combo, _skip in z["taps"].tolist():
        found.setdefault((group, offset), (combo, []))[1].append(back)
    regs = [Reg(g, o, c, tuple(sorted(b)))
            for (g, o), (c, b) in sorted(found.items())]
    ct, cb = z["combo_taps"].tolist(), z["combo_begin"].tolist()
    combos = [tuple(ct[cb[i]:cb[i + 1]]) for i in range(int(z["combos_count"]))]
    return regs, combos


class Circuit:
    def __init__(self, info, output_size, mix_size, regs, combos):
        self.info = info
        self.output_size = output_size
        self.mix_size = mix_size
        self.regs = regs
        self.combos = combos
        self._sizes = {}
        for r in regs:
            self._sizes[r.group] = max(self._sizes.get(r.group, 0),
                                       r.offset + 1)

    def group_size(self, group: int) -> int:
        return self._sizes.get(group, 0)


class Rv32im(Circuit):
    # op codes of poly_fp_ir.npz
    (FCONST, FTAP, FGLOBAL, FSCR_RD, FADD, FSUB, FMUL, ECONST, EMADD,
     FSCR_WR, ESCR_WR, ESCR_RD, EADD, ESUB, EMUL, ESCALE, EADDF, FSUBE,
     ESUBF) = range(19)
    BUF_TO_GROUP = {0: 0, 1: 2}  # accum, data
    BUF_GLOBAL = 2

    def __init__(self):
        regs, combos = _regs(os.path.join(RV32IM_DATA, "taps.npz"))
        super().__init__(b"RV32IM:v2rev2___", 90, 36, regs, combos)
        ir = np.load(os.path.join(RV32IM_DATA, "poly_fp_ir.npz"))
        self.program = list(zip(ir["opcode"].tolist(),
                                ir["operands"].tolist()))
        self.sizes = (int(ir["n_f"]), int(ir["n_e"]), int(ir["fscr_size"]),
                      int(ir["escr_size"]))
        self.ret = int(ir["ret"])
        self.mix_powers = ir["mix_powers"].tolist()
        self.tap_index = {}
        for r in regs:
            for b in r.backs:
                self.tap_index[(r.group, r.offset, b)] = len(self.tap_index)

    def poly_ext(self, poly_mix, evals, globals_, mix):
        pm = [F.epow(poly_mix, e) for e in self.mix_powers]
        n_f, n_e, n_fs, n_es = self.sizes
        f = [F.ZERO] * n_f
        e = [F.ZERO] * n_e
        fs = [F.ZERO] * n_fs
        es = [F.ZERO] * n_es
        for op, (a, b, c, d, x, y) in self.program:
            if op == self.FCONST:
                f[a] = F.ext(b)
            elif op == self.FTAP:
                f[a] = evals[self.tap_index[(self.BUF_TO_GROUP[b], c, d)]]
            elif op == self.FGLOBAL:
                f[a] = F.ext((globals_ if b == self.BUF_GLOBAL else mix)[c])
            elif op == self.FSCR_RD:
                f[a] = fs[b]
            elif op == self.FADD:
                f[a] = F.eadd(f[b], f[c])
            elif op == self.FSUB:
                f[a] = F.esub(f[b], f[c])
            elif op == self.FMUL:
                f[a] = F.emul(f[b], f[c])
            elif op == self.ECONST:
                e[a] = (b % F.P, c % F.P, d % F.P, x % F.P)
            elif op == self.EMADD:
                term = pm[c]
                if d >= 0:
                    term = F.emul(term, f[d])
                if x >= 0:
                    term = F.emul(term, f[x])
                if y >= 0:
                    term = F.emul(term, e[y])
                e[a] = F.eadd(e[b], term)
            elif op == self.FSCR_WR:
                fs[a] = f[b]
            elif op == self.ESCR_WR:
                es[a] = e[b]
            elif op == self.ESCR_RD:
                e[a] = es[b]
            elif op == self.EADD:
                e[a] = F.eadd(e[b], e[c])
            elif op == self.ESUB:
                e[a] = F.esub(e[b], e[c])
            elif op == self.EMUL:
                e[a] = F.emul(e[b], e[c])
            elif op == self.ESCALE:
                e[a] = F.emul(e[b], f[c])
            elif op == self.EADDF:
                e[a] = F.eadd(e[b], f[c])
            elif op == self.FSUBE:
                e[a] = F.esub(f[b], e[c])
            elif op == self.ESUBF:
                e[a] = F.esub(e[b], f[c])
            else:
                raise ValueError(f"unknown op {op}")
        return e[self.ret]


class Recursion(Circuit):
    CONST, CONSTEXT, GET, GETGLOBAL, ADD, SUB, MUL, TRUE, ANDEQZ, ANDCOND = \
        range(10)

    def __init__(self):
        regs, combos = _regs(os.path.join(RECURSION_DATA, "taps.npz"))
        super().__init__(b"RECURSION:rev1v1", 32, 20, regs, combos)
        pe = np.load(os.path.join(RECURSION_DATA, "poly_ext.npz"))
        self.program = list(zip(pe["opcode"].tolist(),
                                pe["operands"].tolist()))
        self.ret = int(pe["ret"])

    def poly_ext(self, poly_mix, evals, globals_, mix):
        args = (globals_, mix)
        fp = []
        mixes = []
        for op, (a, b, c, d) in self.program:
            if op == self.CONST:
                fp.append(F.ext(a))
            elif op == self.CONSTEXT:
                fp.append((a % F.P, b % F.P, c % F.P, d % F.P))
            elif op == self.GET:
                fp.append(evals[a])
            elif op == self.GETGLOBAL:
                fp.append(F.ext(args[a][b]))
            elif op == self.ADD:
                fp.append(F.eadd(fp[a], fp[b]))
            elif op == self.SUB:
                fp.append(F.esub(fp[a], fp[b]))
            elif op == self.MUL:
                fp.append(F.emul(fp[a], fp[b]))
            elif op == self.TRUE:
                mixes.append((F.ZERO, F.ONE))
            elif op == self.ANDEQZ:
                tot, mul = mixes[a]
                mixes.append((F.eadd(tot, F.emul(mul, fp[b])),
                              F.emul(mul, poly_mix)))
            elif op == self.ANDCOND:
                tot, mul = mixes[a]
                itot, imul = mixes[c]
                mixes.append((F.eadd(tot, F.emul(F.emul(fp[b], itot), mul)),
                              F.emul(mul, imul)))
            else:
                raise ValueError(f"unknown op {op}")
        return mixes[self.ret][0]


@lru_cache(maxsize=None)
def rv32im() -> Rv32im:
    return Rv32im()


@lru_cache(maxsize=None)
def recursion() -> Recursion:
    return Recursion()
