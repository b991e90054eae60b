"""rv32im circuit data and the verifier-side constraint evaluation
(counterpart of ``risc0_tpu/circuit/rv32im/circuit.py``).

The tap set and the constraint polynomial (a flat SSA IR) are the
reference's extracted data under ``risc0_tpu/circuit/rv32im/data/``; this
module loads the same files.  The prover-side evaluation over the 4x domain
is ``circuit/ir_range.make_eval_check``.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

import risc0_tpu
from risc0_tpu.taps import Reg, TapSet

from ... import field as F

# reference circuit/rv32im/src/zirgen/info.rs:23
CIRCUIT_INFO = b"RV32IM:v2rev2___"
OUTPUT_SIZE = 90   # globals (defs.rs.inc REGCOUNT_GLOBAL)
MIX_SIZE = 36      # accum mix elems (REGCOUNT_MIX)

_DATA = os.path.join(os.path.dirname(risc0_tpu.__file__), "circuit",
                     "rv32im", "data")

# op codes (scripts/extract_rv32im.py pack())
FCONST, FTAP, FGLOBAL, FSCR_RD, FADD, FSUB, FMUL, ECONST, EMADD, FSCR_WR, \
    ESCR_WR, ESCR_RD, EADD, ESUB, EMUL, ESCALE, EADDF, FSUBE, ESUBF = range(19)

BUF_ACCUM, BUF_DATA, BUF_GLOBAL, BUF_MIX = 0, 1, 2, 3
_BUF_TO_GROUP = {BUF_ACCUM: 0, BUF_DATA: 2}


def _taps_to_tapset(tz) -> TapSet:
    """Convert the extracted taps table to our TapSet structure."""
    taps = tz["taps"]  # (n,5): offset, back, group, combo, skip
    combo_taps = list(tz["combo_taps"])
    combo_begin = list(tz["combo_begin"])
    combos = [tuple(int(b) for b in combo_taps[combo_begin[i]:combo_begin[i + 1]])
              for i in range(int(tz["combos_count"]))]
    # registers: group by (group, offset)
    regs = []
    seen = {}
    for offset, back, group, combo, _skip in taps:
        key = (int(group), int(offset))
        if key not in seen:
            seen[key] = (int(combo), [])
        seen[key][1].append(int(back))
    for (group, offset), (combo, backs) in sorted(seen.items()):
        regs.append(Reg(group, offset, combo, tuple(sorted(backs))))
    ts = TapSet(("accum", "code", "data"), regs, combos)
    assert ts.tap_size == len(taps)
    assert ts.reg_count == int(tz["reg_count"])
    return ts


class Rv32imCircuit:
    def __init__(self, taps: TapSet, opcode, operands, n_f, n_e,
                 fscr_size, escr_size, ret, mix_powers=None):
        self.taps = taps
        self.CIRCUIT_INFO = CIRCUIT_INFO
        self.OUTPUT_SIZE = OUTPUT_SIZE
        self.MIX_SIZE = MIX_SIZE
        self.opcode = opcode
        self.operands = operands
        self.n_f = int(n_f)
        self.n_e = int(n_e)
        self.fscr_size = int(fscr_size)
        self.escr_size = int(escr_size)
        self.ret = ("e", int(ret))  # the final value is always an ext reg
        # poly_mix[k] in the generated code means mix^POLY_MIX_POWERS[k]
        # (reference <circuit>/src/.../info.rs); identity if absent
        ks = operands[opcode == EMADD][:, 2]
        max_k = int(ks.max())
        if mix_powers is None:
            mix_powers = np.arange(max_k + 1, dtype=np.uint32)
        self.mix_powers = np.asarray(mix_powers, np.uint32)
        assert len(self.mix_powers) > max_k
        # (group, offset, back) -> tap index in eval_u order
        self._tap_index = {}
        i = 0
        for reg in taps.regs:
            for b in reg.backs:
                self._tap_index[(reg.group, reg.offset, b)] = i
                i += 1

    def mix_pows(self, poly_mix):
        """(n, 4) table with entry k = poly_mix^POLY_MIX_POWERS[k]."""
        pm = np.asarray(poly_mix, np.uint32)
        out = np.zeros((len(self.mix_powers), 4), np.uint32)
        # compute all needed powers via square-and-multiply per entry
        cache = {0: F.encode_np(np.array([1, 0, 0, 0], np.uint32))}
        def pw(e):
            if e in cache:
                return cache[e]
            if e % 2 == 0:
                h = pw(e // 2)
                v = F.ext_mul_np(h, h)
            else:
                v = F.ext_mul_np(pw(e - 1), pm)
            cache[e] = v
            return v
        for k, e in enumerate(self.mix_powers):
            out[k] = pw(int(e))
        return out

    # -- verifier-side scalar evaluation (replaces generated poly_ext.rs) ----
    def poly_ext(self, poly_mix, eval_u, out, mix):
        """Evaluate the mixed constraint polynomial at the DEEP point.

        poly_mix: (4,) ext Montgomery; eval_u: (num_taps, 4); out: (90,) base
        Montgomery words; mix: (36,) base Montgomery words.  Returns (4,).
        All "Fp" ops lift to the extension field, mirroring the reference's
        generated poly_ext (which computes over ExtElems of the openings).
        """
        em = F.ext_mul_np
        ea = F.add_np
        es = F.sub_np

        pm = self.mix_pows(poly_mix)

        fregs = np.zeros((self.n_f, 4), np.uint32)
        eregs = np.zeros((self.n_e, 4), np.uint32)
        fscr = np.zeros((self.fscr_size, 4), np.uint32)
        escr = np.zeros((self.escr_size, 4), np.uint32)
        eval_u = np.asarray(eval_u, np.uint32)

        def embed(v):
            o = np.zeros(4, np.uint32)
            o[0] = v
            return o

        out_e = np.asarray(out, np.uint32)
        mix_e = np.asarray(mix, np.uint32)

        for op, row in zip(self.opcode, self.operands):
            a, b, c, d, e, f_ = row
            if op == FCONST:
                fregs[a] = embed(F.s_encode(int(b)))
            elif op == FTAP:
                fregs[a] = eval_u[self._tap_index[(_BUF_TO_GROUP[int(b)],
                                                  int(c), int(d))]]
            elif op == FGLOBAL:
                src = out_e if b == BUF_GLOBAL else mix_e
                fregs[a] = embed(int(src[int(c)]))
            elif op == FSCR_RD:
                fregs[a] = fscr[b]
            elif op == FADD:
                fregs[a] = ea(fregs[b], fregs[c])
            elif op == FSUB:
                fregs[a] = es(fregs[b], fregs[c])
            elif op == FMUL:
                fregs[a] = em(fregs[b], fregs[c])
            elif op == ECONST:
                eregs[a] = F.encode_np(np.array([b, c, d, e], np.uint32))
            elif op == EMADD:
                term = pm[c]
                if d >= 0:
                    term = em(term, fregs[d])
                if e >= 0:
                    term = em(term, fregs[e])
                if f_ >= 0:
                    term = em(term, eregs[f_])
                eregs[a] = ea(eregs[b], term)
            elif op == FSCR_WR:
                fscr[a] = fregs[b]
            elif op == ESCR_WR:
                escr[a] = eregs[b]
            elif op == ESCR_RD:
                eregs[a] = escr[b]
            elif op == EADD:
                eregs[a] = ea(eregs[b], eregs[c])
            elif op == ESUB:
                eregs[a] = es(eregs[b], eregs[c])
            elif op == EMUL:
                eregs[a] = em(eregs[b], eregs[c])
            elif op == ESCALE:
                eregs[a] = em(eregs[b], fregs[c])
            elif op == EADDF:
                eregs[a] = ea(eregs[b], fregs[c])
            elif op == FSUBE:
                eregs[a] = es(fregs[b], eregs[c])
            elif op == ESUBF:
                eregs[a] = es(eregs[b], fregs[c])
            else:
                raise ValueError(f"bad opcode {op}")
        kind, reg = self.ret
        assert kind == "e"
        return eregs[int(reg)]


@lru_cache(maxsize=1)
def load_circuit() -> Rv32imCircuit:
    tz = np.load(os.path.join(_DATA, "taps.npz"))
    ir = np.load(os.path.join(_DATA, "poly_fp_ir.npz"), allow_pickle=True)
    taps = _taps_to_tapset(tz)
    return Rv32imCircuit(
        taps, ir["opcode"], ir["operands"], ir["n_f"], ir["n_e"],
        ir["fscr_size"], ir["escr_size"], ir["ret"],
        ir["mix_powers"] if "mix_powers" in ir.files else None)
