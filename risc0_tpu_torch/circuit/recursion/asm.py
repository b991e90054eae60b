"""Recursion-VM assembler: emit .zkr code rows programmatically (the
port's host copy of ``risc0_tpu/circuit/recursion/asm.py``).

The recursion circuit executes 23-wide code rows (reference
risc0/circuit/recursion/src/layout.rs.inc CODE_LAYOUT).  This assembler
emits programs in that instruction encoding, checked cycle for cycle
against the preflight interpreter (preflight.py), and the predicate
builders (predicates.py) author the repository's own lift/join/resolve
programs with it.  Words are host data: Python ints and numpy u32.

Conventions (from disassembling keccak_lift_14.zkr):
  * row 0: `wom_init` macro; last row: `wom_fini`; before it, `set_global`
    macros export output slots.
  * micro rows hold 3 ops writing WOM addrs wa, wa+1, wa+2; non-writing ops
    (EQ, READ_IOP_HEADER) still consume their slot's address.
  * a Poseidon2 permutation is the row sequence FULL,FULL,PARTIAL,FULL,FULL
    (one-hot cycle index on the FULL rows); the last p2_load before it sets
    prep_full=1.
  * p2_load ADDS 8 values into state group g (do_mont divides by R);
    keep_state=0 zeroes cells 0..16 first (keep_upper=0 also 16..24).
    p2_store writes state group g to wa..wa+8 (do_mont multiplies by R).
"""

from __future__ import annotations

import numpy as np

from ... import field as F
from .prove import Program
from .preflight import (CB_EVAL_POINT, CB_KEEP_COEFFS, CB_KEEP_UPPER,
                        CB_PREP_FULL, MACRO_OPCODE, MACRO_OPERAND,
                        MICRO_INSTS, M_ADD, M_CONST, M_EQ, M_EXTRACT, M_INV,
                        M_MIX_RNG, M_MUL, M_READ_IOP_BODY, M_READ_IOP_HEADER,
                        M_SELECT, M_SUB, P2_DO_MONT, P2_G1, P2_G2, P2_INPUTS,
                        P2_KEEP_STATE, P2_KEEP_UPPER, SEL_CHECKED, SEL_MACRO,
                        SEL_MICRO, SEL_P2_FULL, SEL_P2_LOAD, SEL_P2_PARTIAL,
                        SEL_P2_STORE, WRITE_ADDR)

P = F.P
P2_PREP_FULL = 11
P2_GROUP_G0 = 12
WIDTH = 23

# SHA-256 IV + round constants (FIPS 180-4), materialized as WOM pair
# cells for the sha macro rows (see Asm.sha256).
_SHA_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
           0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_SHA_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)


class Asm:
    """Emits code rows; returns WOM addresses (ints) for value-producing ops.

    wom[0] is the implicit zero cell (never written, reads as 0)."""

    def __init__(self):
        self.rows = []
        self._pend = []          # up to 3 pending (op, a, b, c) micro ops
        self._pend_base = None   # write addr of pending row's slot 0
        self.next_addr = 1
        self._row0 = [0] * WIDTH
        self._row0[WRITE_ADDR] = 1
        self._row0[SEL_MACRO] = 1
        self._row0[MACRO_OPCODE["wom_init"]] = 1
        self.rows.append(self._row0)
        self._consts = {}        # (a, b) -> addr cache

    # ---- low-level emission -------------------------------------------------

    def _flush(self):
        if not self._pend:
            return
        row = [0] * WIDTH
        row[WRITE_ADDR] = self._pend_base
        row[SEL_MICRO] = 1
        ops = list(self._pend)
        while len(ops) < 3:
            # pad with CONST 0 writes to fresh addrs (zero-write is a no-op
            # for write-once semantics)
            ops.append((M_CONST, 0, 0, 0))
            self.next_addr += 1
        for i, (op, a, b, c) in enumerate(ops):
            o0, o1, o2, o3 = MICRO_INSTS[i]
            row[o0], row[o1], row[o2], row[o3] = op, a, b, c
        self.rows.append(row)
        self._pend = []
        self._pend_base = None

    def _micro(self, op, a=0, b=0, c=0, writes=True):
        """Queue one micro op; returns its slot's WOM address."""
        if not self._pend:
            self._pend_base = self.next_addr
        addr = self.next_addr
        self.next_addr += 1
        self._pend.append((int(op), int(a) % P, int(b) % P, int(c) % P))
        if len(self._pend) == 3:
            self._flush()
        return addr

    def _macro(self, name, a=0, b=0, c=0, wa=None):
        self._flush()
        row = [0] * WIDTH
        row[WRITE_ADDR] = self.next_addr if wa is None else wa
        row[SEL_MACRO] = 1
        row[MACRO_OPCODE[name]] = 1
        row[MACRO_OPERAND[0]] = int(a) % P
        row[MACRO_OPERAND[1]] = int(b) % P
        row[MACRO_OPERAND[2]] = int(c) % P
        self.rows.append(row)

    # ---- micro ops ----------------------------------------------------------

    def const(self, a, b=0):
        """wom <- (a, b, 0, 0); cached."""
        key = (int(a) % P, int(b) % P)
        if key in self._consts:
            return self._consts[key]
        addr = self._micro(M_CONST, key[0], key[1])
        self._consts[key] = addr
        return addr

    def const_ext(self, vals):
        """Build an ext const from two CONST + combine via x^2 mul."""
        v = [int(x) % P for x in vals] + [0] * (4 - len(vals))
        lo = self.const(v[0], v[1])
        if v[2] == 0 and v[3] == 0:
            return lo
        hi = self.const(v[2], v[3])
        return self.add(lo, self.mul(hi, self.x2()))

    def x2(self):
        """The ext element (0,0,1,0) = x^2, for building full-ext consts."""
        if not hasattr(self, "_x2"):
            x1 = self.const(0, 1)          # (0,1,0,0) = x
            self._x2 = self._micro(M_MUL, x1, x1)
        return self._x2

    def add(self, a, b):
        return self._micro(M_ADD, a, b, 0)

    def sub(self, a, b):
        return self._micro(M_SUB, a, b)

    def mul(self, a, b):
        return self._micro(M_MUL, a, b)

    def inv(self, a):
        """Ext inverse (0 -> 0)."""
        return self._micro(M_INV, a, 1)

    def iszero(self, a):
        """1 if first component zero else 0."""
        return self._micro(M_INV, a, 0)

    def eq(self, a, b):
        """Assert wom[a] == wom[b] (no result)."""
        self._micro(M_EQ, a, b, writes=False)

    def output(self, a):
        """Append wom[a][0] to the program output stream (ADD with arg2=1)."""
        return self._micro(M_ADD, a, 0, 1)

    def read_iop_header(self, count, k, flip=False):
        self._micro(M_READ_IOP_HEADER, count, 2 * k + (1 if flip else 0),
                    writes=False)

    def read_iop_body(self, do_mont=True):
        return self._micro(M_READ_IOP_BODY, 0, 0, 1 if do_mont else 0)

    def mix_rng(self, a, b, cont_mult=0):
        return self._micro(M_MIX_RNG, a, b, cont_mult)

    def select(self, sel, base, step):
        """wom <- wom[base + step * wom[sel][0] mod P]."""
        return self._micro(M_SELECT, sel, base, step)

    def extract(self, a, j):
        """Base-embed component j of ext wom[a] (component = 2*b1 + b2)."""
        return self._micro(M_EXTRACT, a, (j >> 1) & 1, j & 1)

    # ---- macro ops ----------------------------------------------------------

    def bit_and_elem(self, a, b):
        self._flush()
        addr = self.next_addr
        self.next_addr += 1
        self._macro("bit_and_elem", a, b, wa=addr)
        return addr

    def bit_op_shorts(self, a, b, is_and):
        self._flush()
        addr = self.next_addr
        self.next_addr += 1
        self._macro("bit_op_shorts", a, b, 1 if is_and else 0, wa=addr)
        return addr

    def set_global(self, addr, index):
        """Export wom[addr..addr+4] (components 0,1 each) to output global
        slot [8*index .. 8*index+8]."""
        self._macro("set_global", addr, index, 0, wa=self.next_addr)

    def fini(self):
        self._flush()
        self._macro("wom_fini", wa=self.next_addr)

    # ---- poseidon2 ----------------------------------------------------------

    def _p2_row(self, sel, wa, cols=None):
        self._flush()
        row = [0] * WIDTH
        row[WRITE_ADDR] = wa
        row[sel] = 1
        for k, v in (cols or {}).items():
            row[k] = int(v)
        self.rows.append(row)

    def p2_load(self, addrs, group, do_mont, keep_state, keep_upper,
                prep_full=False):
        assert len(addrs) == 8
        cols = {P2_DO_MONT: int(do_mont), P2_KEEP_STATE: int(keep_state),
                P2_KEEP_UPPER: int(keep_upper),
                P2_PREP_FULL: 1 if prep_full else 0}
        cols[(P2_GROUP_G0, P2_G1, P2_G2)[group]] = 1
        for i, a in enumerate(addrs):
            cols[P2_INPUTS[i]] = int(a)
        self._p2_row(SEL_P2_LOAD, self.next_addr, cols)

    def p2_permute(self):
        """FULL,FULL,PARTIAL,FULL,FULL row sequence."""
        wa = self.next_addr
        for onehot in (8, 9):
            self._p2_row(SEL_P2_FULL, wa, {onehot: 1})
        self._p2_row(SEL_P2_PARTIAL, wa)
        for onehot in (10, 11):
            self._p2_row(SEL_P2_FULL, wa, {onehot: 1})

    def p2_store(self, group, do_mont):
        """Store state group to 8 fresh WOM addrs; returns base addr."""
        self._flush()
        base = self.next_addr
        cols = {P2_DO_MONT: int(do_mont)}
        cols[(P2_GROUP_G0, P2_G1, P2_G2)[group]] = 1
        self._p2_row(SEL_P2_STORE, base, cols)
        self.next_addr += 8
        return base

    # ---- sha-256 ------------------------------------------------------------

    def sha256(self, words):
        """SHA-256 over a whole number of 16-word blocks.

        `words` are WOM addrs whose (component0, component1) hold the
        (lo16, hi16) halves of each little-endian u32 message word — the
        same format sha_fini emits, so digests chain directly into outer
        hashes.  Padding must be included by the caller (static lengths).
        Returns the 8 consecutive digest cells of the LAST block's fini.
        """
        assert len(words) % 16 == 0 and words
        # Row encodings the generated step_exec sha arms expect:
        #  * init row i: extern_womRead at operand[0]/[1] — the IV words
        #    h[3-i] / h[7-i] as RAW (lo,hi) pair cells;
        #  * load row i: operand[0] = message word cell, operand[1] = a
        #    cell holding round constant K[i], operand[2] = subtype (1 =
        #    pair format);
        #  * mix row j: operand[1] = K[16+j] cell;
        #  * fini row i: writes the a-half to operand[0] = out+3-i and the
        #    e-half to operand[1] = out+7-i (byteswapped digest pairs).
        iv_cells = [self.const(h & 0xFFFF, h >> 16) for h in _SHA_IV]
        k_cells = [self.const(k & 0xFFFF, k >> 16) for k in _SHA_K]
        self._flush()
        for i in range(4):
            self._macro("sha_init", iv_cells[3 - i], iv_cells[7 - i])
        out_base = None
        n_blocks = len(words) // 16
        for b in range(n_blocks):
            for i, w in enumerate(words[16 * b: 16 * b + 16]):
                self._macro("sha_load", w, k_cells[i], 1)
            for j in range(48):
                self._macro("sha_mix", 0, k_cells[16 + j])
            # each fini row writes TWO cells: the a-state half at
            # operand[0]=out+3-i and the e-state half at operand[1]=out+7-i
            # (reference prove/preflight.rs:462 addMacro comment; witgen
            # step_exec derives both WOM elements from the operand columns)
            out_base = self.next_addr
            self.next_addr += 8
            for i in range(4):
                self._macro("sha_fini", out_base + 3 - i, out_base + 7 - i)
        return list(range(out_base, out_base + 8))

    # ---- checked bytes ------------------------------------------------------

    def checked_bytes(self, eval_pt_addr, keep_coeffs, keep_upper,
                      prep_full=False):
        """Read 4 input words as 16 range-checked bytes; accumulate them into
        poseidon cells 0..16 (cell = cell*256 + byte when keep_coeffs) and
        return the byte-poly evaluated at wom[eval_pt_addr]."""
        self._flush()
        addr = self.next_addr
        self.next_addr += 1
        row = [0] * WIDTH
        row[WRITE_ADDR] = addr
        row[SEL_CHECKED] = 1
        row[CB_EVAL_POINT] = int(eval_pt_addr)
        row[CB_KEEP_COEFFS] = int(keep_coeffs)
        row[CB_KEEP_UPPER] = int(keep_upper)
        row[CB_PREP_FULL] = 1 if prep_full else 0
        self.rows.append(row)
        return addr

    # ---- program ------------------------------------------------------------

    def program(self, po2):
        self.fini()
        code = np.array(self.rows, np.uint32)
        return Program(code.reshape(-1), po2)
