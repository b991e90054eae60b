"""Device accum witgen on torch (counterpart of
``risc0_tpu/circuit/rv32im/accum_device.py``).

The rv32im accum pass (``witgen_accum.bin``, the per-row program that the
host C++ interpreter ``csrc/witgen.cpp`` runs) has forward-only control
flow over an acyclic CFG.  ``build_accum_graph`` if-converts it once into a
predicated, hash-consed scalar dataflow graph (the reference's code,
copied with the same names: the same graph node for node); the evaluator
below runs that graph for every row of the segment at once on the
caller's device.

Sequential state: accum columns 0-11 are three ext-field accumulator
registers, and a row's new value is affine in the previous row's.  Probe
evaluations of the graph recover each row's coefficients, two inclusive
scans resolve the recurrence (regs 0-1 jointly, a 2x2 ext-matrix scan;
then reg 2, whose probes are evaluated at the true regs 0-1 because its
transition takes a reg0 x reg1 bilinear term in the bigint arm), and a
final evaluation with the true previous-row states materialises every
column.  The prefix sum and totals phases of the host path follow.

All arithmetic is in Montgomery form on int32 words (``field.py``); the
result stays Montgomery, so the accum commit skips its encode pass.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ... import field as F
from ...assets import RV32IM_DATA as _DATA_DIR
from ...convert import card, to_torch

P = F.P

# bytecode opcodes (csrc/witgen.cpp:92-99)
(CONST, B_ADD, B_SUB, B_MUL, B_NEG, B_ISZ, B_INV, B_BITAND, B_MOD,
 B_INRANGE, B_LOAD, B_STORE, B_ELOAD, B_ESTORE, B_EADD, B_ESUB, B_EMUL,
 B_EINV, B_EMULS, B_EFROMVAL, B_ECONST, B_EEQZ, B_MOV, B_EMOV, B_EQZ,
 B_JZ, B_JMP, B_UNREACH) = range(28)

# graph node kinds (shared by the accum and exec translators)
(K, DATA, GLOB, MIXIN, STATE, ADD, SUB, NEG, MUL, INV, ENC, DEC, ISZ,
 INRANGE, NZ, EQZB, AND, OR, NOT, SEL,
 # exec-only kinds (exec_device.py): cycle columns, row index, dynamic
 # gathers, histogram reads, bitwise/integer ops, rv32im divide
 CYC, ROWIDX, INIT, ROLLINIT, GLOBIN, TXNG, CYCG, BIGG, HISTG,
 BAND, SHRI, MODU, XDIVQ, XDIVR, PAIR16, IADD, EQU) = range(37)

_KIND_NAMES = ("K DATA GLOB MIXIN STATE ADD SUB NEG MUL INV ENC DEC ISZ "
               "INRANGE NZ EQZB AND OR NOT SEL "
               "CYC ROWIDX INIT ROLLINIT GLOBIN TXNG CYCG BIGG HISTG "
               "BAND SHRI MODU XDIVQ XDIVR PAIR16 IADD EQU").split()

NUM_ACCUM = 103
USER_SPLIT = 23
STATE_COLS = 12   # cols 0-11: three ext accumulator registers


class Graph:
    """Hash-consed predicated dataflow graph with constant folding."""

    def __init__(self):
        self.nodes = []       # (kind, a, b, c)
        self.domain = []      # 's' std u32 field/flag, 'm' mont, 'b' bool
        self._memo = {}
        self.TRUE = self._raw(K, 1, 0, 0, "b")
        self.FALSE = self._raw(K, 0, 0, 0, "b")

    def _raw(self, kind, a, b, c, dom):
        key = (kind, a, b, c, dom)
        i = self._memo.get(key)
        if i is None:
            i = len(self.nodes)
            self.nodes.append((kind, a, b, c))
            self.domain.append(dom)
            self._memo[key] = i
        return i

    # -- constants ----------------------------------------------------------
    def k(self, v, dom="s"):
        return self._raw(K, int(v) % P if dom != "b" else int(v), 0, 0, dom)

    def is_k(self, i):
        return self.nodes[i][0] == K

    def kval(self, i):
        return self.nodes[i][1]

    # -- domain conversion --------------------------------------------------
    def to_mont(self, i):
        d = self.domain[i]
        if d == "m":
            return i
        assert d == "s"
        if self.is_k(i):
            return self.k(F.s_encode(self.kval(i)), "m")
        return self._raw(ENC, i, 0, 0, "m")

    def to_std(self, i):
        d = self.domain[i]
        if d == "s":
            return i
        assert d == "m"
        if self.is_k(i):
            return self.k(F.s_decode(self.kval(i)), "s")
        return self._raw(DEC, i, 0, 0, "s")

    # -- field arithmetic (Montgomery) --------------------------------------
    def fadd(self, a, b):
        a, b = self.to_mont(a), self.to_mont(b)
        if self.is_k(a) and self.kval(a) == 0:
            return b
        if self.is_k(b) and self.kval(b) == 0:
            return a
        if self.is_k(a) and self.is_k(b):
            return self.k(F.s_add(self.kval(a), self.kval(b)), "m")
        if a > b:
            a, b = b, a   # commutative: canonical operand order
        return self._raw(ADD, a, b, 0, "m")

    def fsub(self, a, b):
        a, b = self.to_mont(a), self.to_mont(b)
        if a == b:
            return self.k(0, "m")
        if self.is_k(b) and self.kval(b) == 0:
            return a
        if self.is_k(a) and self.is_k(b):
            return self.k(F.s_sub(self.kval(a), self.kval(b)), "m")
        return self._raw(SUB, a, b, 0, "m")

    def fneg(self, a):
        a = self.to_mont(a)
        if self.is_k(a):
            return self.k((P - self.kval(a)) % P, "m")
        return self._raw(NEG, a, 0, 0, "m")

    def fmul(self, a, b):
        a, b = self.to_mont(a), self.to_mont(b)
        one = F.R % P
        for x, y in ((a, b), (b, a)):
            if self.is_k(x):
                if self.kval(x) == 0:
                    return self.k(0, "m")
                if self.kval(x) == one:
                    return y
        if self.is_k(a) and self.is_k(b):
            return self.k(F.s_mul(self.kval(a), self.kval(b)), "m")
        if a > b:
            a, b = b, a
        return self._raw(MUL, a, b, 0, "m")

    def finv(self, a):
        a = self.to_mont(a)
        if self.is_k(a):
            return self.k(F.s_inv(self.kval(a)), "m")
        return self._raw(INV, a, 0, 0, "m")

    # -- bool/conds ---------------------------------------------------------
    def nz(self, a):   # field value != 0 (domain-independent)
        if self.is_k(a):
            return self.TRUE if self.kval(a) != 0 else self.FALSE
        return self._raw(NZ, a, 0, 0, "b")

    def eq0(self, a):
        if self.is_k(a):
            return self.TRUE if self.kval(a) == 0 else self.FALSE
        return self._raw(EQZB, a, 0, 0, "b")

    def band(self, a, b):
        if a == self.FALSE or b == self.FALSE:
            return self.FALSE
        if a == self.TRUE:
            return b
        if b == self.TRUE:
            return a
        if a == b:
            return a
        if a > b:
            a, b = b, a
        return self._raw(AND, a, b, 0, "b")

    def bor(self, a, b):
        if a == self.TRUE or b == self.TRUE:
            return self.TRUE
        if a == self.FALSE:
            return b
        if b == self.FALSE:
            return a
        if a == b:
            return a
        if a > b:
            a, b = b, a
        return self._raw(OR, a, b, 0, "b")

    def bnot(self, a):
        if a == self.TRUE:
            return self.FALSE
        if a == self.FALSE:
            return self.TRUE
        if self.nodes[a][0] == NOT:
            return self.nodes[a][1]
        return self._raw(NOT, a, 0, 0, "b")

    def sel(self, c, a, b):
        """c ? a : b (a, b coerced to a common domain)."""
        if c == self.TRUE:
            return a
        if c == self.FALSE:
            return b
        if a == b:
            return a
        da, db = self.domain[a], self.domain[b]
        if da != db:
            if "m" in (da, db):
                a, b = self.to_mont(a), self.to_mont(b)
            else:
                a, b = self.to_std(a), self.to_std(b)
        if a == b:
            return a
        return self._raw(SEL, c, a, b, self.domain[a])


def _load_bytecode():
    with open(os.path.join(_DATA_DIR, "witgen_accum.bin"), "rb") as f:
        magic, n_ops, n_slots, n_ext, _ = struct.unpack("<4sIIII",
                                                        f.read(20))
        assert magic == b"WGN1"
        ops = np.frombuffer(f.read(n_ops * 20), np.uint32).reshape(n_ops, 5)
        ext = np.frombuffer(f.read(n_ext * 16), np.uint32).reshape(n_ext, 4)
    return ops, int(n_slots), ext


class AccumGraph:
    """Build product: graph + output ids + input specs."""

    def __init__(self, g, out_cols, bad, data_taps, glob_ids, mix_ids):
        self.g = g
        self.out_cols = out_cols      # 103 node ids (Montgomery domain)
        self.bad = bad                # bool node id
        self.data_taps = data_taps    # ordered [(col, back)]
        self.glob_ids = glob_ids      # ordered [col]
        self.mix_ids = mix_ids        # ordered [idx]


def build_accum_graph():
    """If-convert witgen_accum.bin into a predicated dataflow graph."""
    ops, n_slots, extconsts = _load_bytecode()
    n_ops = len(ops)
    g = Graph()

    # basic-block leaders (forward-only jumps — verified acyclic)
    leaders = {0}
    for pc in range(n_ops):
        op, _d, _a, b, _c = ops[pc]
        if op in (B_JZ, B_JMP):
            assert b > pc, "accum CFG must be forward-only"
            leaders.add(int(b))
            leaders.add(pc + 1)
    leaders = sorted(leaders)
    block_of = {lo: i for i, lo in enumerate(leaders)}

    env = {}            # slot -> node id (merged across blocks)
    acc = {}            # accum col -> node id (merged, any domain)
    incoming = {0: [g.TRUE]}
    bad_terms = []

    data_taps, glob_ids, mix_ids = {}, {}, {}

    def in_data(col, back):
        key = (int(col), int(back))
        if key not in data_taps:
            data_taps[key] = g._raw(DATA, key[0], key[1], 0, "s")
        return data_taps[key]

    def in_glob(col):
        col = int(col)
        if col not in glob_ids:
            glob_ids[col] = g._raw(GLOB, col, 0, 0, "s")
        return glob_ids[col]

    def in_mix(idx):
        idx = int(idx)
        if idx not in mix_ids:
            mix_ids[idx] = g._raw(MIXIN, idx, 0, 0, "s")
        return mix_ids[idx]

    for bi, lo in enumerate(leaders):
        hi = leaders[bi + 1] if bi + 1 < len(leaders) else n_ops
        conds = incoming.pop(lo, None)
        if not conds:
            continue   # statically unreachable
        c = conds[0]
        for extra in conds[1:]:
            c = g.bor(c, extra)

        local = {}       # slot -> node (unpredicated, this block)
        acc_local = {}   # col -> node

        def rd(slot):
            slot = int(slot)
            v = local.get(slot)
            if v is None:
                v = env.get(slot)
            if v is None:
                v = g.k(0)   # read-before-write: dead on live paths
            return v

        def wr(slot, v):
            local[int(slot)] = v

        def buf_load(buf, col, back):
            buf, col, back = int(buf), int(col), int(back)
            if buf == 0:
                return in_data(col, back)
            if buf == 1:
                return in_glob(col)
            if buf == 2:
                if back > 0:
                    if col < STATE_COLS:
                        return g._raw(STATE, col, 0, 0, "m")
                    if col > USER_SPLIT:
                        return g.k(0)   # zeroBack guard (witgen.h:118-125)
                    raise NotImplementedError(
                        f"back-read of accum col {col}")
                v = acc_local.get(col)
                if v is None:
                    v = acc.get(col)
                if v is None:
                    v = g.k(0)
                return v
            return in_mix(col)

        def buf_store(buf, col, v):
            assert int(buf) == 2, "accum program stores only to accum"
            acc_local[int(col)] = v

        fallthrough = True
        pc = lo
        while pc < hi:
            op, d, a, b, cc = (int(x) for x in ops[pc])
            if op == CONST:
                wr(d, g.k(a))
            elif op == B_ADD:
                wr(d, g.fadd(rd(a), rd(b)))
            elif op == B_SUB:
                wr(d, g.fsub(rd(a), rd(b)))
            elif op == B_MUL:
                wr(d, g.fmul(rd(a), rd(b)))
            elif op == B_NEG:
                wr(d, g.fneg(rd(a)))
            elif op == B_ISZ:
                x = rd(a)
                wr(d, g.sel(g.eq0(x), g.k(1), g.k(0)))
            elif op == B_INV:
                wr(d, g.finv(rd(a)))
            elif op == B_INRANGE:
                lo_v, x, hi_v = (g.to_std(rd(r)) for r in (a, b, cc))
                wr(d, g._raw(INRANGE, lo_v, x, hi_v, "s"))
            elif op == B_LOAD:
                wr(d, buf_load(cc, a, b))
            elif op == B_STORE:
                buf_store(cc, a, rd(b))
            elif op == B_ELOAD:
                for i in range(4):
                    wr(d + i, buf_load(cc, a + i, b))
            elif op == B_ESTORE:
                for i in range(4):
                    buf_store(cc, a + i, rd(b + i))
            elif op == B_EADD:
                for i in range(4):
                    wr(d + i, g.fadd(rd(a + i), rd(b + i)))
            elif op == B_ESUB:
                for i in range(4):
                    wr(d + i, g.fsub(rd(a + i), rd(b + i)))
            elif op == B_EMUL:
                av = [rd(a + i) for i in range(4)]
                bv = [rd(b + i) for i in range(4)]
                nb = g.k(F.NBETA)
                wr(d + 0, g.fadd(
                    g.fmul(av[0], bv[0]),
                    g.fmul(nb, g.fadd(g.fadd(g.fmul(av[1], bv[3]),
                                             g.fmul(av[2], bv[2])),
                                      g.fmul(av[3], bv[1])))))
                wr(d + 1, g.fadd(
                    g.fadd(g.fmul(av[0], bv[1]), g.fmul(av[1], bv[0])),
                    g.fmul(nb, g.fadd(g.fmul(av[2], bv[3]),
                                      g.fmul(av[3], bv[2])))))
                wr(d + 2, g.fadd(
                    g.fadd(g.fmul(av[0], bv[2]), g.fmul(av[1], bv[1])),
                    g.fadd(g.fmul(av[2], bv[0]),
                           g.fmul(nb, g.fmul(av[3], bv[3])))))
                wr(d + 3, g.fadd(
                    g.fadd(g.fmul(av[0], bv[3]), g.fmul(av[1], bv[2])),
                    g.fadd(g.fmul(av[2], bv[1]), g.fmul(av[3], bv[0]))))
            elif op == B_EINV:
                av = [rd(a + i) for i in range(4)]
                beta = g.k(F.BETA)
                nbeta = g.k(F.NBETA)
                b0 = g.fadd(g.fmul(av[0], av[0]),
                            g.fmul(beta, g.fsub(
                                g.fmul(av[1], g.fadd(av[3], av[3])),
                                g.fmul(av[2], av[2]))))
                b2 = g.fadd(g.fsub(g.fmul(av[0], g.fadd(av[2], av[2])),
                                   g.fmul(av[1], av[1])),
                            g.fmul(beta, g.fmul(av[3], av[3])))
                cn = g.fadd(g.fmul(b0, b0), g.fmul(beta, g.fmul(b2, b2)))
                ic = g.finv(cn)
                b0 = g.fmul(b0, ic)
                b2 = g.fmul(b2, ic)
                wr(d + 0, g.fadd(g.fmul(av[0], b0),
                                 g.fmul(beta, g.fmul(av[2], b2))))
                wr(d + 1, g.fadd(g.fmul(g.fneg(av[1]), b0),
                                 g.fmul(nbeta, g.fmul(av[3], b2))))
                wr(d + 2, g.fadd(g.fmul(g.fneg(av[0]), b2),
                                 g.fmul(av[2], b0)))
                wr(d + 3, g.fsub(g.fmul(av[1], b2), g.fmul(av[3], b0)))
            elif op == B_EMULS:
                s = rd(b)
                for i in range(4):
                    wr(d + i, g.fmul(rd(a + i), s))
            elif op == B_EFROMVAL:
                wr(d, rd(a))
                for i in range(1, 4):
                    wr(d + i, g.k(0))
            elif op == B_ECONST:
                for i in range(4):
                    wr(d + i, g.k(int(extconsts[a][i])))
            elif op in (B_EEQZ, B_EQZ):
                n = 4 if op == B_EEQZ else 1
                for i in range(n):
                    bad_terms.append(g.band(c, g.nz(rd(a + i))))
            elif op == B_MOV:
                wr(d, rd(a))
            elif op == B_EMOV:
                for i in range(4):
                    wr(d + i, rd(a + i))
            elif op == B_JZ:
                z = g.eq0(rd(a))
                incoming.setdefault(b, []).append(g.band(c, z))
                incoming.setdefault(hi, []).append(g.band(c, g.bnot(z)))
                fallthrough = False
            elif op == B_JMP:
                incoming.setdefault(b, []).append(c)
                fallthrough = False
            elif op == B_UNREACH:
                bad_terms.append(c)
            else:
                raise NotImplementedError(
                    f"accum bytecode op {op} not supported on device")
            pc += 1
        if fallthrough and hi < n_ops:
            incoming.setdefault(hi, []).append(c)

        # merge this block's writes under its path condition
        for slot, v in local.items():
            old = env.get(slot)
            env[slot] = v if old is None and c == g.TRUE else \
                g.sel(c, v, old if old is not None else g.k(0))
        for col, v in acc_local.items():
            old = acc.get(col)
            acc[col] = v if old is None and c == g.TRUE else \
                g.sel(c, v, old if old is not None else g.k(0))

    out_cols = [g.to_mont(acc.get(col, g.k(0))) for col in range(NUM_ACCUM)]
    # balanced OR tree: a linear chain would serialize ~700 levels of the
    # otherwise-shallow graph into singleton device ops
    terms = [t for t in bad_terms if t != g.FALSE] or [g.FALSE]
    while len(terms) > 1:
        terms = [g.bor(terms[i], terms[i + 1]) if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]
    bad = terms[0]
    taps = sorted(data_taps)
    return AccumGraph(
        g, out_cols, bad,
        data_taps=[(k, data_taps[k]) for k in taps],
        glob_ids=sorted(glob_ids.items()),
        mix_ids=sorted(mix_ids.items()),
    )


_GRAPH = None


def accum_graph():
    global _GRAPH
    if _GRAPH is None:
        _GRAPH = build_accum_graph()
    return _GRAPH


class ExecPlan:
    """Grouped register-file execution plan for a set of graph outputs."""

    def __init__(self, ag, outputs):
        g = ag.g
        live = set()
        stack = list(outputs)

        def deps(i):
            kind, a, b, c = g.nodes[i]
            if kind in (ADD, SUB, MUL, AND, OR):
                return (a, b)
            if kind in (NEG, INV, ENC, DEC, ISZ, NZ, EQZB, NOT):
                return (a,)
            if kind in (INRANGE, SEL):
                return (a, b, c)
            return ()

        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            stack.extend(deps(i))

        order = sorted(live)
        level = {}
        for i in order:
            ds = deps(i)
            level[i] = 1 + max((level[d] for d in ds), default=0)

        # input rows: consts | taps | scalars(glob+mix) | state
        row = {}
        self.const_vals = []
        consts = [i for i in order if g.nodes[i][0] == K]
        for i in consts:
            row[i] = len(row)
            self.const_vals.append(g.kval(i))
        self.const_vals = np.asarray(self.const_vals, np.uint32)

        # taps: select from the SHARED (len(ag.data_taps), rows) tap matrix
        self.tap_start = len(row)
        tap_pos = {nid: p for p, (_k, nid) in enumerate(ag.data_taps)}
        tap_sel = []
        for i in order:
            if g.nodes[i][0] == DATA:
                row[i] = self.tap_start + len(tap_sel)
                tap_sel.append(tap_pos[i])
        self.tap_sel = np.asarray(tap_sel, np.int32)

        # scalars: shared [glob..., mix...] vector
        self.scal_start = len(row)
        spos = {}
        for p, (_c, nid) in enumerate(ag.glob_ids):
            spos[nid] = p
        off = len(ag.glob_ids)
        for p, (_c, nid) in enumerate(ag.mix_ids):
            spos[nid] = off + p
        scal_sel = []
        for i in order:
            if g.nodes[i][0] in (GLOB, MIXIN):
                row[i] = self.scal_start + len(scal_sel)
                scal_sel.append(spos[i])
        self.scal_sel = np.asarray(scal_sel, np.int32)

        # state rows: fixed 12-row block (input is always (12, chunk))
        self.state_start = len(row)
        state_nodes = [i for i in order if g.nodes[i][0] == STATE]
        state_sel = []
        for i in state_nodes:
            row[i] = self.state_start + len(state_sel)
            state_sel.append(g.nodes[i][1])
        self.state_sel = np.asarray(state_sel, np.int32)

        # computed nodes: contiguous rows per (level, kind) group
        groups = {}
        for i in order:
            kind = g.nodes[i][0]
            if kind in (K, DATA, GLOB, MIXIN, STATE):
                continue
            groups.setdefault((level[i], kind), []).append(i)

        self.groups = []
        for (lv, kind), members in sorted(groups.items()):
            dst = len(row)
            for i in members:
                row[i] = len(row)
            opnds = []
            n_ops = {ADD: 2, SUB: 2, MUL: 2, AND: 2, OR: 2, NEG: 1, INV: 1,
                     ENC: 1, DEC: 1, ISZ: 1, NZ: 1, EQZB: 1, NOT: 1,
                     INRANGE: 3, SEL: 3}[kind]
            for slot in range(n_ops):
                opnds.append(np.asarray(
                    [row[deps(i)[slot]] for i in members], np.int32))
            self.groups.append((kind, dst, len(members), opnds))

        self.n_rows = len(row)
        self.out_rows = np.asarray([row[i] for i in outputs], np.int32)


# ---------------------------------------------------------------------------
# Device (torch) evaluator: one register file of plan.n_rows x T int32
# words per chunk of T rows, one gather, one field op and one slice store
# per (level, kind) group
# ---------------------------------------------------------------------------

# Rows a chunk.  `probe` (2,370 register rows, 415 groups) covers a whole
# po2 20 segment in one chunk: 2370 x 2^20 x 4 B = 9.9 GB.  `full` (43,580
# rows, 623 groups) takes 2^16 rows a chunk: 43580 x 2^16 x 4 B = 11.4 GB,
# 16 chunks at po2 20, about 8 x 10^4 launches in all (2,048 rows a chunk
# would take 512 chunks and more than 10^6).  2^17 rows a chunk was no
# faster and doubles the file (scripts/torch_witgen_bench.py on an NVIDIA
# H100 80GB HBM3 at 700 W: 3.1-3.4 s against 3.3-4.1 s, peak 34.9 GiB
# against 18.8).
PROBE_CHUNK = 1 << 20
FULL_CHUNK = 1 << 16

_M32 = 0xFFFFFFFF


def _u32(x):
    """int32 words -> their u32 values, as int64."""
    return x.to(torch.int64) & _M32


def _group_compute(kind, ops):
    """One op group: ops is the (arity, n, T) gather of its operands.
    Booleans are 0/1 words."""
    if kind == ADD:
        return F.add(ops[0], ops[1])
    if kind == SUB:
        return F.sub(ops[0], ops[1])
    if kind == MUL:
        return F.mul(ops[0], ops[1])
    if kind == NEG:
        return F.neg(ops[0])
    if kind == INV:
        return F.inv(ops[0])
    if kind == ENC:
        return F.encode(ops[0])
    if kind == DEC:
        return F.decode(ops[0])
    if kind in (ISZ, EQZB):
        return (ops[0] == 0).to(torch.int32)
    if kind == NZ:
        return (ops[0] != 0).to(torch.int32)
    if kind == INRANGE:
        lo, x, hi = _u32(ops[0]), _u32(ops[1]), _u32(ops[2])
        return ((lo <= x) & (x < hi)).to(torch.int32)
    if kind == AND:
        return ops[0] & ops[1]
    if kind == OR:
        return ops[0] | ops[1]
    if kind == NOT:
        return ops[0] ^ 1
    if kind == SEL:
        return torch.where(ops[0] != 0, ops[1], ops[2])
    raise AssertionError(_KIND_NAMES[kind])


def _idx(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class _DevicePlan:
    """An ExecPlan's index arrays, uploaded once per device; each group's
    operand rows are one (arity * n,) index, gathered in one launch."""

    def __init__(self, plan, device):
        self.consts = to_torch(plan.const_vals, device)
        self.tap_sel = _idx(plan.tap_sel, device)
        self.scal_sel = _idx(plan.scal_sel, device)
        self.state_sel = _idx(plan.state_sel, device)
        self.out_rows = _idx(plan.out_rows, device)
        self.groups = [(kind, dst, n, _idx(np.concatenate(opnds), device))
                       for kind, dst, n, opnds in plan.groups]


def _run_groups(groups, file, compute):
    """Each group (kind, dst, n, operand index, ...) in turn: one gather of
    its operand rows, compute(group, (arity, n, T) operands), one store
    into its n contiguous destination rows."""
    T = file.shape[1]
    for g in groups:
        _kind, dst, n, ix = g[:4]
        file[dst:dst + n] = compute(g, file.index_select(0, ix).view(-1, n, T))


def _run_plan(plan, dp, taps, scalars, state, chunk):
    """Evaluate a plan over every row, T = min(chunk, rows) rows a chunk.
    taps (n_taps, rows) std words, scalars (n_scal,) std words, state
    (12, rows) Montgomery words.  Returns (n_out, rows) int32."""
    rows = taps.shape[1]
    T = min(chunk, rows)
    file = torch.empty((plan.n_rows, T), dtype=torch.int32,
                       device=taps.device)
    # constants and scalars are the same in every chunk: staged once
    file[:len(plan.const_vals)] = dp.consts[:, None]
    ns = len(plan.scal_sel)
    file[plan.scal_start:plan.scal_start + ns] = scalars[dp.scal_sel][:, None]
    nt, nst = len(plan.tap_sel), len(plan.state_sel)
    out = torch.empty((len(plan.out_rows), rows), dtype=torch.int32,
                      device=taps.device)
    for s in range(0, rows, T):
        file[plan.tap_start:plan.tap_start + nt] = \
            taps[:, s:s + T].index_select(0, dp.tap_sel)
        file[plan.state_start:plan.state_start + nst] = \
            state[:, s:s + T].index_select(0, dp.state_sel)
        _run_groups(dp.groups, file, lambda g, ops: _group_compute(g[0], ops))
        out[:, s:s + T] = file.index_select(0, dp.out_rows)
    return out


_PLANS = {}


def _plans():
    if not _PLANS:
        ag = accum_graph()
        _PLANS["ag"] = ag
        _PLANS["probe"] = ExecPlan(ag, ag.out_cols[:STATE_COLS])
        _PLANS["full"] = ExecPlan(ag, ag.out_cols + [ag.bad])
    return _PLANS


_DEVICE_PLANS = {}


def _device_plan(name, device):
    key = (name, str(device))
    if key not in _DEVICE_PLANS:
        _DEVICE_PLANS[key] = _DevicePlan(_plans()[name], device)
    return _DEVICE_PLANS[key]


def _scan_2x2(M, d):
    """Inclusive scan of s_r = M_r s_{r-1} + d_r (s_{-1} = 0) over pairs of
    ext elements: M (rows, 2, 2, 4), d (rows, 2, 4), Montgomery.
    Hillis-Steele doubling: log2(rows) rounds of (M2, D2) o (M1, D1) =
    (M2 M1, M2 D1 + D2), each row composed with the row `off` before it."""
    rows = d.shape[0]
    off = 1
    while off < rows:
        M2, D2, M1, D1 = M[off:], d[off:], M[:-off], d[:-off]
        mm = F.ext_mul(M2[:, :, :, None], M1[:, None])   # (n, i, k, j, 4)
        mv = F.ext_mul(M2, D1[:, None])                  # (n, i, k, 4)
        M = torch.cat([M[:off], F.add(mm[:, :, 0], mm[:, :, 1])])
        d = torch.cat([d[:off], F.add(F.add(mv[:, :, 0], mv[:, :, 1]), D2)])
        off *= 2
    return d


def _affine_scan(c, d):
    """Inclusive scan of s_r = c_r s_{r-1} + d_r (s_{-1} = 0) over ext
    elements: c, d (rows, 4), Montgomery; Hillis-Steele doubling."""
    rows = d.shape[0]
    off = 1
    while off < rows:
        cd = F.ext_mul(c[off:, None], torch.stack([c[:-off], d[:-off]], 1))
        c = torch.cat([c[:off], cd[:, 0]])
        d = torch.cat([d[:off], F.add(cd[:, 1], d[off:])])
        off *= 2
    return d


def _shift_down(s):
    """The previous row's value of each row; row 0 reads zero."""
    return torch.cat([torch.zeros_like(s[:1]), s[:-1]])


def _accum_pipeline(taps, scalars, chunk):
    """Probes -> staged scans -> full evaluation -> phases 2-3.  Returns
    (accum (103, rows) Montgomery int32, bad (rows,) 0/1 int32)."""
    plans = _plans()
    rows = taps.shape[1]
    dev = taps.device
    probe_dp = _device_plan("probe", dev)

    def probe(state):
        return _run_plan(plans["probe"], probe_dp, taps, scalars, state,
                         PROBE_CHUNK)

    def reg(e, r):
        return e[4 * r:4 * r + 4].T   # (rows, 4)

    zero = torch.zeros((STATE_COLS, rows), dtype=torch.int32, device=dev)
    e0 = probe(zero)
    st = zero.clone()
    st[0] = F.MONT_ONE
    eA = probe(st)
    st = zero.clone()
    st[4] = F.MONT_ONE
    eB = probe(st)

    # regs 0-1: s' = M s + d, M's columns the responses to the unit states
    d01 = torch.stack([reg(e0, 0), reg(e0, 1)], 1)
    M = torch.stack([torch.stack([F.sub(reg(eA, i), reg(e0, i)),
                                  F.sub(reg(eB, i), reg(e0, i))], 1)
                     for i in range(2)], 1)          # (rows, out, in, 4)
    prev01 = _shift_down(_scan_2x2(M, d01)).reshape(rows, 8)

    # reg 2: affine in itself given the true regs 0-1
    stC = torch.cat([prev01.T, zero[:4]])
    eC = probe(stC)
    stD = stC.clone()
    stD[8] = F.MONT_ONE
    eD = probe(stD)
    d2 = reg(eC, 2)
    prev2 = _shift_down(_affine_scan(F.sub(reg(eD, 2), d2), d2))

    state = torch.cat([prev01, prev2], 1).T.contiguous()
    e2 = _run_plan(plans["full"], _device_plan("full", dev), taps, scalars,
                   state, chunk)
    accum, bad = e2[:NUM_ACCUM], e2[NUM_ACCUM]

    # phase 2: inclusive prefix sum of the last 4 columns; int64 is exact
    # (2^20 rows x 2^31 < 2^63)
    totals = (accum[NUM_ACCUM - 4:].to(torch.int64).cumsum(1) % P).to(
        torch.int32)
    # phase 3: the previous row's totals added to every machine ext group
    # but the last
    machine = (NUM_ACCUM - USER_SPLIT) // 4
    mid = accum[USER_SPLIT:NUM_ACCUM - 4].view(machine - 1, 4, rows)
    mid.copy_(F.add(mid, torch.roll(totals, 1, 1)[None]))
    accum[NUM_ACCUM - 4:] = totals
    return accum, bad


def witgen_accum_device(res, mix, device="cuda", chunk=FULL_CHUNK):
    """The accum witness on `device`: (103, rows) Montgomery int32.

    res: a witgen_exec result; res["data"] is host u32 or an int32 tensor
    (the device exec's, gathered where it lies).  mix: (36,) standard-form
    u32.  chunk: rows a chunk of the `full` plan.  Raises RuntimeError
    when any row fails an in-circuit check (the host path,
    witgen.witgen_accum, names the failing check)."""
    device = card(device)
    ag = _plans()["ag"]
    rows = res["rows"]
    if any(b not in (0, 1) for (_c, b), _n in ag.data_taps):
        raise AssertionError("accum taps read back 0 or 1 rows only")
    cols = sorted({c for (c, _b), _n in ag.data_taps})
    data = res["data"]
    if isinstance(data, torch.Tensor):
        dsel = data.index_select(0, _idx(cols, data.device)).to(device)
    else:
        dsel = to_torch(np.ascontiguousarray(data[cols]), device)
    dsel = torch.where(dsel == -1, 0, dsel)   # INVALID (0xFFFFFFFF) reads 0
    pos = {c: p for p, c in enumerate(cols)}
    taps = dsel.index_select(0, _idx([pos[c] for (c, _b), _n in ag.data_taps],
                                     device))
    back1 = _idx([p for p, ((_c, b), _n) in enumerate(ag.data_taps) if b],
                 device)
    # back 1 rolls cyclically: row 0 reads row rows - 1
    taps[back1] = torch.roll(taps[back1], 1, 1)
    scalars = to_torch(np.concatenate([
        np.asarray([res["global"][c] for c, _n in ag.glob_ids], np.uint32),
        np.asarray([mix[i] for i, _n in ag.mix_ids], np.uint32)]), device)
    accum, bad = _accum_pipeline(taps, scalars, chunk)
    n_bad = int(bad.sum())
    if n_bad:
        raise RuntimeError(
            f"accum device eval: {n_bad} rows failed in-circuit checks "
            "(witgen.witgen_accum, the host path, names the check)")
    return accum
