"""Device exec witgen on torch (counterpart of
``risc0_tpu/circuit/rv32im/exec_device.py``).

``witgen_exec.bin`` (the per-row program that ``csrc/witgen.cpp`` runs for
each cycle) is if-converted once into a predicated dataflow graph, as the
accum program is (``accum_device.Graph``; the reference's construction,
copied: the same graph node for node), and evaluated for every row at
once on the device: the data witness matrix is born there.

Row-parallel semantics: every back-row read targets a cell that the
injector initialised before the row-parallel pass, so a back-read is a
roll of the injected columns.  The lookup tables take two passes of the
same graph: pass 1 evaluates each lookup-delta site's (u8 mask, u16 mask,
index) and adds the histograms; pass 2 evaluates the witness with the
histograms feeding the lookup-current reads.  The memory-transaction
cursor is a masked running counter that gathers from the transaction
stream.

Words are u32 in int32 storage: the integer kinds (IADD, SHRI, MODU,
PAIR16, the divide, the clipped gathers) widen to int64 and mask to
32 bits where u32 behaviour matters.  Every in-circuit check adds to a
bad-row mask, read back once; ``witgen.witgen_exec`` (the host path)
names the failing check.
"""

from __future__ import annotations

import os
import struct
import threading

import numpy as np
import torch

from ... import field as F
from ...assets import RV32IM_DATA as _DATA_DIR
from ...convert import card, to_numpy, to_torch
from ...zkvm.exec import preflight_segment
from .accum_device import (ADD, AND, BAND, BIGG, CYC, CYCG, DEC, ENC, EQU,
                           EQZB, GLOBIN, HISTG, IADD, INIT, INRANGE, INV,
                           ISZ, K, MODU, MUL, NEG, NOT, NZ, OR, PAIR16,
                           ROLLINIT, ROWIDX, SEL, SHRI, SUB, TXNG, XDIVQ,
                           XDIVR, Graph, _group_compute, _idx, _M32,
                           _run_groups, _u32)
from .witgen import _load_meta, _update_p2_zcheck, build_global

INVALID = np.uint32(0xFFFFFFFF)
NUM_DATA = 211

# bytecode opcodes (csrc/witgen.cpp:92-99)
(B_CONST, B_ADD, B_SUB, B_MUL, B_NEG, B_ISZ, B_INV, B_BITAND, B_MOD,
 B_INRANGE, B_LOAD, B_STORE, B_ELOAD, B_ESTORE, B_EADD, B_ESUB, B_EMUL,
 B_EINV, B_EMULS, B_EFROMVAL, B_ECONST, B_EEQZ, B_MOV, B_EMOV, B_EQZ,
 B_JZ, B_JMP, B_UNREACH, X_MAJOR_MINOR, X_MEM_TXN, X_LOOKUP_DELTA,
 X_LOOKUP_CURRENT, X_MEMORY_DELTA, X_DIFF_COUNT, X_IS_FIRST, X_DIVIDE,
 X_HOST_READ_PREP, X_HOST_WRITE, X_NEXT_PAGING, X_BIGINT) = range(40)

def _load_bytecode():
    with open(os.path.join(_DATA_DIR, "witgen_exec.bin"), "rb") as f:
        magic, n_ops, n_slots, n_ext, _ = struct.unpack("<4sIIII",
                                                        f.read(20))
        assert magic == b"WGN1"
        ops = np.frombuffer(f.read(n_ops * 20), np.uint32).reshape(n_ops, 5)
        ext = np.frombuffer(f.read(n_ext * 16), np.uint32).reshape(n_ext, 4)
    return ops, int(n_slots), ext


class ExecGraph:
    def __init__(self, g, data_cols, glob_sites, delta_sites, bad,
                 init_cols, roll_specs, first_current_pc=0):
        self.g = g
        self.data_cols = data_cols      # 211 node ids (std domain)
        self.glob_sites = glob_sites    # [(col, cond_node, val_node)]
        self.delta_sites = delta_sites  # [(m8, m16, index_node, pc)]
        self.bad = bad
        self.init_cols = sorted(init_cols)     # data cols read as INIT
        self.roll_specs = sorted(roll_specs)   # (col, back) ROLLINIT reads
        self.first_current_pc = first_current_pc


def build_exec_graph():
    ops, n_slots, extconsts = _load_bytecode()
    n_ops = len(ops)
    g = Graph()

    leaders = {0}
    for pc in range(n_ops):
        op, _d, _a, b, _c = ops[pc]
        if op in (B_JZ, B_JMP):
            assert b > pc, "exec CFG must be forward-only"
            leaders.add(int(b))
            leaders.add(pc + 1)
    leaders = sorted(leaders)

    env = {}
    data_state = {}     # data col -> node (std)
    glob_state = {}     # global col -> node (value a ROW would have written)
    glob_sites = []     # ordered write sites (col, cond, val)
    delta_sites = []
    incoming = {0: [g.TRUE]}
    bad_terms = []
    init_cols = set()
    roll_specs = set()

    def raw(kind, a=0, b=0, c=0, dom="s"):
        return g._raw(kind, a, b, c, dom)

    cyc = [raw(CYC, f) for f in range(11)]
    rowidx = raw(ROWIDX)
    cursor0 = cyc[6]

    def iadd(a, b):
        if g.is_k(b) and g.kval(b) == 0:
            return a
        return raw(IADD, a, b)

    def equ(a, b):   # raw u32 equality -> bool
        if a == b:
            return g.TRUE
        return raw(EQU, *sorted((a, b)), dom="b")

    for bi, lo in enumerate(leaders):
        hi = leaders[bi + 1] if bi + 1 < len(leaders) else n_ops
        conds = incoming.pop(lo, None)
        if not conds:
            continue
        c = conds[0]
        for extra in conds[1:]:
            c = g.bor(c, extra)

        local = {}
        data_local = {}
        glob_local = {}
        glob_sites_local = []
        cursor_in = env.get("__cursor__", cursor0)
        cursor = cursor_in

        def rd(slot):
            slot = int(slot)
            v = local.get(slot)
            if v is None:
                v = env.get(slot)
            return g.k(0) if v is None else v

        def wr(slot, v):
            local[int(slot)] = v

        def buf_load(buf, col, back):
            buf, col, back = int(buf), int(col), int(back)
            if buf == 0:
                if back > 0:
                    roll_specs.add((col, back))
                    return raw(ROLLINIT, col, back)
                v = data_local.get(col)
                if v is None:
                    v = data_state.get(col)
                if v is None:
                    init_cols.add(col)
                    v = raw(INIT, col)
                return v
            if buf == 1:
                v = glob_local.get(col)
                if v is None:
                    v = glob_state.get(col)
                return raw(GLOBIN, col) if v is None else v
            raise AssertionError(f"exec load from buf {buf}")

        def buf_store(buf, col, v):
            buf, col = int(buf), int(col)
            if buf == 0:
                data_local[col] = v
            elif buf == 1:
                glob_local[col] = v
                glob_sites_local.append((col, v))
            else:
                raise AssertionError(f"exec store to buf {buf}")

        fallthrough = True
        pc = lo
        while pc < hi:
            op, d, a, b, cc = (int(x) for x in ops[pc])
            if op == B_CONST:
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
                wr(d, g.sel(g.eq0(rd(a)), g.k(1), g.k(0)))
            elif op == B_INV:
                wr(d, g.finv(rd(a)))
            elif op == B_BITAND:
                wr(d, raw(BAND, *sorted((g.to_std(rd(a)), g.to_std(rd(b))))))
            elif op == B_MOD:
                wr(d, raw(MODU, g.to_std(rd(a)), g.to_std(rd(b))))
            elif op == B_INRANGE:
                lo_v, x, hi_v = (g.to_std(rd(r)) for r in (a, b, cc))
                wr(d, raw(INRANGE, lo_v, x, hi_v))
            elif op == B_LOAD:
                wr(d, buf_load(cc, a, b))
            elif op == B_STORE:
                buf_store(cc, a, g.to_std(rd(b)))
            elif op == B_ELOAD:
                for i in range(4):
                    wr(d + i, buf_load(cc, a + i, b))
            elif op == B_ESTORE:
                for i in range(4):
                    buf_store(cc, a + i, g.to_std(rd(b + i)))
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
                s2 = rd(b)
                for i in range(4):
                    wr(d + i, g.fmul(rd(a + i), s2))
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
            elif op == X_MAJOR_MINOR:
                wr(d, cyc[2])
                wr(d + 1, cyc[3])
            elif op == X_MEM_TXN:
                addr = g.to_std(rd(a))
                t = [raw(TXNG, cursor, f) for f in range(5)]
                # validations (ffi.cpp:62 extern_getMemoryTxn)
                bad_terms.append(g.band(c, g.bnot(
                    equ(raw(SHRI, t[1], 1), rowidx))))
                bad_terms.append(g.band(c, g.bnot(equ(t[0], addr))))
                wr(d, t[3])                               # prevCycle
                wr(d + 1, raw(BAND, t[4], g.k(0xFFFF)))   # prevWord lo
                wr(d + 2, raw(SHRI, t[4], 16))
                wr(d + 3, raw(BAND, t[2], g.k(0xFFFF)))   # word lo
                wr(d + 4, raw(SHRI, t[2], 16))
                mask = g.sel(c, g.k(1), g.k(0))
                cursor = iadd(cursor, mask)
            elif op == X_LOOKUP_DELTA:
                table = g.to_std(rd(a))
                index = g.to_std(rd(b))
                is8 = equ(table, g.k(8))
                is16 = equ(table, g.k(16))
                is0 = g.eq0(table)
                bad_terms.append(g.band(c, g.bnot(
                    g.bor(is0, g.bor(is8, is16)))))
                inr8 = g.nz(raw(INRANGE, g.k(0), index, g.k(256)))
                inr16 = g.nz(raw(INRANGE, g.k(0), index, g.k(65536)))
                bad_terms.append(g.band(g.band(c, is8), g.bnot(inr8)))
                bad_terms.append(g.band(g.band(c, is16), g.bnot(inr16)))
                delta_sites.append((g.band(c, is8), g.band(c, is16), index, pc))
            elif op == X_LOOKUP_CURRENT:
                table = g.to_std(rd(a))
                index = g.to_std(rd(b))
                wr(d, g.sel(equ(table, g.k(8)),
                            raw(HISTG, index, 8), raw(HISTG, index, 16)))
            elif op == X_MEMORY_DELTA:
                pass
            elif op == X_DIFF_COUNT:
                wr(d, raw(CYCG, g.to_std(rd(a))))
            elif op == X_IS_FIRST:
                wr(d, g.sel(equ(rowidx, g.k(0)), g.k(1), g.k(0)))
            elif op == X_DIVIDE:
                numer = raw(PAIR16, g.to_std(rd(a)),
                            g.to_std(rd(b & 0xFFFF)))
                denom = raw(PAIR16, g.to_std(rd(b >> 16)),
                            g.to_std(rd(cc & 0xFFFF)))
                sign = g.to_std(rd(cc >> 16))
                q = raw(XDIVQ, numer, denom, sign)
                r = raw(XDIVR, numer, denom, sign)
                wr(d, raw(BAND, q, g.k(0xFFFF)))
                wr(d + 1, raw(SHRI, q, 16))
                wr(d + 2, raw(BAND, r, g.k(0xFFFF)))
                wr(d + 3, raw(SHRI, r, 16))
            elif op in (X_HOST_READ_PREP, X_HOST_WRITE):
                wr(d, raw(TXNG, cursor, 2))
            elif op == X_NEXT_PAGING:
                wr(d, cyc[7])
                wr(d + 1, cyc[4])
            elif op == X_BIGINT:
                for i in range(16):
                    wr(d + i, raw(BIGG, cyc[8], i))
            else:
                raise NotImplementedError(f"exec bytecode op {op}")
            pc += 1
        if fallthrough and hi < n_ops:
            incoming.setdefault(hi, []).append(c)

        for slot, v in local.items():
            old = env.get(slot)
            env[slot] = v if old is None and c == g.TRUE else \
                g.sel(c, v, old if old is not None else g.k(0))
        for col, v in data_local.items():
            old = data_state.get(col)
            if old is None:
                init_cols.add(col)
                old = raw(INIT, col)
            data_state[col] = g.sel(c, v, old)
        for col, v in glob_local.items():
            old = glob_state.get(col)
            glob_state[col] = g.sel(c, v, old if old is not None
                                    else raw(GLOBIN, col))
        for col, v in glob_sites_local:
            glob_sites.append((col, c, v))
        if cursor is not cursor_in:
            env["__cursor__"] = cursor if c == g.TRUE else \
                g.sel(c, cursor, cursor_in)

    # balanced OR tree for the bad mask
    terms = [t for t in bad_terms if t != g.FALSE] or [g.FALSE]
    while len(terms) > 1:
        terms = [g.bor(terms[i], terms[i + 1]) if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]

    data_cols = []
    for col in range(NUM_DATA):
        v = data_state.get(col)
        if v is None:
            init_cols.add(col)
            v = raw(INIT, col)
        data_cols.append(g.to_std(v))
    first_cur = min((pc for pc in range(n_ops)
                     if ops[pc][0] == X_LOOKUP_CURRENT), default=n_ops)
    return ExecGraph(g, data_cols, glob_sites, delta_sites, terms[0],
                     init_cols, roll_specs, first_current_pc=first_cur)


_GRAPH = None
_GRAPH_LOCK = threading.Lock()


def exec_graph():
    """The graph, built once a process (concurrent first calls wait)."""
    global _GRAPH
    if _GRAPH is None:
        with _GRAPH_LOCK:
            if _GRAPH is None:
                _GRAPH = build_exec_graph()
    return _GRAPH


def _deps(g, i):
    kind, a, b, c = g.nodes[i]
    if kind in (ADD, SUB, MUL, AND, OR, BAND, MODU, IADD, EQU, PAIR16):
        return (a, b)
    if kind in (NEG, INV, ENC, DEC, ISZ, NZ, EQZB, NOT, SHRI, TXNG,
                CYCG, HISTG):
        return (a,)
    if kind == BIGG:
        return (a,)
    if kind in (INRANGE, SEL, XDIVQ, XDIVR):
        return (a, b, c)
    return ()


class ExecPlan:
    """Grouped register-file plan for a set of exec-graph outputs.

    Input rows: consts | cyc fields | rowidx | glob scalars | init col
    slices | rollinit slices | hist-independent; TXNG/CYCG/BIGG/HISTG are
    dynamic-gather groups reading auxiliary arrays with per-row indices."""

    INPUT_KINDS = (K, CYC, ROWIDX, GLOBIN, INIT, ROLLINIT)

    def __init__(self, eg, outputs):
        g = eg.g
        live = set()
        stack = list(outputs)
        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            stack.extend(_deps(g, i))
        order = sorted(live)
        level = {}
        for i in order:
            level[i] = 1 + max((level[d] for d in _deps(g, i)), default=0)

        row = {}
        self.const_vals = np.asarray(
            [g.kval(i) for i in order if g.nodes[i][0] == K], np.uint32)
        for i in order:
            if g.nodes[i][0] == K:
                row[i] = len(row)

        self.cyc_start = len(row)
        self.cyc_fields = []
        for i in order:
            if g.nodes[i][0] == CYC:
                row[i] = len(row)
                self.cyc_fields.append(g.nodes[i][1])

        self.rowidx_row = None
        for i in order:
            if g.nodes[i][0] == ROWIDX:
                self.rowidx_row = len(row)
                row[i] = len(row)

        self.glob_start = len(row)
        self.glob_cols = []
        for i in order:
            if g.nodes[i][0] == GLOBIN:
                row[i] = len(row)
                self.glob_cols.append(g.nodes[i][1])

        # init/rollinit rows GROUPED by back offset: each distinct back
        # becomes one shifted window slice of the padded init matrix per
        # chunk (9 distinct backs in the rv32im exec program)
        self.init_start = len(row)
        by_back = {}
        for i in order:
            kind, a, b, _c = g.nodes[i]
            if kind == INIT:
                by_back.setdefault(0, []).append((a, i))
            elif kind == ROLLINIT:
                by_back.setdefault(b, []).append((a, i))
        self.init_groups = []          # (back, cols_array, file_row_start)
        self.init_specs = []           # flat (col, back) in file order
        for back in sorted(by_back):
            entries = sorted(by_back[back])
            start = len(row)
            cols = []
            for col, i in entries:
                row[i] = len(row)
                cols.append(col)
                self.init_specs.append((col, back))
            self.init_groups.append((back, np.asarray(cols, np.int32),
                                     start))

        # greedy wavefront packing: a node joins its kind's most recent
        # open group when every operand was computed in an earlier group
        # — merges independent same-kind work across levels (the
        # (level, kind) scheme produced ~7.5k groups for the exec graph;
        # this yields far fewer, larger device ops)
        n_args = {ADD: 2, SUB: 2, MUL: 2, AND: 2, OR: 2, NEG: 1, INV: 1,
                  ENC: 1, DEC: 1, ISZ: 1, NZ: 1, EQZB: 1, NOT: 1,
                  INRANGE: 3, SEL: 3, BAND: 2, MODU: 2, IADD: 2, EQU: 2,
                  PAIR16: 2, SHRI: 1, TXNG: 1, CYCG: 1, BIGG: 1, HISTG: 1,
                  XDIVQ: 3, XDIVR: 3}
        import bisect

        glist = []          # [(kind, [members])]
        by_kind = {}        # kind -> sorted group indices
        node_grp = {}       # node -> group index (inputs: -1)
        for i in order:
            kind = g.nodes[i][0]
            if kind in self.INPUT_KINDS:
                node_grp[i] = -1
                continue
            g_req = max((node_grp[d] for d in _deps(g, i)), default=-1)
            lst = by_kind.setdefault(kind, [])
            pos = bisect.bisect_right(lst, g_req)
            if pos < len(lst):
                gi = lst[pos]       # earliest valid group of this kind
            else:
                gi = len(glist)
                glist.append((kind, []))
                lst.append(gi)
            glist[gi][1].append(i)
            node_grp[i] = gi

        self.groups = []
        for kind, members in glist:
            dst = len(row)
            for i in members:
                row[i] = len(row)
            opnds = [np.asarray([row[_deps(g, i)[s]] for i in members],
                                np.int32) for s in range(n_args[kind])]
            # immediates (SHRI shift / TXNG field / BIGG offset / HISTG
            # table) ride in the node's b field
            imms = np.asarray([g.nodes[i][2] for i in members], np.int32)
            self.groups.append((kind, dst, len(members), opnds, imms))

        self.n_rows = len(row)
        self.out_rows = np.asarray([row[i] for i in outputs], np.int32)


_MAXBACK = 68


_PLANS_LOCK = threading.Lock()


def _plans_exec():
    """The graph and its two plans, built once a process and published
    whole (concurrent first calls wait)."""
    eg = exec_graph()
    if not hasattr(eg, "_plans"):
        with _PLANS_LOCK:
            if not hasattr(eg, "_plans"):
                eg._plans = _build_plans_exec(eg)
    return eg, eg._plans


def _build_plans_exec(eg):
    p1o = []
    for m8, m16, idx, _pc in eg.delta_sites:
        p1o += [m8, m16, idx]
    p2o = list(eg.data_cols) + [eg.bad]
    for _col, cond, val in eg.glob_sites:
        p2o += [cond, val]
    p1 = ExecPlan(eg, p1o)
    # the two-pass algorithm requires the delta sites (masks/indices)
    # to be independent of the histograms they feed
    assert all(k != HISTG for k, *_ in p1.groups), \
        "lookup-delta sites must not depend on lookup-current reads"
    return {"p1": p1, "p2": ExecPlan(eg, p2o)}


def _accel_coo(pf, rows, meta):
    """Host-side compact (cols, rows, vals) triples for the accelerator
    back-state (the sparse part of witgen.inject)."""
    inj = meta["inject"]
    kinds = pf["back_kind"]
    offs = pf["back_offset"]
    back = pf["back_data"]
    cols_l, rows_l, vals_l = [], [], []

    def add(cols, rws, vals):
        n = len(rws)
        for i, col in enumerate(cols):
            cols_l.append(np.full(n, col, np.int32))
            rows_l.append(rws.astype(np.int32))
            vals_l.append(vals[i])

    ecall = np.nonzero(kinds == 1)[0]
    if len(ecall):
        o = offs[ecall]
        add([inj["ecall_s0"], inj["ecall_s1"], inj["ecall_s2"]], ecall,
            [back[o], back[o + 1], back[o + 2]])
    p2r = np.nonzero(kinds == 3)[0]
    if len(p2r):
        o = offs[p2r]
        add(inj["p2_state"], p2r,
            [back[o + i] for i in range(len(inj["p2_state"]))])
    shar = np.nonzero(kinds == 2)[0]
    if len(shar):
        o = offs[shar]
        add(inj["sha_fp"], shar,
            [back[o + i] for i in range(len(inj["sha_fp"]))])
        for i, col in enumerate(inj["sha_u32"]):
            word = back[o + 7 + i]
            add([col + b for b in range(32)], shar,
                [(word >> b) & 1 for b in range(32)])
    bir = np.nonzero(kinds == 4)[0]
    if len(bir):
        o = offs[bir]
        add(inj["bigint_state"], bir,
            [back[o + i] for i in range(len(inj["bigint_state"]))])
    if not cols_l:
        return (np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.uint32))
    return (np.concatenate(cols_l), np.concatenate(rows_l),
            np.concatenate([np.asarray(v, np.uint32) for v in vals_l]))


# ---------------------------------------------------------------------------
# Device (torch) evaluator
# ---------------------------------------------------------------------------

# Rows a chunk.  Pass 1 (8,118 register rows, 2,341 groups) takes 2^17
# rows: 8118 x 2^17 x 4 B = 4.3 GB, 8 chunks at po2 20.  Pass 2 (57,112
# rows, 7,637 groups) takes 2^16 rows: 57112 x 2^16 x 4 B = 15.0 GB, 16
# chunks; the pass is bound by launches (about 7.5 x 10^5 kernels a po2
# 20 segment).  2^17 rows a chunk halves them for twice the memory
# (scripts/torch_witgen_bench.py on an NVIDIA H100 80GB HBM3 at 700 W:
# 11.0-13.4 s against 15.5-17.2 s, peak 33.0 GiB against 18.0).
P1_CHUNK = 1 << 17
P2_CHUNK = 1 << 16


def _divide(numer, denom, sign):
    """rv32im divide (csrc/witgen.cpp divide_rv32im) of u32 words in int32
    storage: sign 0 unsigned, 1 signed, 2 signed numerator only.  Divide
    by zero gives quotient 0xFFFFFFFF and remainder numer.  Returns
    (quotient, remainder) as int32 words."""
    n, d, sign = _u32(numer), _u32(denom), sign.to(torch.int64)
    ones = (sign == 2).to(torch.int64)
    neg_n = (sign != 0) & (n >= 1 << 31)
    neg_d = (sign == 1) & (d >= 1 << 31)
    n = torch.where(neg_n, (-n - ones) & _M32, n)
    d = torch.where(neg_d, (-d - ones) & _M32, d)
    dz = d == 0
    dd = d.clamp_min(1)
    quot = torch.where(dz, _M32, n // dd)
    rem = torch.where(dz, n, n % dd)
    quot_neg = (neg_n ^ neg_d).to(torch.int64) - (dz & neg_n).to(torch.int64)
    quot = torch.where(quot_neg != 0, (-quot - ones) & _M32, quot)
    rem = torch.where(neg_n, (-rem - ones) & _M32, rem)
    return quot.to(torch.int32), rem.to(torch.int32)


def _exec_compute(kind, ops, imm, aux):
    """One op group of the exec graph; imm (n, 1) is each member's
    immediate (TXNG field, SHRI shift, BIGG offset, HISTG table)."""
    if kind == TXNG:
        idx = _u32(ops[0]).clamp_max(aux["txns"].shape[1] - 1)
        return aux["txns"][imm, idx]
    if kind == CYCG:
        cu = _u32(ops[0])
        r = (cu // 2).clamp_max(aux["cyc_d0"].shape[0] - 1)
        return torch.where(cu % 2 == 0, aux["cyc_d0"][r], aux["cyc_d1"][r])
    if kind == BIGG:
        idx = ((_u32(ops[0]) + imm) & _M32).clamp_max(
            aux["bigint"].shape[0] - 1)
        return aux["bigint"][idx]
    if kind == HISTG:
        # one table, the u8 counts then the u16 counts
        is8 = imm == 8
        idx = torch.minimum(_u32(ops[0]), torch.where(is8, 255, 65535))
        return aux["hist"][idx + torch.where(is8, 0, 256)]
    if kind == BAND:
        return ops[0] & ops[1]
    if kind == SHRI:
        return (_u32(ops[0]) >> imm).to(torch.int32)
    if kind == MODU:
        a, b = _u32(ops[0]), _u32(ops[1])
        return torch.where(b != 0, a % b.clamp_min(1), 0).to(torch.int32)
    if kind == IADD:
        return ((_u32(ops[0]) + _u32(ops[1])) & _M32).to(torch.int32)
    if kind == EQU:
        return (ops[0] == ops[1]).to(torch.int32)
    if kind == PAIR16:
        return ((_u32(ops[0]) | _u32(ops[1]) << 16) & _M32).to(torch.int32)
    if kind in (XDIVQ, XDIVR):
        return _divide(ops[0], ops[1], ops[2])[kind == XDIVR]
    return _group_compute(kind, ops)


class _ExecDevicePlan:
    """An exec ExecPlan's index arrays, uploaded once per device."""

    def __init__(self, plan, device):
        self.consts = to_torch(plan.const_vals, device)
        self.cyc_fields = _idx(plan.cyc_fields, device)
        self.glob_cols = _idx(plan.glob_cols, device)
        self.init_groups = [(back, _idx(cols, device), start)
                            for back, cols, start in plan.init_groups]
        self.out_rows = _idx(plan.out_rows, device)
        self.groups = [(kind, dst, n, _idx(np.concatenate(opnds), device),
                        _idx(imms, device)[:, None])
                       for kind, dst, n, opnds, imms in plan.groups]


def _run_exec_plan(plan, dp, inputs, aux, chunk, consume):
    """Evaluate a plan chunk by chunk; consume(start, (n_out, T) outputs)
    takes each chunk's outputs."""
    cycles_t, glob_init, init_pad = inputs
    rows = cycles_t.shape[1]
    T = min(chunk, rows)
    dev = cycles_t.device
    file = torch.empty((plan.n_rows, T), dtype=torch.int32, device=dev)
    file[:len(plan.const_vals)] = dp.consts[:, None]
    ng = len(plan.glob_cols)
    file[plan.glob_start:plan.glob_start + ng] = \
        glob_init[dp.glob_cols][:, None]
    nc = len(plan.cyc_fields)

    def compute(g, ops):
        return _exec_compute(g[0], ops, g[4], aux)

    for s in range(0, rows, T):
        file[plan.cyc_start:plan.cyc_start + nc] = \
            cycles_t[:, s:s + T].index_select(0, dp.cyc_fields)
        if plan.rowidx_row is not None:
            file[plan.rowidx_row] = torch.arange(s, s + T, dtype=torch.int32,
                                                 device=dev)
        for back, cols, start in dp.init_groups:
            lo = s + _MAXBACK - back
            file[start:start + len(cols)] = \
                init_pad[:, lo:lo + T].index_select(0, cols)
        _run_groups(dp.groups, file, compute)
        consume(s, file.index_select(0, dp.out_rows))


def _init_from_inputs(cycles_t, accel, inj):
    """The injected data matrix on the device: the dense stateful columns
    from the preflight cycles, and one scatter of the accelerator
    back-state (accel: the (cols, rows, vals) of _accel_coo)."""
    rows = cycles_t.shape[1]
    dev = cycles_t.device
    init = torch.zeros((NUM_DATA, rows), dtype=torch.int32, device=dev)
    init[inj["cycle"]] = torch.arange(rows, dtype=torch.int32, device=dev)
    init[inj["next_pc_low"]] = cycles_t[1] & 0xFFFF
    init[inj["next_pc_high"]] = (cycles_t[1] >> 16) & 0xFFFF
    init[inj["next_state"]] = cycles_t[0]
    init[inj["next_machine_mode"]] = cycles_t[4]
    cols, rws, vals = accel
    init[_idx(cols, dev), _idx(rws, dev)] = to_torch(vals, dev)
    return init


def _exec_pipeline(cycles_t, glob_init, txns_t, bigint, accel, inj, split,
                   p2_chunk):
    """init scatter -> pass 1 (histograms) -> pass 2 (witness).  Returns
    (pass-2 outputs (211 + 1 + 2 x sites, rows), u8 counts, u16 counts)."""
    eg, plans = _plans_exec()
    dev = cycles_t.device
    rows = cycles_t.shape[1]
    init = _init_from_inputs(cycles_t, accel, inj)
    init_pad = torch.cat([init[:, rows - _MAXBACK:], init], 1)
    inputs = (cycles_t, glob_init, init_pad)
    aux = {"txns": txns_t, "bigint": bigint, "cyc_d0": cycles_t[9],
           "cyc_d1": cycles_t[10],
           "hist": torch.zeros(256 + 65536, dtype=torch.int32, device=dev)}

    # pass 1.  The lookup-current reads see the counts as of the first
    # current read in program order: every body-row delta, and the
    # table-region deltas of sites before that read (a table row reads its
    # entry before its own later increments; distinct table rows touch
    # distinct entries).  The returned tables count every site.
    n_sites = len(eg.delta_sites)
    early = _idx([pc < eg.first_current_pc
                  for _m8, _m16, _i, pc in eg.delta_sites], dev)[:, None] != 0
    hist = torch.zeros((2, 256 + 65536), dtype=torch.int64, device=dev)

    def count(s, outs):
        outs = outs.view(n_sites, 3, -1)
        idx = outs[:, 2]
        body = torch.arange(s, s + idx.shape[1], device=dev)[None] < split
        seen = body | early
        # u8 entries at 0-255, u16 entries at 256 + index
        at = torch.cat([idx & 0xFF, (idx & 0xFFFF) + 256]).flatten().to(
            torch.int64)
        hit = torch.cat([outs[:, 0] != 0, outs[:, 1] != 0])
        hist[0].index_add_(0, at, (hit & torch.cat([seen, seen])).flatten()
                           .to(torch.int64))
        hist[1].index_add_(0, at, hit.flatten().to(torch.int64))

    _run_exec_plan(plans["p1"], _exec_device_plan("p1", dev), inputs, aux,
                   P1_CHUNK, count)
    aux["hist"] = hist[0].to(torch.int32)

    # pass 2
    p2 = plans["p2"]
    out = torch.empty((len(p2.out_rows), rows), dtype=torch.int32, device=dev)

    def store(s, outs):
        out[:, s:s + outs.shape[1]] = outs

    _run_exec_plan(p2, _exec_device_plan("p2", dev), inputs, aux, p2_chunk,
                   store)
    return out, hist[1, :256], hist[1, 256:]


_DEVICE_PLANS = {}
_DEVICE_PLANS_LOCK = threading.Lock()


def _exec_device_plan(name, device):
    key = (name, str(device))
    if key not in _DEVICE_PLANS:
        with _DEVICE_PLANS_LOCK:
            if key not in _DEVICE_PLANS:
                _DEVICE_PLANS[key] = _ExecDevicePlan(
                    _plans_exec()[1][name], device)
    return _DEVICE_PLANS[key]


def witgen_exec_device(seg, rand_z=(1, 0, 0, 0), pf=None, device="cuda",
                       p2_chunk=P2_CHUNK):
    """The exec witness on `device`: the same dict as witgen.witgen_exec,
    with `data` a (211, rows) standard-form int32 tensor on the device.
    pf: the segment's preflight (computed when None).  p2_chunk: rows a
    chunk of pass 2.  Raises RuntimeError
    when any row fails an in-circuit check."""
    device = card(device)
    eg = exec_graph()
    meta = _load_meta()
    if pf is None:
        pf = preflight_segment(seg)
    _update_p2_zcheck(pf, rand_z)
    rows = len(pf["cycles"])
    glob = build_global(seg, rand_z)
    glob_init = np.where(glob == INVALID, 0, glob)
    txns = pf["txns"]
    bigint = pf.get("bigint_bytes", np.zeros(0, np.uint32))
    if len(bigint) == 0:
        bigint = np.zeros(16, np.uint32)
    inj = {k: meta["inject"][k] for k in
           ("cycle", "next_pc_low", "next_pc_high", "next_state",
            "next_machine_mode")}
    # the inputs keep their own lengths: eager torch compiles nothing per
    # shape, so they need no bucketing to powers of two
    out, h8, h16 = _exec_pipeline(
        to_torch(pf["cycles"].T, device), to_torch(glob_init, device),
        to_torch(txns.T if len(txns) else np.zeros((5, 1), np.uint32),
                 device),
        to_torch(bigint, device), _accel_coo(pf, rows, meta), inj,
        int(pf["table_split_cycle"]), p2_chunk)
    n_bad = int(out[NUM_DATA].sum())
    if n_bad:
        raise RuntimeError(
            f"exec device eval: {n_bad} rows failed in-circuit checks "
            "(witgen.witgen_exec, the host path, names the check)")

    # global sites in program order, each taking its first writing row
    conds = out[NUM_DATA + 1::2] != 0
    rowidx = torch.arange(rows, device=device)
    first = torch.where(conds, rowidx, rows).amin(1)
    vals = out[NUM_DATA + 2::2].gather(1, first.clamp_max(rows - 1)[:, None])
    first, vals = first.cpu().numpy(), to_numpy(vals[:, 0])
    glob_out = glob_init.copy()
    for si, (col, _cond, _val) in enumerate(eg.glob_sites):
        if first[si] < rows:
            glob_out[col] = vals[si]
    return {"data": out[:NUM_DATA].clone(), "global": glob_out,
            "tables_u8": h8.cpu().numpy().astype(np.uint32),
            "tables_u16": h16.cpu().numpy().astype(np.uint32),
            "preflight": pf, "rows": rows}
