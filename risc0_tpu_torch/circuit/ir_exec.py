"""Host plan building for extracted constraint IRs (the part of
``risc0_tpu/circuit/ir_exec.py`` that ``ir_range.build_range_plan`` needs):
scratch reads and writes resolve to SSA aliases, duplicate tap, constant and
global reads dedupe (``dedup_ops``), and ``deps_of_item`` names each kept
op's operands."""

from __future__ import annotations

# opcode aliases from the rv32im packing
(FCONST, FTAP, FGLOBAL, FSCR_RD, FADD, FSUB, FMUL, ECONST, EMADD, FSCR_WR,
 ESCR_WR, ESCR_RD, EADD, ESUB, EMUL, ESCALE, EADDF, FSUBE, ESUBF) = range(19)


def dedup_ops(circuit):
    """Pass 1: scratch aliasing + dedup of taps/consts/globals.

    Returns (kept, ret_reg): `kept` is the list of (op, dst, operands...)
    with scratch reads/writes resolved to SSA aliases and duplicate
    tap/const/global reads deduplicated; `ret_reg` the final ext register.
    """
    ops, A = circuit.opcode, circuit.operands
    n = len(ops)

    # value ids: ('f', reg) / ('e', reg); alias maps resolve to canonical ids
    alias_f = {}
    alias_e = {}
    fscr_src = {}
    escr_src = {}

    def rf(r):
        while r in alias_f:
            r = alias_f[r]
        return r

    def re_(r):
        while r in alias_e:
            r = alias_e[r]
        return r

    tap_canon = {}
    const_canon = {}
    global_canon = {}
    econst_canon = {}

    kept = []  # (op, dst, operands...) with resolved regs
    for i in range(n):
        op = int(ops[i])
        a, b, c, d, e, f_ = (int(x) for x in A[i])
        if op == FCONST:
            if b in const_canon:
                alias_f[a] = const_canon[b]
            else:
                const_canon[b] = a
                kept.append((FCONST, a, b))
        elif op == FTAP:
            key = (b, c, d)
            if key in tap_canon:
                alias_f[a] = tap_canon[key]
            else:
                tap_canon[key] = a
                kept.append((FTAP, a, key))
        elif op == FGLOBAL:
            key = (b, c)
            if key in global_canon:
                alias_f[a] = global_canon[key]
            else:
                global_canon[key] = a
                kept.append((FGLOBAL, a, key))
        elif op == FSCR_RD:
            alias_f[a] = rf(fscr_src[b])
        elif op == FSCR_WR:
            fscr_src[a] = rf(b)
        elif op == ESCR_RD:
            alias_e[a] = re_(escr_src[b])
        elif op == ESCR_WR:
            escr_src[a] = re_(b)
        elif op == ECONST:
            key = (b, c, d, e)
            if key in econst_canon:
                alias_e[a] = econst_canon[key]
            else:
                econst_canon[key] = a
                kept.append((ECONST, a, key))
        elif op in (FADD, FSUB, FMUL):
            kept.append((op, a, rf(b), rf(c)))
        elif op in (EADD, ESUB, EMUL):
            kept.append((op, a, re_(b), re_(c)))
        elif op == ESCALE or op == EADDF:
            kept.append((op, a, re_(b), rf(c)))
        elif op == FSUBE:
            kept.append((op, a, rf(b), re_(c)))
        elif op == ESUBF:
            kept.append((op, a, re_(b), rf(c)))
        elif op == EMADD:
            ffs = tuple(rf(x) for x in (d, e) if x >= 0)
            ef = re_(f_) if f_ >= 0 else -1
            kept.append((EMADD, a, re_(b), c, ffs, ef))
        else:
            raise ValueError(f"bad opcode {op}")

    return kept, re_(circuit.ret[1])


def deps_of_item(item):
    """(fp_deps, ext_deps) of a dedup'd op."""
    op = item[0]
    if op in (FCONST, FTAP, FGLOBAL, ECONST):
        return (), ()
    if op in (FADD, FSUB, FMUL):
        return (item[2], item[3]), ()
    if op in (EADD, ESUB, EMUL):
        return (), (item[2], item[3])
    if op in (ESCALE, EADDF):
        return (item[3],), (item[2],)
    if op == FSUBE:
        return (item[2],), (item[3],)
    if op == ESUBF:
        return (item[3],), (item[2],)
    if op == EMADD:
        fdeps = item[4]
        edeps = (item[2],) + ((item[5],) if item[5] >= 0 else ())
        return fdeps, edeps
    raise AssertionError

