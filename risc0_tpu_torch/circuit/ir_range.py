"""Range-file evaluator of extracted constraint IRs on torch (counterpart of
``risc0_tpu/circuit/ir_range.py``).

``build_range_plan`` is the reference's host plan builder: every op's
destination is a fresh row of an append-only register file, ops of one
(level, opcode) group get contiguous rows, ``emadd`` accumulation chains
collapse into batched multiply-and-sum ops and single-use add/sub trees
into signed sums (field addition is associative, so both are exact).

``make_eval_check`` runs that plan over the 4x domain in chunks of T rows
on the device of the evaluated groups: an (fp_rows, T) int32 register file
and an (ext_rows, T, 4) one, one torch op group after another.  Sums take
int64 and reduce once (the reference's 16-bit halves exist only because
the TPU has no u64).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .. import field as F
from ..convert import to_torch
from . import ir_exec
from .ir_exec import (EADD, EADDF, ECONST, EMADD, EMUL, ESCALE, ESUB, ESUBF,
                      FADD, FCONST, FGLOBAL, FMUL, FSUB, FSUBE, FTAP,
                      deps_of_item)


@dataclass
class Chain:
    """A collapsed emadd accumulation chain."""

    dst: int                 # ext reg of the final acc
    acc: int                 # ext reg feeding the first emadd
    t1f: list                # [(mix_idx, f_reg)]        term = pm^k * f
    te: list                 # [(mix_idx, e_reg)]        term = pm^k * e
    tfe: list                # [(mix_idx, f_reg, e_reg)] term = pm^k * f * e


@dataclass
class RangePlan:
    const_vals: np.ndarray       # (nc,) Montgomery fp constants
    tap_specs: list              # [(buf, col, back)]
    global_specs: list           # [(buf, idx)]
    econst_vals: np.ndarray      # (ne, 4) Montgomery
    fp_rows: int = 0             # total fp file rows
    ext_rows: int = 0            # total ext file rows
    groups: list = field(default_factory=list)   # execution order
    ret_row: int = 0


def _collapse_chains(kept, ret_reg):
    """Replace single-use emadd chains with Chain records."""
    euse = {}

    def use(r):
        euse[r] = euse.get(r, 0) + 1

    for item in kept:
        _f, edeps = deps_of_item(item)
        for r in edeps:
            use(r)
    use(ret_reg)

    prod = {}
    for i, item in enumerate(kept):
        if item[0] in (ECONST, EADD, ESUB, EMUL, ESCALE, EADDF, FSUBE,
                       ESUBF, EMADD):
            prod[item[1]] = i

    # i -> index of the emadd consuming kept[i]'s acc output (chain link)
    chain_prev = {}
    for i, item in enumerate(kept):
        if item[0] != EMADD:
            continue
        j = prod.get(item[2])
        if j is not None and kept[j][0] == EMADD and euse[item[2]] == 1:
            chain_prev[i] = j

    linked = set(chain_prev.values())
    out = []
    for i, item in enumerate(kept):
        if item[0] == EMADD and i in linked:
            continue  # interior chain member; emitted at the terminator
        if item[0] == EMADD:
            # terminator: walk back to the chain start
            members = [i]
            cur = i
            while cur in chain_prev:
                cur = chain_prev[cur]
                members.append(cur)
            members.reverse()
            first = kept[members[0]]
            ch = Chain(dst=item[1], acc=first[2], t1f=[], te=[], tfe=[])
            for m in members:
                _, _dst, _acc, k, ffs, ef = kept[m]
                if len(ffs) == 1 and ef < 0:
                    ch.t1f.append((k, ffs[0]))
                elif len(ffs) == 0 and ef >= 0:
                    ch.te.append((k, ef))
                elif len(ffs) == 1 and ef >= 0:
                    ch.tfe.append((k, ffs[0], ef))
                else:  # no factors, or several: not in the extracted IRs
                    raise NotImplementedError(
                        f"emadd with {len(ffs)} fp factors, ext {ef}")
            out.append(ch)
        else:
            out.append(item)
    return out


@dataclass
class FSum:
    """A collapsed fadd/fsub tree: dst = Σ sign_i * fp[leaf_i]."""

    dst: int
    leaves: list                 # [(sign ±1, fp_reg)]


def _collapse_fp_sums(nodes):
    """Fold single-use FADD/FSUB operands into their consumer, turning
    add/sub trees into flat signed sums (one gather and one int64 sum;
    field addition is associative so the result is bit-exact).  The rv32im
    IR has 5.9k add/sub ops in ~500 ASAP levels of mostly width-1 groups —
    the dominant serialization of the eval_check graph."""
    fuse = {}

    def use(r):
        fuse[r] = fuse.get(r, 0) + 1

    addsub_consumer = {}  # fp reg -> True if every use is by an addsub op
    for item in nodes:
        if isinstance(item, Chain):
            for _k, f in item.t1f:
                use(f)
            for _k, f, _e in item.tfe:
                use(f)
            continue
        fd, _ed = deps_of_item(item)
        is_addsub = item[0] in (FADD, FSUB)
        for r in fd:
            use(r)
            addsub_consumer[r] = addsub_consumer.get(r, True) and is_addsub

    prod = {}
    for i, item in enumerate(nodes):
        if not isinstance(item, Chain) and item[0] in (FADD, FSUB):
            prod[item[1]] = i

    absorbable = {r for r, i in prod.items()
                  if fuse.get(r) == 1 and addsub_consumer.get(r, False)}

    def expand(reg, sign, out):
        # iterative (explicit stack): absorbable chains in the rv32im IR
        # are ~500 levels deep already, too close to Python's recursion
        # limit to recurse per absorbed node
        stack = [(reg, sign)]
        while stack:
            r, s = stack.pop()
            i = prod.get(r)
            if i is None or r not in absorbable:
                out.append((s, r))
                continue
            item = nodes[i]
            # push right first so the left operand is expanded first: the
            # reference's left-to-right leaf order, so both plans match
            stack.append((item[3], s if item[0] == FADD else -s))
            stack.append((item[2], s))

    out_nodes = []
    for item in nodes:
        if isinstance(item, Chain) or item[0] not in (FADD, FSUB):
            out_nodes.append(item)
            continue
        if item[1] in absorbable:
            continue  # folded into its consumer
        leaves = []
        expand(item[2], 1, leaves)
        expand(item[3], 1 if item[0] == FADD else -1, leaves)
        if len(leaves) == 2 and leaves[0][0] == 1:
            out_nodes.append(item)  # plain binary op: keep the cheap form
        else:
            assert len(leaves) < (1 << 15)
            out_nodes.append(FSum(dst=item[1], leaves=leaves))
    return out_nodes


def build_range_plan(circuit) -> RangePlan:
    kept, ret_reg = ir_exec.dedup_ops(circuit)
    nodes = _collapse_chains(kept, ret_reg)
    nodes = _collapse_fp_sums(nodes)

    # ---- input staging rows ----------------------------------------------
    const_vals, tap_specs, global_specs, econst_vals = [], [], [], []
    fp_row = {}
    ext_row = {}
    body = []
    for item in nodes:
        if isinstance(item, (Chain, FSum)):
            body.append(item)
            continue
        op = item[0]
        if op == FCONST:
            fp_row[item[1]] = len(const_vals)
            const_vals.append(F.s_encode(int(item[2])))
        elif op == FTAP:
            tap_specs.append(tuple(int(x) for x in item[2]))
            fp_row[item[1]] = ("tap", len(tap_specs) - 1)
        elif op == FGLOBAL:
            global_specs.append(tuple(int(x) for x in item[2]))
            fp_row[item[1]] = ("glob", len(global_specs) - 1)
        elif op == ECONST:
            ext_row[item[1]] = len(econst_vals)
            econst_vals.append(F.encode_np(np.array(item[2], np.uint32)))
        else:
            body.append(item)
    nc, nt, ng = len(const_vals), len(tap_specs), len(global_specs)
    # Reorder taps so all accum-buffer taps come before data-buffer taps:
    # the chunk runner then builds the tap rows as two gathers + one concat
    # instead of a scatter.
    tap_order = sorted(range(nt), key=lambda i: tap_specs[i][0])
    tap_pos = {old: new for new, old in enumerate(tap_order)}
    tap_specs = [tap_specs[i] for i in tap_order]
    # final fp layout: [consts][taps][globals][op outputs...]
    for r, v in list(fp_row.items()):
        if isinstance(v, tuple):
            fp_row[r] = (nc + tap_pos[v[1]] if v[0] == "tap"
                         else nc + nt + v[1])

    # ---- levelize ---------------------------------------------------------
    lvl_f = {r: 0 for r in fp_row}
    lvl_e = {r: 0 for r in ext_row}
    node_level = []
    for item in body:
        if isinstance(item, FSum):
            lvl = 0
            for _s, r in item.leaves:
                lvl = max(lvl, lvl_f[r] + 1)
            lvl_f[item.dst] = lvl
            node_level.append(lvl)
            continue
        if isinstance(item, Chain):
            deps_f = [f for _, f in item.t1f] + [f for _, f, _ in item.tfe]
            deps_e = ([item.acc] + [e for _, e in item.te]
                      + [e for _, _, e in item.tfe])
            lvl = 0
            for r in deps_f:
                lvl = max(lvl, lvl_f[r] + 1)
            for r in deps_e:
                lvl = max(lvl, lvl_e[r] + 1)
            lvl_e[item.dst] = lvl
        else:
            fdeps, edeps = deps_of_item(item)
            lvl = 0
            for r in fdeps:
                lvl = max(lvl, lvl_f[r] + 1)
            for r in edeps:
                lvl = max(lvl, lvl_e[r] + 1)
            if item[0] in (FADD, FSUB, FMUL):
                lvl_f[item[1]] = lvl
            else:
                lvl_e[item[1]] = lvl
        node_level.append(lvl)

    order = sorted(range(len(body)), key=lambda i: node_level[i])

    # ---- contiguous allocation + grouping ---------------------------------
    fp_next = nc + nt + ng
    ext_next = len(econst_vals)
    groups = []
    i = 0
    KIND = {FADD: "fadd", FSUB: "fsub", FMUL: "fmul", EADD: "eadd",
            ESUB: "esub", EMUL: "emul", ESCALE: "escale", EADDF: "eaddf",
            FSUBE: "fsube", ESUBF: "esubf"}
    while i < len(order):
        lvl = node_level[order[i]]
        j = i
        by_kind = {}
        while j < len(order) and node_level[order[j]] == lvl:
            item = body[order[j]]
            k = ("chain" if isinstance(item, Chain)
                 else "fsum" if isinstance(item, FSum)
                 else KIND[item[0]])
            by_kind.setdefault(k, []).append(item)
            j += 1
        for kind, items in by_kind.items():
            if kind == "chain":
                for ch in items:
                    ext_row[ch.dst] = ext_next
                    ext_next += 1
                    groups.append(("chain", ch))
                continue
            if kind == "fsum":
                # one batched group per level: pad to the longest sum
                dst0 = fp_next
                for fs in items:
                    fp_row[fs.dst] = fp_next
                    fp_next += 1
                groups.append(("fsum", dst0, items, None))
                continue
            is_fp = kind in ("fadd", "fsub", "fmul")
            dst0 = fp_next if is_fp else ext_next
            a_idx, b_idx = [], []
            for item in items:
                if is_fp:
                    fp_row[item[1]] = fp_next
                    fp_next += 1
                    a_idx.append(item[2])
                    b_idx.append(item[3])
                else:
                    ext_row[item[1]] = ext_next
                    ext_next += 1
                    a_idx.append(item[2])
                    b_idx.append(item[3])
            groups.append((kind, dst0, a_idx, b_idx))
        i = j

    # resolve reg ids -> rows in operand arrays
    resolved = []
    for g in groups:
        if g[0] == "fsum":
            _kind, dst0, items, _ = g
            L = max(len(fs.leaves) for fs in items)
            rows = np.zeros((len(items), L), np.int32)
            signs = np.zeros((len(items), L), np.int8)
            for i, fs in enumerate(items):
                for j, (s, r) in enumerate(fs.leaves):
                    rows[i, j] = fp_row[r]
                    signs[i, j] = s
            resolved.append(("fsum", dst0, rows, signs))
            continue
        if g[0] == "chain":
            ch = g[1]
            resolved.append(("chain", {
                "dst": ext_row[ch.dst],
                "acc": ext_row[ch.acc],
                "t1f": np.array([(k, fp_row[f]) for k, f in ch.t1f],
                                np.int32).reshape(-1, 2),
                "te": np.array([(k, ext_row[e]) for k, e in ch.te],
                               np.int32).reshape(-1, 2),
                "tfe": np.array([(k, fp_row[f], ext_row[e])
                                 for k, f, e in ch.tfe],
                                np.int32).reshape(-1, 3),
            }))
            continue
        kind, dst0, a_idx, b_idx = g
        if kind in ("fadd", "fsub", "fmul"):
            a = np.array([fp_row[r] for r in a_idx], np.int32)
            b = np.array([fp_row[r] for r in b_idx], np.int32)
        elif kind in ("eadd", "esub", "emul"):
            a = np.array([ext_row[r] for r in a_idx], np.int32)
            b = np.array([ext_row[r] for r in b_idx], np.int32)
        elif kind in ("escale", "eaddf", "esubf"):
            a = np.array([ext_row[r] for r in a_idx], np.int32)
            b = np.array([fp_row[r] for r in b_idx], np.int32)
        elif kind == "fsube":
            a = np.array([fp_row[r] for r in a_idx], np.int32)
            b = np.array([ext_row[r] for r in b_idx], np.int32)
        resolved.append((kind, dst0, a, b))

    plan = RangePlan(
        const_vals=np.array(const_vals, np.uint32),
        tap_specs=tap_specs,
        global_specs=global_specs,
        econst_vals=(np.stack(econst_vals) if econst_vals
                     else np.zeros((0, 4), np.uint32)),
        fp_rows=fp_next,
        ext_rows=ext_next,
        groups=resolved,
        ret_row=ext_row[ret_reg],
    )
    return plan


def plan_buf_ids(plan) -> list:
    """Sorted buffer ids referenced by the plan's taps (build_range_plan
    orders tap rows by buffer id)."""
    return sorted({int(s[0]) for s in plan.tap_specs})


def inv_zeros_pattern(po2: int) -> np.ndarray:
    """1 / ((3x)^cycles - 1) over the shifted 4x domain, which repeats with
    period 4 (reference hal/cpu.rs:192-197)."""
    cycles = 1 << po2
    w = F.s_encode(F.ROU_FWD[po2 + 2])
    kpow = F.s_pow(F.s_encode(3), cycles)
    wq = F.s_pow(w, cycles)
    ys, cw = [], F.MONT_ONE
    for _ in range(4):
        ys.append(F.s_inv(F.s_sub(F.s_mul(kpow, cw), F.MONT_ONE)))
        cw = F.s_mul(cw, wq)
    return np.array(ys, np.uint32)


# Elements of the largest int64 temporary a group may build at once; the
# signed sums and emadd chains split their rows to stay under it.
_TEMP_ELEMS = 1 << 27


def _idx(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class _DevicePlan:
    """A RangePlan's operand index arrays, uploaded once per device."""

    def __init__(self, plan: RangePlan, device):
        self.groups = []
        for g in plan.groups:
            if g[0] == "chain":
                ch = g[1]
                self.groups.append(("chain", {
                    "dst": ch["dst"], "acc": ch["acc"],
                    "t1f": [_idx(ch["t1f"][:, i], device) for i in range(2)],
                    "te": [_idx(ch["te"][:, i], device) for i in range(2)],
                    "tfe": [_idx(ch["tfe"][:, i], device) for i in range(3)],
                }))
            elif g[0] == "fsum":
                _k, dst0, rows, signs = g
                self.groups.append(("fsum", dst0, _idx(rows, device),
                                    _idx(signs, device)))
            else:
                kind, dst0, a, b = g
                self.groups.append((kind, dst0, _idx(a, device),
                                    _idx(b, device)))
        self.const_vals = to_torch(plan.const_vals, device)
        self.econst_vals = to_torch(plan.econst_vals, device)
        # tap rows per (buffer, back): positions in the tap block + columns
        specs = np.array(plan.tap_specs, np.int64).reshape(-1, 3)
        self.taps = []
        for pos_b, buf in enumerate(plan_buf_ids(plan)):
            for back in sorted({int(b) for b in specs[specs[:, 0] == buf, 2]}):
                sel = np.nonzero((specs[:, 0] == buf) & (specs[:, 2] == back))[0]
                self.taps.append((pos_b, back, _idx(sel, device),
                                  _idx(specs[sel, 1], device)))


def _chain_sum(pm, fp, ext, parts, T):
    """acc + sum_k pm^k * term_k for one collapsed emadd chain, (T, 4)."""
    tot = ext[parts["acc"]].to(torch.int64)
    blk = max(1, _TEMP_ELEMS // (4 * T))
    ks, fs = parts["t1f"]
    raw = torch.zeros((T, 4), dtype=torch.int64, device=fp.device)
    for i in range(0, len(ks), blk):
        # keep the R^2 of the raw products: one R^-1 after the sum
        raw += (pm.index_select(0, ks[i:i + blk])[:, None, :].to(torch.int64)
                * fp.index_select(0, fs[i:i + blk])[:, :, None] % F.P).sum(0)
    tot += raw % F.P * F.R_INV % F.P
    ks, es = parts["te"]
    for i in range(0, len(ks), blk):
        tot += F.ext_mul(pm.index_select(0, ks[i:i + blk])[:, None, :],
                         ext.index_select(0, es[i:i + blk])).to(
                             torch.int64).sum(0)
    ks, fs, es = parts["tfe"]
    for i in range(0, len(ks), blk):
        t = F.mul(pm.index_select(0, ks[i:i + blk])[:, None, :],
                  fp.index_select(0, fs[i:i + blk])[:, :, None])
        tot += F.ext_mul(t, ext.index_select(0, es[i:i + blk])).to(
            torch.int64).sum(0)
    return (tot % F.P).to(torch.int32)


def _run_chunk(dplan, fp, ext, pm, T):
    """Execute every op group for one chunk whose inputs are staged in the
    register files; returns nothing (results land in fp / ext)."""
    for g in dplan.groups:
        kind = g[0]
        if kind == "chain":
            ext[g[1]["dst"]] = _chain_sum(pm, fp, ext, g[1], T)
            continue
        if kind == "fsum":
            _k, dst0, rows, signs = g
            n, L = rows.shape
            blk = max(1, _TEMP_ELEMS // (L * T))
            for i in range(0, n, blk):
                vals = fp[rows[i:i + blk]].to(torch.int64)       # (b, L, T)
                s = (vals * signs[i:i + blk, :, None]).sum(1) % F.P
                fp[dst0 + i : dst0 + i + s.shape[0]] = s.to(torch.int32)
            continue
        _k, dst0, a, b = g
        if kind == "fadd":
            vals = F.add(fp[a], fp[b])
        elif kind == "fsub":
            vals = F.sub(fp[a], fp[b])
        elif kind == "fmul":
            vals = F.mul(fp[a], fp[b])
        elif kind == "eadd":
            vals = F.add(ext[a], ext[b])
        elif kind == "esub":
            vals = F.sub(ext[a], ext[b])
        elif kind == "emul":
            vals = F.ext_mul(ext[a], ext[b])
        elif kind == "escale":
            vals = F.mul(ext[a], fp[b][:, :, None])
        elif kind == "eaddf":
            vals = ext[a]
            vals[:, :, 0] = F.add(vals[:, :, 0], fp[b])
        elif kind == "esubf":
            vals = ext[a]
            vals[:, :, 0] = F.sub(vals[:, :, 0], fp[b])
        elif kind == "fsube":
            vals = F.neg(ext[b])
            vals[:, :, 0] = F.sub(fp[a], ext[b][:, :, 0])
        else:
            raise ValueError(f"bad group {kind}")
        if kind in ("fadd", "fsub", "fmul"):
            fp[dst0 : dst0 + vals.shape[0]] = vals
        else:
            ext[dst0 : dst0 + vals.shape[0]] = vals


def make_eval_check(plan: RangePlan, po2: int, chunk: int = 1 << 16):
    """The full-domain eval_check for one po2.

    Returns fn(evs, gvals, pm_pows) -> (4, domain) int32 check polynomial
    (zeros-poly division included) on the device of `evs`, a tuple of
    evaluated (cols, domain) group tensors in ``plan_buf_ids(plan)`` order;
    gvals (n_globals,) and pm_pows (n, 4) are host u32 arrays.  The domain
    runs in chunks of T = min(chunk, domain) rows.
    """
    domain = (1 << po2) * 4
    T = min(chunk, domain)
    invz = inv_zeros_pattern(po2)
    nc, nt = len(plan.const_vals), len(plan.tap_specs)
    cache = {}

    def run(evs, gvals, pm_pows):
        dev = evs[0].device
        dplan = cache.get(str(dev))
        if dplan is None:
            dplan = cache[str(dev)] = _DevicePlan(plan, dev)
        fp = torch.zeros((plan.fp_rows, T), dtype=torch.int32, device=dev)
        ext = torch.zeros((plan.ext_rows, T, 4), dtype=torch.int32,
                          device=dev)
        fp[:nc] = dplan.const_vals[:, None]
        if len(gvals):
            fp[nc + nt : nc + nt + len(gvals)] = to_torch(gvals, dev)[:, None]
        ne = len(plan.econst_vals)
        if ne:
            ext[:ne] = dplan.econst_vals[:, None, :]
        pm = to_torch(pm_pows, dev)
        ar = torch.arange(T, device=dev)
        tot = torch.empty((domain, 4), dtype=torch.int32, device=dev)
        for start in range(0, domain, T):
            for pos_b, back, sel, cols in dplan.taps:
                idx = (start - 4 * back + ar) % domain
                fp[nc + sel] = evs[pos_b][cols[:, None], idx[None, :]]
            _run_chunk(dplan, fp, ext, pm, T)
            tot[start : start + T] = ext[plan.ret_row]
        out = F.mul(tot.view(domain // 4, 4, 4),
                    to_torch(invz, dev)[None, :, None])
        return out.view(domain, 4).T.contiguous()

    return run


@lru_cache(maxsize=None)
def _range_plan(circuit) -> RangePlan:
    return build_range_plan(circuit)


class RangePlanHal:
    """A prover's eval_check through ``make_eval_check``, chunked over the
    domain on the device of the evaluated groups (T = `chunk` rows).  The
    IRs' tap buffers are 0 (accum), 1 (data) and, in the recursion
    circuit, 4 (code); the result does not depend on the chunk."""

    def __init__(self, circuit, chunk: int):
        self.circuit = circuit
        self.chunk = chunk
        self.plan = _range_plan(circuit)
        self._fns = {}

    def eval_check(self, groups, globals_list, poly_mix, po2):
        fn = self._fns.get(po2)
        if fn is None:
            fn = self._fns[po2] = make_eval_check(self.plan, po2,
                                                  chunk=self.chunk)
        mix_g, out_g = (np.asarray(g, np.uint32) for g in globals_list)
        accum, code, data = groups
        bufmap = {0: accum, 1: data, 4: code}
        evs = tuple(bufmap[b] for b in plan_buf_ids(self.plan))
        gvals = np.array([(out_g if b == 2 else mix_g)[i]
                          for b, i in self.plan.global_specs], np.uint32)
        return fn(evs, gvals, self.circuit.mix_pows(poly_mix))
