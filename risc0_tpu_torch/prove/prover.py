"""Generic DEEP-ALI/FRI STARK prover (counterpart of
``risc0_tpu/prove/prover.py``; reference risc0/zkp/src/prove/prover.rs).

The IOP orchestration runs on the host; every bulk polynomial or hash op
runs on the prover's device through ``hal/torch_hal.py``.  Seals are the
reference's, word for word.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import field as F
from .. import perf
from ..convert import card, to_numpy
from ..core import ntt
from ..hal import torch_hal as hal
from . import soundness
from .fri import fri_prove
from .merkle import MerkleTreeProver
from .write_iop import WriteIOP

INV_RATE = 4
EXT_SIZE = 4
CHECK_SIZE = INV_RATE * EXT_SIZE
QUERIES = 50


class PolyGroup:
    """Committed group (reference risc0/zkp/src/prove/poly_group.rs): the
    natural-order coefficients, the evaluated LDE matrix and its Merkle
    tree, all on the device."""

    def __init__(self, coeffs_nat, evaluated, layers):
        self.count, self.size = coeffs_nat.shape
        self.coeffs = coeffs_nat
        self.evaluated = evaluated
        self.merkle = MerkleTreeProver(evaluated, QUERIES, layers=layers)

    @staticmethod
    def commit_witness(witness, device, encode: bool = False):
        """Group from a (count, cycles) witness (numpy u32 or int32 tensor)
        through the commit pipeline; encode=True takes standard-form
        words and Montgomery-encodes on the device."""
        return PolyGroup(*hal.commit_pipeline(witness, encode=encode,
                                              device=device))

    @staticmethod
    def from_coeffs(coeffs_br):
        """Group from bit-reversed coefficients (no zk shift)."""
        evaluated = hal.expand_evaluate(coeffs_br, 2)
        return PolyGroup(ntt.bit_reverse(coeffs_br), evaluated,
                         hal.merkle_layers(evaluated))


class Prover:
    def __init__(self, suite, taps, device="cuda"):
        self.suite = suite
        self.taps = taps
        self.device = card(device)
        self.iop = WriteIOP(suite)
        self.groups = [None] * taps.num_groups
        self.po2 = None
        self.cycles = 0
        self.soundness = None

    def set_po2(self, po2: int):
        if self.po2 is not None:
            raise RuntimeError("po2 already set")
        self.po2 = po2
        self.cycles = 1 << po2

    def commit_group(self, group_id: int, witness, encode: bool = False):
        """witness: (group_size, cycles) Montgomery words (numpy u32 or an
        int32 tensor), or standard form with encode=True."""
        count, size = witness.shape
        if size != self.cycles or count != self.taps.group_size(group_id):
            raise ValueError(f"group {group_id}: witness shape "
                             f"{tuple(witness.shape)}")
        if self.groups[group_id] is not None:
            raise RuntimeError(f"group {group_id} already committed")
        with perf.scope(f"commit_group.{group_id}", sync=self.device):
            pg = PolyGroup.commit_witness(witness, self.device, encode=encode)
            self.groups[group_id] = pg
            pg.merkle.commit(self.iop)   # the root readback syncs the device
        return pg

    def finalize(self, globals_list, circuit_hal):
        """globals_list: host uint32 arrays (mix, out, ...) passed to
        eval_check; circuit_hal.eval_check(groups, globals, poly_mix, po2)
        returns the (4, domain) check polynomial as a device tensor."""
        taps = self.taps
        iop = self.iop
        dev = self.device
        poly_mix = iop.random_ext_elem()
        domain = self.cycles * INV_RATE

        with perf.scope("eval_check", sync=dev):
            check_poly = circuit_hal.eval_check(
                [pg.evaluated for pg in self.groups], globals_list,
                poly_mix, self.po2)
            if tuple(check_poly.shape) != (EXT_SIZE, domain):
                raise ValueError(f"check poly shape {tuple(check_poly.shape)}")

        # iNTT the 4 planar polys; the bit-reversed coeffs read as 16 polys
        # of length cycles (prover.rs:143-178)
        with perf.scope("check_commit", sync=dev):
            check_group = PolyGroup(*hal.check_pipeline(check_poly,
                                                        CHECK_SIZE))
            check_group.merkle.commit(iop)

        # DEEP query point
        z = iop.random_ext_elem()
        back_one = F.s_encode(F.ROU_REV[self.po2])

        # evaluate every tap at z * back_one^back, groups accum/code/data
        with perf.scope("tap_eval", sync=dev):
            with perf.scope("tap_xs"):
                group_ids, cols, backs = [], [], []
                for gid in range(taps.num_groups):
                    for offset, back in taps.group_taps(gid):
                        group_ids.append(gid)
                        cols.append(offset)
                        backs.append(back)
                ub = sorted(set(backs))
                xs_distinct = np.stack(
                    [F.ext_mul_np(_base_pow_ext(back_one, b), z) for b in ub])
                back_idx = [ub.index(b) for b in backs]
            with perf.scope("tap_device"):
                eval_u = to_numpy(hal.evaluate_tap_groups(
                    [g.coeffs for g in self.groups], group_ids, cols, backs,
                    xs_distinct, back_idx))

            # Lagrange interpolation at fixed nodes is linear and every
            # register of a combo shares its nodes: one basis per combo,
            # applied to all member registers at once
            with perf.scope("tap_interp"):
                sizes = np.array([r.size for r in taps.regs])
                offs = np.concatenate([[0], np.cumsum(sizes)])
                coeff_u = np.zeros((int(offs[-1]), 4), np.uint32)
                z_inv = F.ext_inv_np(z)
                for cid, combo_backs in enumerate(taps.combos):
                    ridx = [i for i, r in enumerate(taps.regs)
                            if r.combo_id == cid]
                    if not ridx:
                        continue
                    s = len(combo_backs)
                    basis_c = _lagrange_basis_cached(self.po2, back_one,
                                                     combo_backs)
                    zinv_pows = F.ext_powers_np(z_inv, s)
                    basis = F.mul_np(
                        np.broadcast_to(basis_c[:, :, None], (s, s, 4)),
                        zinv_pows[None, :, :])
                    ev = np.stack([eval_u[offs[i] : offs[i] + s]
                                   for i in ridx])
                    prod = F.ext_mul_np(ev[:, :, None, :], basis[None])
                    out = prod[:, 0]
                    for i in range(1, s):
                        out = F.add_np(out, prod[:, i])
                    for k, i in enumerate(ridx):
                        coeff_u[offs[i] : offs[i] + s] = out[k]
                coeff_u = list(coeff_u)

            # check-poly openings at z^4
            with perf.scope("tap_check_eval"):
                z_pow = F.ext_pow_np(z, EXT_SIZE)
                xs = np.broadcast_to(z_pow, (CHECK_SIZE, 4)).copy()
                check_u = to_numpy(hal.batch_evaluate_any(
                    check_group.coeffs, np.arange(CHECK_SIZE), xs))
                coeff_u.extend(check_u)

            with perf.scope("tap_commit"):
                coeff_u = np.stack(coeff_u)  # (num_taps + CHECK_SIZE, 4)
                iop.write_field_elems(coeff_u)
                iop.commit(self.suite.hash_elem_slice(coeff_u.ravel()))

        # FRI batching mix
        mix = iop.random_ext_elem()
        with perf.scope("combos", sync=dev):
            combo_count = taps.combos_size
            combos = torch.zeros((combo_count + 1, self.cycles, 4),
                                 dtype=torch.int32, device=dev)

            # mix the committed coefficients into combos (prover.rs:278-318)
            with perf.scope("combos_mix"):
                total = sum(taps.group_size(g) for g in range(taps.num_groups))
                pow_table = F.ext_powers_np(mix, total + CHECK_SIZE)
                base = 0
                for gid in range(taps.num_groups):
                    regs = taps.group_regs(gid)
                    group_size = taps.group_size(gid)
                    if len(regs) != group_size:
                        raise ValueError("register groups must be dense")
                    which = np.array([r.combo_id for r in regs])
                    hal.mix_poly_coeffs(
                        combos, pow_table[base : base + group_size],
                        self.groups[gid].coeffs, which, combo_count)
                    base += group_size
                hal.mix_poly_coeffs(
                    combos, pow_table[base : base + CHECK_SIZE],
                    check_group.coeffs, np.full(CHECK_SIZE, combo_count),
                    combo_count)

            # combos_prepare: subtract the claimed opening polys
            # (hal/mod.rs:202-234); only coefficients [0, max_reg_size)
            # change, so the correction is built on the host
            with perf.scope("combos_prepare"):
                max_size = max([reg.size for reg in taps.regs] + [1])
                n_regs = len(taps.regs)
                reg_pows = F.ext_powers_np(mix, n_regs + CHECK_SIZE)
                tap_pows = np.repeat(reg_pows[:n_regs], sizes, axis=0)
                tap_pows = np.concatenate([tap_pows, reg_pows[n_regs:]])
                terms = F.ext_mul_np(tap_pows, coeff_u)
                corr64 = np.zeros((combo_count + 1, max_size, 4), np.uint64)
                slot_c = np.concatenate(
                    [np.repeat([r.combo_id for r in taps.regs], sizes),
                     np.full(CHECK_SIZE, combo_count)])
                slot_i = np.concatenate(
                    [np.concatenate([np.arange(r.size) for r in taps.regs]),
                     np.zeros(CHECK_SIZE, int)])
                np.add.at(corr64, (slot_c, slot_i), terms.astype(np.uint64))
                corr = (corr64 % np.uint64(F.P)).astype(np.uint32)
                hal.combos_subtract_head(combos, corr)

            # combos_divide: exact division by each (x - z*back_one^back)
            with perf.scope("combos_divide"):
                n_levels = max(len(b) for b in taps.combos)
                m = combo_count + 1
                zs_levels = np.zeros((n_levels, m, 4), np.uint32)
                zs_levels[:, :, 0] = F.MONT_ONE  # ONE for inactive rows
                active = np.zeros((n_levels, m), bool)
                for c in range(combo_count):
                    for lvl, back in enumerate(taps.combos[c]):
                        zs_levels[lvl, c] = F.ext_mul_np(
                            z, _base_pow_ext(back_one, back))
                        active[lvl, c] = True
                combos, rems = hal.combos_divide(combos, zs_levels, active,
                                                 z_pow)
                if to_numpy(rems).any():
                    raise RuntimeError("combo remainder != 0")

            # sum combos into the final FRI polynomial, planar bit-reversed
            with perf.scope("combos_sum"):
                final_coeffs = ntt.bit_reverse(hal.eltwise_sum_extelem(combos))
            del combos

        def inner(positions):
            prefetched = [pg.merkle.prefetch(positions) for pg in self.groups]
            prefetched.append(check_group.merkle.prefetch(positions))

            def write(iop_, qi):
                for pf in prefetched:
                    pf.write(iop_, qi)

            return write

        with perf.scope("fri_prove", sync=dev):
            fri_prove(iop, final_coeffs, inner)

        with perf.scope("soundness"):
            self.soundness = {
                "proven": soundness.proven(taps, self.cycles * EXT_SIZE),
                "conjectured": soundness.toy_model_security(
                    taps, self.cycles * EXT_SIZE),
            }
        return iop.proof


_BASIS_CACHE: dict = {}


def _lagrange_basis_cached(po2: int, back_one: int, combo_backs) -> np.ndarray:
    """Lagrange basis matrix at the base-field nodes back_one^back:
    out[i, j] = coefficient j of the poly that is 1 at node i and 0 at the
    others (Montgomery u32, (s, s)), cached per (po2, backs)."""
    key = (po2, tuple(combo_backs))
    hit = _BASIS_CACHE.get(key)
    if hit is not None:
        return hit
    s = len(combo_backs)
    one = F.MONT_ONE
    nodes = [F.s_pow(back_one, b) for b in combo_backs]
    ft = [one] + [0] * s  # prod_i (x - nodes[i]), degree s
    for i in range(s):
        nxt = [0] * (s + 1)
        for j in range(s):
            nxt[j + 1] = F.s_add(nxt[j + 1], ft[j])
            nxt[j] = F.s_add(nxt[j], F.s_mul(ft[j], F.P - nodes[i]
                                             if nodes[i] else 0))
        ft = nxt
    out = np.zeros((s, s), np.uint32)
    for i in range(s):
        fr = [0] * s  # ft / (x - nodes[i]) by synthetic division (exact)
        cur = ft[s]
        for j in range(s - 1, -1, -1):
            fr[j] = cur
            cur = F.s_add(ft[j], F.s_mul(nodes[i], cur))
        denom = 0
        xp = one
        for j in range(s):
            denom = F.s_add(denom, F.s_mul(fr[j], xp))
            xp = F.s_mul(xp, nodes[i])
        dinv = F.s_inv(denom)
        out[i] = [F.s_mul(fr[j], dinv) for j in range(s)]
    _BASIS_CACHE[key] = out
    return out


def _base_pow_ext(base_mont: int, e: int) -> np.ndarray:
    """(base^e) as an ext element, base a Montgomery-form int."""
    out = np.zeros(4, np.uint32)
    out[0] = F.s_pow(base_mont, e)
    return out
