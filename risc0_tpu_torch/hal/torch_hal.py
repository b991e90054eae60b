"""Device op layer ("HAL") on torch (counterpart of ``risc0_tpu/hal/jnp_hal.py``).

Shapes follow the reference: base-element polynomial batches are int32
(count, n) tensors of Montgomery words, extension elements have a
trailing axis of 4.  Every op runs on the device of its input tensors.
The NTTs and the Poseidon2 hashes go through the kernel wrappers in
``hal/cuda/``; everything else is plain torch.  The Merkle trees of the
other hash suites are hashed on the host (``hash/suite.py``).

Sums of many field words are taken in int64 and reduced once (the
reference splits them into 16-bit halves only because the TPU has no
u64).  Products that feed such a sum keep their R^2 factor and drop one
R^-1 after the reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import field as F
from .. import perf
from ..convert import card, to_numpy, to_torch
from ..core import ntt
from ..hash.suite import POSEIDON2
from .cuda import ntt as kntt
from .cuda import poseidon2 as kp2

INV_RATE = 4
FRI_FOLD = 16

# Groups whose evaluated (LDE) matrix exceeds this many bytes commit in
# column chunks: on an 80 GB card memory is not the limit at po2 20, but
# chunking bounds the int64 temporaries of the plain ops (encode,
# zk-shift) and streams a host witness to the device chunk by chunk.  At
# po2 20 the data group (3.5 GB) takes the chunked path and the accum
# group (1.7 GB) the fused one.
COMMIT_CHUNK_BYTES = 2 << 30
COMMIT_CHUNK_COLS = 32


def as_words(x, device) -> torch.Tensor:
    """numpy u32 or an int32 tensor -> int32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return to_torch(x, device)


# ---------------------------------------------------------------------------
# Polynomial ops
# ---------------------------------------------------------------------------

def make_coeffs(witness, zk_shift: bool = True):
    """iNTT each row and apply the zk shift f(x) -> f(3x); bit-reversed
    coefficients out (reference prove/prover.rs:38-48)."""
    coeffs = kntt.interpolate_ntt(witness)
    return ntt.zk_shift(coeffs) if zk_shift else coeffs


def expand_evaluate(coeffs, expand_bits: int = 2):
    """Bit-reversed coeffs (count, n) -> evaluations over the 2^eb larger
    domain."""
    return kntt.evaluate_ntt(ntt.expand(coeffs, expand_bits), expand_bits)


def _evaluate_rows(rows, xs_distinct, back_idx, chunk: int):
    """out[t] = sum_i rows[t, i] * xs_distinct[back_idx[t]]^i, chunked over
    i: each chunk builds x^(i0..i0+T) from a doubled base table times the
    running x^i0."""
    n = rows.shape[-1]
    T = min(chunk, n)
    base = F.ext_powers(xs_distinct, T)                     # (nb, T, 4)
    x_t = F.ext_mul(base[:, -1], xs_distinct)               # (nb, 4)
    bidx = torch.as_tensor(np.asarray(back_idx, np.int64),
                           device=rows.device)
    cur = torch.zeros_like(xs_distinct)
    cur[:, 0] = F.MONT_ONE
    acc = torch.zeros((rows.shape[0], 4), dtype=torch.int64,
                      device=rows.device)
    for i0 in range(0, n, T):
        xp = F.ext_mul(cur[:, None, :], base).index_select(0, bidx)
        prod = xp.to(torch.int64) * rows[:, i0 : i0 + T, None] % F.P
        acc += prod.sum(dim=1)
        cur = F.ext_mul(cur, x_t)
    return (acc % F.P * F.R_INV % F.P).to(torch.int32)


def batch_evaluate_any(coeffs_nat, which, xs, chunk: int = 4096):
    """out[k] = P_{which[k]}(xs[k]); coeffs_nat (count, n) natural-order,
    which host ints (k,), xs (k, 4) ext points.  Returns (k, 4)."""
    dev = coeffs_nat.device
    sel = coeffs_nat.index_select(
        0, torch.as_tensor(np.asarray(which, np.int64), device=dev))
    xs = as_words(xs, dev)
    return _evaluate_rows(sel, xs, np.arange(len(which)), chunk)


def evaluate_tap_groups(coeffs_groups, group_ids, cols, backs, xs_distinct,
                        back_idx, chunk: int = 4096):
    """All tap evaluations: out[t] = P_{group_ids[t], cols[t]}(
    xs_distinct[back_idx[t]]).  coeffs_groups: list of (count_g, n)
    natural-order coefficient tensors; the taps are in group order."""
    group_ids = np.asarray(group_ids, np.int64)
    if np.any(np.diff(group_ids) < 0):
        raise ValueError("taps must be sorted by group")
    dev = coeffs_groups[0].device
    parts = []
    for g in np.unique(group_ids):
        idx = torch.as_tensor(np.asarray(cols, np.int64)[group_ids == g],
                              device=dev)
        parts.append(coeffs_groups[int(g)].index_select(0, idx))
    rows = torch.cat(parts, dim=0)
    return _evaluate_rows(rows, as_words(xs_distinct, dev), back_idx, chunk)


def mix_poly_coeffs(combos, mix_pows, input_coeffs, which, combo_count: int,
                    block: int = 8):
    """combos[c] += sum_{i: which[i]==c} mix_pows[i] * input[i], in place.

    combos: (combo_count+1, n, 4); mix_pows: (count, 4); input: (count, n);
    which: (count,) host ints.  Matches reference hal/cpu.rs:410-456."""
    which = np.asarray(which)
    mix_pows = as_words(mix_pows, combos.device)
    for c in range(combo_count + 1):
        members = np.nonzero(which == c)[0]
        if len(members) == 0:
            continue
        acc = torch.zeros(combos.shape[1:], dtype=torch.int64,
                          device=combos.device)
        for b0 in range(0, len(members), block):
            m = torch.as_tensor(members[b0 : b0 + block], device=combos.device)
            prod = (mix_pows.index_select(0, m)[:, None, :].to(torch.int64)
                    * input_coeffs.index_select(0, m)[:, :, None] % F.P)
            acc += prod.sum(dim=0)
        upd = (acc % F.P * F.R_INV % F.P).to(torch.int32)
        combos[c] = F.add(combos[c], upd)
    return combos


def combos_subtract_head(combos, corr):
    """combos[:, :w] -= corr for a small host-computed block, in place."""
    corr = as_words(corr, combos.device)
    w = corr.shape[1]
    combos[:, :w] = F.sub(combos[:, :w], corr)
    return combos


def _poly_divide_rows(p, zs):
    """Row-batched synthetic division of p (m, n, 4) by (x - zs[i]):
    s_i = sum_{j>=i} p_j z^j, quotient_i = s_{i+1} z^-(i+1), remainder s_0."""
    m, n, _ = p.shape
    pz = F.ext_mul(p, F.ext_powers(zs, n))
    s = (pz.to(torch.int64).flip(1).cumsum(dim=1) % F.P).flip(1) \
        .to(torch.int32)
    remainder = s[:, 0]
    s_next = torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], dim=1)
    zinv = F.ext_inv(zs)
    zinv_pows = F.ext_mul(F.ext_powers(zinv, n), zinv[:, None, :])
    return F.ext_mul(s_next, zinv_pows), remainder


def combos_divide(combos, zs_levels, active_levels, z_check):
    """Divide every combo row by its sequence of (x - z_cb) factors and the
    check row by (x - z^4).  combos (m, n, 4); zs_levels (L, m, 4);
    active_levels (L, m) bool (host arrays).  Returns (combos', rems), rems
    holding every remainder (zero where inactive) for one host check."""
    dev = combos.device
    zs_levels = np.asarray(zs_levels, np.uint32)
    active_levels = np.asarray(active_levels, bool)
    m = combos.shape[0]
    rems = []
    for lvl in range(zs_levels.shape[0]):
        act = np.nonzero(active_levels[lvl])[0]
        rem = torch.zeros((m, 4), dtype=torch.int32, device=dev)
        if len(act):
            idx = torch.as_tensor(act, device=dev)
            q, r = _poly_divide_rows(combos.index_select(0, idx),
                                     as_words(zs_levels[lvl][act], dev))
            combos[idx] = q
            rem[idx] = r
        rems.append(rem)
    qc, remc = _poly_divide_rows(combos[-1:],
                                 as_words(np.asarray(z_check)[None], dev))
    combos[-1] = qc[0]
    return combos, torch.cat(rems + [remc], dim=0)


def eltwise_sum_extelem(combos):
    """Sum (m, n, 4) ext polys -> (4, n) base-planar buffer."""
    return F.sum_mod(combos, 0).T.contiguous()


def fri_fold(planar_coeffs, mix):
    """One FRI fold-by-16 (reference hal/cpu.rs:524-553): (4, k)
    bit-reversed planar ext poly and a (4,) ext mix -> (4, k/16)."""
    k = planar_coeffs.shape[1]
    out = k // FRI_FOLD
    mix_pows = F.ext_powers(as_words(mix, planar_coeffs.device), FRI_FOLD)
    tot = torch.zeros((out, 4), dtype=torch.int64,
                      device=planar_coeffs.device)
    for i in range(FRI_FOLD):
        r = int(f"{i:04b}"[::-1], 2)
        factor = planar_coeffs[:, r * out : (r + 1) * out].T   # (out, 4)
        tot += F.ext_mul(mix_pows[i][None, :], factor)
    return (tot % F.P).to(torch.int32).T.contiguous()


# ---------------------------------------------------------------------------
# Merkle hashing and the commit pipelines
# ---------------------------------------------------------------------------

def merkle_layers(matrix, suite=POSEIDON2):
    """All Merkle layers of a (cols, rows) matrix, rows a power of two:
    layers[0] = leaf digests (rows, 8), layers[-1] = (1, 8) root
    (reference prove/merkle.rs:54-80), on the matrix's device.  A suite
    `on_card` hashes with the card's kernels; the others read the matrix
    back once, hash it on the host and upload the layers in one copy."""
    if suite.on_card:
        leaves = kp2.hash_rows(matrix)
        return [leaves] + kp2.merkle_fold(leaves)
    with perf.scope(f"{suite.name}_readback"):
        host = to_numpy(matrix)
    with perf.scope(f"{suite.name}_leaves"):
        layers = [suite.hash_rows(host)]
    with perf.scope(f"{suite.name}_folds"):
        while layers[-1].shape[0] > 1:
            cur = layers[-1]
            layers.append(suite.hash_pairs(cur[0::2], cur[1::2]))
    with perf.scope(f"{suite.name}_upload"):
        flat = to_torch(np.concatenate(layers), matrix.device)
    return list(torch.split(flat, [len(l) for l in layers]))


def commit_pipeline(witness, encode: bool = False, device="cuda",
                    suite=POSEIDON2):
    """iNTT -> zk-shift -> 4x LDE -> Merkle for one (cols, rows) group.
    `witness` is numpy u32 or an int32 tensor; encode=True takes a
    standard-form witness and Montgomery-encodes it on the device.
    Returns (coeffs_nat, evaluated, layers)."""
    device = card(device)
    cols, rows = witness.shape
    if cols * rows * INV_RATE * 4 > COMMIT_CHUNK_BYTES:
        return commit_pipeline_chunked(witness, encode=encode, device=device,
                                       suite=suite)
    w = as_words(witness, device)
    if encode:
        w = F.encode(w)
    coeffs = make_coeffs(w)
    evaluated = expand_evaluate(coeffs, 2)
    return (ntt.bit_reverse(coeffs), evaluated,
            merkle_layers(evaluated, suite))


def commit_pipeline_chunked(witness, encode: bool = False, device="cuda",
                            chunk_cols: int = COMMIT_CHUNK_COLS,
                            suite=POSEIDON2):
    """commit_pipeline over column chunks: per-column NTTs are exact under
    chunking, so the result equals the fused path."""
    device = card(device)
    cols, rows = witness.shape
    coeffs_nat = torch.empty((cols, rows), dtype=torch.int32, device=device)
    evaluated = torch.empty((cols, rows * INV_RATE), dtype=torch.int32,
                            device=device)
    for c0 in range(0, cols, chunk_cols):
        c1 = min(c0 + chunk_cols, cols)
        chunk = as_words(witness[c0:c1], device)
        if encode:
            chunk = F.encode(chunk)
        coeffs = make_coeffs(chunk.contiguous())
        evaluated[c0:c1] = expand_evaluate(coeffs, 2)
        coeffs_nat[c0:c1] = ntt.bit_reverse(coeffs)
    return coeffs_nat, evaluated, merkle_layers(evaluated, suite)


def check_pipeline(check_poly, check_size: int = 16,
                   suite=POSEIDON2):
    """Check-group commit: iNTT the (4, domain) check polynomial, read the
    bit-reversed coefficients as `check_size` base polys with no data
    movement (reference prover.rs:159-178), then LDE + Merkle."""
    cycles = check_poly.shape[-1] * check_poly.shape[0] // check_size
    coeffs_br = kntt.interpolate_ntt(check_poly.contiguous()) \
        .reshape(check_size, cycles)
    evaluated = expand_evaluate(coeffs_br, 2)
    return (ntt.bit_reverse(coeffs_br), evaluated,
            merkle_layers(evaluated, suite))
