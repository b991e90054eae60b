"""The least time one H100 could take for the hashing and NTT work of one
segment prove, from the configuration's shapes alone.

Each call is bound by the larger of its bytes (each input read and each
output written once) over the HBM rate and its 32-bit multiplies (3 a
Montgomery product, 1356 a Poseidon2 permutation) over 132 SMs x 64 lanes
x 1.98 GHz: the arithmetic of chip_smoke.py's `_bound` and `_ntt_bound`.

The work of one prove (risc0 zkp/src/prove): each committed group of
`width` columns at n = 2^po2 rows is interpolated, evaluated on the 4n
domain, hashed row by row and folded into a Merkle tree of 4n leaves; the
check polynomial (4 extension columns on 4n points) is interpolated into
16 columns of n coefficients, which are committed the same way; each FRI
round evaluates 4 columns of `size` coefficients on 4*size points, hashes
them as 64 columns of size/4 rows and folds that tree, until at most
`min_degree` coefficients remain, whose 4 * min_degree words are hashed
once.
"""

HBM_BYTES_S = 3.35e12
MUL32_S = 132 * 64 * 1.98e9
MUL32_PER_PRODUCT = 3
P2_PRODUCTS = 8 * 24 * 4 + 21 * (4 + 24)  # one permutation: 1356


def bound_ms(bytes_moved: float, products: float):
    """(ms, "bytes" | "operations"): the least time for this work."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = products * MUL32_PER_PRODUCT / MUL32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_bound(batch: int, n_bits: int, stages: int, scale: bool):
    n = 1 << n_bits
    products = batch * (n // 2) * stages + (batch * n if scale else 0)
    return bound_ms(2 * 4 * batch * n, products)


def hash_rows_bound(cols: int, rows: int):
    perms = rows * max(1, -(-cols // 16))
    return bound_ms(4 * (cols + 8) * rows, perms * P2_PRODUCTS)


def fold_bound(leaves: int):
    return bound_ms(32 * (2 * leaves - 1), (leaves - 1) * P2_PRODUCTS)


def prove_calls(po2: int, widths, check_size: int = 16, inv_rate: int = 4,
                fold: int = 16, min_degree: int = 256):
    """[(kind, shape, ms)] for one prove of 2^po2 rows; `widths` are the
    committed groups' column counts."""
    n = 1 << po2
    bits = po2 + 2  # log2 of the 4n domain
    calls = []

    def commit(cols):
        calls.append(("evaluate_ntt", (cols, n),
                      ntt_bound(cols, bits, po2, False)[0]))
        calls.append(("hash_rows", (cols, inv_rate * n),
                      hash_rows_bound(cols, inv_rate * n)[0]))
        calls.append(("fold", inv_rate * n, fold_bound(inv_rate * n)[0]))

    for cols in widths:
        calls.append(("interpolate_ntt", (cols, n),
                      ntt_bound(cols, po2, po2, True)[0]))
        commit(cols)
    # the check polynomial: 4 extension columns on the 4n domain
    calls.append(("interpolate_ntt", (4, inv_rate * n),
                  ntt_bound(4, bits, bits, True)[0]))
    commit(check_size)
    size = n
    while size > min_degree:
        calls.append(("evaluate_ntt", (4, size),
                      ntt_bound(4, (size * inv_rate).bit_length() - 1,
                                size.bit_length() - 1, False)[0]))
        rows = size * inv_rate // fold
        calls.append(("hash_rows", (4 * fold, rows),
                      hash_rows_bound(4 * fold, rows)[0]))
        calls.append(("fold", rows, fold_bound(rows)[0]))
        size //= fold
    calls.append(("hash_rows", (4 * size, 1), hash_rows_bound(4 * size, 1)[0]))
    return calls


def prove_bound_s(po2: int, widths, **kw) -> float:
    """The least seconds of kernel work in one prove."""
    return sum(ms for _k, _s, ms in prove_calls(po2, widths, **kw)) / 1e3
