"""The keccak prover on the card (circuit/keccak/prove.py): each
`prove_keccak` span less its `keccak_preflight` and `keccak_witgen`
scopes, seconds an item."""

from zkbench.spans import mean_item_s

WITGEN = ("keccak_preflight", "keccak_witgen")


def prove_s(it):
    total = it.seconds("prove_keccak")
    if total is None:
        return None
    return total - sum(it.seconds(n, inside="prove_keccak") or 0.0
                       for n in WITGEN)


def read(readings):
    return mean_item_s(readings, prove_s)
