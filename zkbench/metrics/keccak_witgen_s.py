"""Keccak witness generation, on the host (circuit/keccak/witgen.py): the
`keccak_preflight` and `keccak_witgen` scopes inside each `prove_keccak`
span, seconds an item."""

from zkbench.spans import mean_item_s

SCOPES = ("keccak_preflight", "keccak_witgen")


def witgen_s(it):
    hit = [it.seconds(n, inside="prove_keccak") for n in SCOPES]
    hit = [s for s in hit if s is not None]
    return sum(hit) if hit else None


def read(readings):
    return mean_item_s(readings, witgen_s)
