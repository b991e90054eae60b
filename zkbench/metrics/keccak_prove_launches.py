"""The keccak prover on the card (circuit/keccak/prove.py): kernels
launched inside the traced item's `prove_keccak` spans, counted from the
device trace."""

from zkbench.spans import items, launches_in


def read(readings):
    got = items(readings)
    if got is None or readings.get("trace") is None:
        return None
    hit = got[1].under(got[1].root, "prove_keccak")
    if not hit:
        return None
    return sum(launches_in(readings["trace"], s) for s in hit)
