"""The host verifier (verify/verifier.py) in the self-check: its FRI
rounds and the queries' Merkle openings, the `verify_fri` spans inside
`self_check`, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds(
        "verify_fri", inside="self_check"))
