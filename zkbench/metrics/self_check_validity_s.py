"""The host verifier (verify/verifier.py) in the self-check: its
constraint check at the DEEP point, the `verify_validity` spans inside
`self_check`, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds(
        "verify_validity", inside="self_check"))
