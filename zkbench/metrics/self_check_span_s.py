"""The prover server's self-check of the receipt (zkvm/prover.py): the
program's `self_check` span, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds("self_check"))
