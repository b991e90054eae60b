"""The prover server's own glue (zkvm/prover.py): the root `prove`
span's self time, its duration less what its child spans cover, seconds
an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.self_s())
