"""Recursion proving (zkvm/recursion_driver.py): each `lift` span less
its `rec_preflight` scope, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds(
        "lift", minus="rec_preflight"))
