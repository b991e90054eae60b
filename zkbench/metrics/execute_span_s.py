"""The executor (zkvm/exec.py): the program's `execute` span, seconds an
item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds("execute"))
