"""Accum witness generation on the card (circuit/rv32im/accum_device.py):
the `witgen_accum` perf scope, seconds an item."""

from zkbench.readings import mean_scope_s


def read(readings):
    return mean_scope_s(readings, ["witgen_accum"])
