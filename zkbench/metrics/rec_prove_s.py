"""Recursion proving (zkvm/recursion_driver.py, circuit/recursion/prove.py):
the wall time of each `lift` less its `rec_preflight` scope, seconds an
item."""

from zkbench.readings import mean_call_s


def read(readings):
    return mean_call_s(readings, "lift", minus_scope="rec_preflight")
