"""Recursion preflight (circuit/recursion/preflight.py, host Python): the
`rec_preflight` perf scope inside each `lift`, seconds an item."""

from zkbench.readings import mean, call_scope_s


def read(readings):
    return mean(call_scope_s(it, "lift", "rec_preflight")
                 for it in readings["items"])
