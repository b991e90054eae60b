"""Constraint evaluation over the 4x domain (circuit/ir_range.py): the
`eval_check` perf scope, seconds an item."""

from zkbench.readings import mean_scope_s


def read(readings):
    return mean_scope_s(readings, ["eval_check"])
