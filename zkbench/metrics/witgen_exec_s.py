"""Exec witness generation (host C++, circuit/rv32im/witgen.py): the
`witgen_exec` perf scope, seconds an item."""

from zkbench.readings import mean_scope_s


def read(readings):
    return mean_scope_s(readings, ["witgen_exec"])
