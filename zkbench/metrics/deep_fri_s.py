"""DEEP and FRI (prove/prover.py, prove/fri.py): the `tap_eval`, `combos`
and `fri_prove` perf scopes summed, seconds an item."""

from zkbench.readings import mean_scope_s


def read(readings):
    return mean_scope_s(readings, ["tap_eval", "combos", "fri_prove"])
