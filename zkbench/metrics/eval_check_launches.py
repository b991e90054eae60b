"""Constraint evaluation (circuit/ir_range.py): kernels launched inside
the traced prove's `eval_check` span, counted from the device trace (the
scope before it and eval_check both end in a sync, so none strays in or
out)."""

from zkbench.spans import launches_in, traced_span


def read(readings):
    hit = traced_span(readings, "eval_check")
    return None if hit is None else launches_in(readings["trace"], hit)
