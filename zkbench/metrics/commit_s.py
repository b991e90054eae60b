"""Commits (hal/torch_hal.py): the `commit_group.N` and `check_commit`
perf scopes summed, seconds an item."""

from zkbench.readings import mean, commit_scopes, scope_s


def read(readings):
    return mean(scope_s(it, commit_scopes(it)) for it in readings["items"])
