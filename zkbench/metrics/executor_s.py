"""The executor (zkvm/exec.py): a timer around `ExecutorImpl.run`, seconds
an item."""

from zkbench.readings import mean_call_s


def read(readings):
    return mean_call_s(readings, "executor")
