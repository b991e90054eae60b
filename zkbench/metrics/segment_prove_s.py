"""The segment prover (circuit/rv32im/prove.py through
`ProverImpl.prove_segment`): a timer around it, seconds an item."""

from zkbench.readings import mean_call_s


def read(readings):
    return mean_call_s(readings, "prove_segment")
