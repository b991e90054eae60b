"""The segment prover (ProverImpl.prove_segment): the program's
`prove_segment` spans, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds("prove_segment"))
