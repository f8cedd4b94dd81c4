"""The share of the profiled data-parallel span with no kernel or copy on
the cards, %: the ranks' mean busy seconds over rank 0's span."""

from portbench.readers import idle_share


def read(layer):
    return idle_share(layer)
