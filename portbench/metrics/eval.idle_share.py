"""The share of the profiled eval span with no kernel or copy on the card, %."""

from portbench.readers import idle_share


def read(layer):
    return idle_share(layer)
