"""K2's share of its roofline on rank 0's card over the profiled
data-parallel span (``readers.roofline``)."""

from portbench.readers import roofline


def read(layer):
    return roofline(layer, "K2")
