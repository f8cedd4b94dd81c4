"""K4r's share of its roofline over the profiled span (``readers.roofline``)."""

from portbench.readers import roofline


def read(layer):
    return roofline(layer, "K4r")
