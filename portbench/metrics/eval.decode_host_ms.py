"""Host ms a batch building the beam's strings and offsets (the
``beam.strings`` span) over the profiled span; the card has nothing queued
meanwhile."""

from portbench.spans import ms_per


def read(layer):
    return ms_per(layer, ("beam.strings",), "batches")
