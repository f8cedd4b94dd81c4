"""Rank 0's model FLOPs over the data-parallel window's seconds at the
card's peak for its type, %: one card's share (``readers.mfu``)."""

from portbench.readers import mfu


def read(layer):
    return mfu(layer)
