"""The train window's model FLOPs over its seconds at the card's peak for
its type, % (``readers.mfu``)."""

from portbench.readers import mfu


def read(layer):
    return mfu(layer)
