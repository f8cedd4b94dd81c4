"""Host ms a batch blocked in the beam decoder's fetch (the ``beam.fetch``
span: ``rev_d.cpu()`` waits until the card has run the next batch's
forward, queued first, and the search) over the profiled span."""

from portbench.spans import ms_per


def read(layer):
    return ms_per(layer, ("beam.fetch",), "batches")
