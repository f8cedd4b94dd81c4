"""Host ms a batch the evaluation loop waited for a staged batch (the
``data.wait`` span around ``DevicePrefetcher``'s queue) over the profiled
span; the loop's last wait takes the end-of-stream marker, so the span runs
at least once a batch."""

from portbench.spans import ms_per


def read(layer):
    return ms_per(layer, ("data.wait",), "batches", at_least=True)
