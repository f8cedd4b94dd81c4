"""Host ms a batch in the WER/CER update (the ``eval.score`` span,
``train.metrics.update_batch``) over the profiled span."""

from portbench.spans import ms_per


def read(layer):
    return ms_per(layer, ("eval.score",), "batches")
