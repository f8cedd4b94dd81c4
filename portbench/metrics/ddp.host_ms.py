"""Host ms a data-parallel step on rank 0 in ``Trainer.put_batch`` and
``Trainer.train_step`` (the ``train.put_batch`` and ``train.step`` spans)
over the profiled span: the host's time to stage and issue a step, the
ranks' host collectives inside it, against the card's time for it."""

from portbench.spans import ms_per


def read(layer):
    return ms_per(layer, ("train.put_batch", "train.step"), "steps")
