"""Host ms a training step that rank 0 waits in the ranks' host
collectives, over the profiled span: ``ddp.agree`` (the shapes agreed in
``Trainer.put_batch`` and the micro-batch count in ``train_step``, twice a
step) and ``ddp.reduce`` (the loss's all-reduce, once a step). None unless
they ran exactly that often."""

from portbench.spans import recorded, units


def read(layer):
    n, summary = units(layer, "steps"), recorded()
    if n is None or not summary:
        return None
    agree, reduce = summary.get("ddp.agree", {}), summary.get("ddp.reduce", {})
    if agree.get("calls") != 2 * n or reduce.get("calls") != n:
        return None
    return 1e3 * (agree["total_s"] + reduce["total_s"]) / n
