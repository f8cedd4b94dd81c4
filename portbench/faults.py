"""Faults planted under the timed path, and the control put in the
program's place: what the comparison has to catch.

Each fault is a context manager that patches the program for its
duration. ``readings.py`` reads them on the card at a cell's own size;
``tests/test_portbench_faults.py`` sees ``correct`` come out false under
each at a small size on the CPU.

  training   ``unchanged``: the optimizer step leaves the state as it was;
             ``half``: the loss takes half of the batch's rows, their mean
             scaled to the batch (the other half left out);
  data parallel training, besides: ``exchange``: no DDP, each rank steps on
             its own rows' gradient (the exchange between cards left out);
             ``local_moments``: BatchNorm takes each rank's own moments;
  evaluation ``half``: the decoder answers for half of the batch's rows
             and leaves the rest empty; ``token``: each transcript's first
             character is replaced where the decoder produces it.

The training control is the reference itself with every product's
operands rounded through float8 (``reference.ds2.fp8_quant``), one step
below the bf16 the configuration states. Evaluation has a control for each
stage: the forward on the program's own bfloat16 path
(``model.precision=16``), which ``probs_gap`` catches, and, for the decoder,
which has no such path, the beam search of the reference in bfloat16 put
in its place (``beam_control``), which the beam numbers catch.
"""

from __future__ import annotations

import contextlib
import math
from unittest import mock

import torch

TRAIN_FAULTS = ("unchanged", "half")
DDP_FAULTS = TRAIN_FAULTS + ("exchange", "local_moments")
EVAL_FAULTS = ("half", "token")


@contextlib.contextmanager
def train_fault(name: str):
    from dsjax_torch.train import loop

    if name == "unchanged":
        def update(self, state, n_accum):
            state.step += 1
            return state

        with mock.patch.object(loop.Trainer, "_update", update):
            yield
    elif name == "half":
        original = loop.ctc_loss

        def half(*args, **kwargs):
            nll = original(*args, **kwargs)
            keep = torch.zeros_like(nll)
            keep[: len(nll) // 2] = 2.0
            return nll * keep

        with mock.patch.object(loop, "ctc_loss", half):
            yield
    elif name == "exchange":
        def module(self, state):
            return state.model

        with mock.patch.object(loop.Trainer, "_module", module):
            yield
    elif name == "local_moments":
        from dsjax_torch.model import ds2

        def local(xf, axes, group=None):
            n = math.prod(xf.shape[a] for a in axes)
            mean = xf.mean(dim=axes)
            return mean, (xf * xf).mean(dim=axes) - mean * mean, n / max(n - 1, 1)

        with mock.patch.object(ds2, "global_moments", local):
            yield
    else:
        raise KeyError(name)


@contextlib.contextmanager
def beam_control(labels, width: int):
    """The decoder replaced by the reference beam search with its scores in
    bfloat16, on the program's posteriors."""
    import numpy as np

    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from portbench.reference import beam

    def decode(self, probs, sizes=None, n_best=None, with_scores=False):
        logp = torch.log(torch.clamp_min(probs.double(), 1e-30)).cpu().numpy()
        sizes = [logp.shape[1]] * len(logp) if sizes is None else [int(n) for n in sizes]
        strings = ["".join(labels[c] for c in beam.beam_search(lp[:n], width,
                                                               rounding=beam.round_bf16))
                   for lp, n in zip(logp, sizes)]
        return [[s] for s in strings], [[np.zeros(0, np.int32)] for _ in strings]

    with mock.patch.object(DeviceBeamDecoder, "decode", decode):
        yield


@contextlib.contextmanager
def eval_fault(name: str, labels):
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder

    original = DeviceBeamDecoder.decode

    def decode(self, *args, **kwargs):
        strings, offsets = original(self, *args, **kwargs)[:2]
        if name == "half":
            strings = [s if i < len(strings) // 2 else [""] * len(s)
                       for i, s in enumerate(strings)]
        elif name == "token":
            def alter(t):
                first = labels[1 + labels.index(t[0]) % (len(labels) - 2)] if t else labels[1]
                return first + t[1:]

            strings = [[alter(t) for t in s] for s in strings]
        else:
            raise KeyError(name)
        return strings, offsets

    with mock.patch.object(DeviceBeamDecoder, "decode", decode):
        yield
