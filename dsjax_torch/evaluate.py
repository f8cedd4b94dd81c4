"""Evaluation CLI: ``python -m dsjax_torch.evaluate key=value ...`` (the
counterpart of dsjax's root ``test.py``), for example

    python -m dsjax_torch.evaluate model.model_path=model.pt test_path=test.json \
        lm.decoder_type=beam lm.beam_width=10

prints each reference and hypothesis (``verbose=false`` silences them) and a
"Test Summary" line with WER, CER and utterances per second. ``device``
defaults to cuda and raises without a card; pass ``device=cpu`` to evaluate
on the CPU.
"""

import sys

from dsjax_torch.config import EvalConfig, compose_cli
from dsjax_torch.workflows import evaluate

if __name__ == "__main__":
    evaluate(compose_cli(EvalConfig, __doc__, sys.argv[1:]))
