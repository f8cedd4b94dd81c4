"""Transcription CLI: ``python -m dsjax_torch.transcribe key=value ...`` (the
counterpart of dsjax's root ``transcribe.py``), for example

    python -m dsjax_torch.transcribe model.model_path=model.pt audio_path=a.wav \
        lm.decoder_type=beam offsets=true

prints the result JSON (``output``: transcriptions, with ``offsets`` when
asked; ``lm.top_paths`` hypotheses per file). ``device`` defaults to cuda and
raises without a card; pass ``device=cpu`` to transcribe on the CPU.
"""

import sys

from dsjax_torch.config import TranscribeConfig, compose_cli
from dsjax_torch.workflows import transcribe

if __name__ == "__main__":
    transcribe(compose_cli(TranscribeConfig, __doc__, sys.argv[1:]))
