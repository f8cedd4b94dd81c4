"""A synthetic speech manifest for training runs: tones plus noise, with
transcripts drawn from a small vocabulary, in the reference's manifest
format ({"root_path", "samples": [{"wav_path", "transcript_path"}]}).

Used by the port's CPU tests and by chip_smoke.py; it imports only numpy
and the port's WAV writer. Transcripts run at ``words_per_second`` words
of at most 7 characters, so an utterance of s seconds (100 s frames, s * 50
frames after the conv stack) has a CTC-feasible target for the default 2
words per second (at most 16 s characters).
"""

import json
import os
from typing import Sequence

import numpy as np

from dsjax_torch.audio.io import save_wav

WORDS = ("HELLO", "WORLD", "GOOD", "MORNING", "DEEP", "SPEECH", "OPEN", "SOURCE",
         "MODEL", "TEST", "AUDIO", "FINAL", "SAMPLE", "CARD", "KERNEL", "TRAIN")


def write_manifest(root: str, name: str, seconds: Sequence[float], seed: int,
                   words_per_second: float = 2.0, sample_rate: int = 16000) -> str:
    """Write len(seconds) utterances under root/{wav,txt}/NAME_i.* and the
    manifest root/NAME.json, in the order given; returns the manifest path."""
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    os.makedirs(os.path.join(root, "txt"), exist_ok=True)
    rng = np.random.default_rng(seed)
    samples = []
    for i, s in enumerate(seconds):
        n = int(round(s * sample_rate))
        t = np.arange(n) / sample_rate
        f0, f1 = rng.uniform(120, 400), rng.uniform(600, 2400)
        y = (0.1 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(2 * np.pi * f1 * t)
             + 0.01 * rng.standard_normal(n)).astype(np.float32)
        text = " ".join(rng.choice(WORDS, size=max(1, int(s * words_per_second))))
        wav, txt = f"wav/{name}_{i}.wav", f"txt/{name}_{i}.txt"
        save_wav(os.path.join(root, wav), y, sample_rate)
        with open(os.path.join(root, txt), "w") as f:
            f.write(text)
        samples.append({"wav_path": wav, "transcript_path": txt})
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump({"root_path": os.path.abspath(root), "samples": samples}, f)
    return path
