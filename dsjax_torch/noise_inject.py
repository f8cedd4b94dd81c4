"""Audition tool: mix one noise file into one wav at a given level and save
the result (reference parity: noise_inject.py:1-25; the counterpart of
dsjax's root noise_inject.py, with the same flags).

    python -m dsjax_torch.noise_inject --input-path clean.wav --noise-path noise.wav \
        --output-path mixed.wav [--sample-rate 16000] [--noise-level 1.0]

A noise file shorter than the input is tiled past its length; the mix
starts at a random (unseeded) offset of the noise unless the noise is
exactly as long as the input, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from dsjax_torch.audio.augment import NoiseInjector
from dsjax_torch.audio.io import load_audio, save_wav


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-path", default="input.wav", help="clean speech wav to corrupt")
    parser.add_argument("--noise-path", default="noise.wav",
                        help="background noise recording")
    parser.add_argument("--output-path", default="output.wav",
                        help="where the mixed wav is written")
    parser.add_argument("--sample-rate", default=16000, type=int,
                        help="output sample rate (Hz)")
    parser.add_argument("--noise-level", type=float, default=1.0,
                        help="noise mix level in [0,1]; larger = noisier output")
    args = parser.parse_args(argv)
    data = load_audio(args.input_path, args.sample_rate)
    injector = NoiseInjector(os.path.dirname(os.path.abspath(args.noise_path)) or ".",
                             args.sample_rate)
    mixed = injector.inject_sample(data, args.noise_path, args.noise_level)
    save_wav(args.output_path, np.asarray(mixed), args.sample_rate)
    print(f"Saved noise-injected audio to {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
