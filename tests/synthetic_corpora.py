"""Synthetic corpus archives in the layouts the dataset preparers read.

Used by the port's CPU tests and by chip_smoke.py; it imports only numpy,
the standard library and the port's WAV writer. Audio is tones plus noise
and transcripts are words of letters and apostrophes drawn from the label
set, all from a seed; an utterance of s seconds gets at most 2 s words of
at most 6 characters, so its CTC target fits its s * 50 output frames.
"""

import os
import tarfile
import tempfile
from typing import Dict, Sequence

import numpy as np

from dsjax_torch.audio.io import save_wav
from dsjax_torch.labels import DEFAULT_LABELS

# every label but the blank and the space: the letters and the apostrophe
CHARACTERS = [c for c in DEFAULT_LABELS if c not in ("_", " ")]


def tone(rng: np.random.Generator, seconds: float, sample_rate: int = 16000,
         channels: int = 1) -> np.ndarray:
    """Two tones plus noise in [-1, 1]: float32 [n] or, with channels > 1,
    [n, channels]."""
    n = int(round(seconds * sample_rate))
    t = np.arange(n) / sample_rate
    out = []
    for _ in range(channels):
        f0, f1 = rng.uniform(120, 400), rng.uniform(600, 2400)
        out.append(0.1 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(2 * np.pi * f1 * t)
                   + 0.01 * rng.standard_normal(n))
    y = np.stack(out, axis=1).astype(np.float32)
    return y[:, 0] if channels == 1 else y


def transcript(rng: np.random.Generator, seconds: float) -> str:
    """1 to 2 * seconds words of 2 to 6 characters of the label set."""
    n_words = int(rng.integers(1, max(2, int(2 * seconds)) + 1))
    return " ".join("".join(rng.choice(CHARACTERS, size=int(rng.integers(2, 7))))
                    for _ in range(n_words))


def write_sphere(path: str, data: bytes, sample_rate: int = 16000, channels: int = 1,
                 n_bytes: int = 2, coding: str = "pcm", byte_format: str = "01") -> None:
    """A NIST SPHERE file: a 1024-byte header with these fields, then data."""
    header = (f"NIST_1A\n   1024\nsample_rate -i {sample_rate}\nchannel_count -i {channels}\n"
              f"sample_n_bytes -i {n_bytes}\nsample_byte_format -s{len(byte_format)} "
              f"{byte_format}\nsample_coding -s{len(coding)} {coding}\nend_head\n")
    with open(path, "wb") as f:
        f.write(header.encode().ljust(1024, b" ") + data)


def pcm16(y: np.ndarray, big_endian: bool = False) -> bytes:
    """float [-1, 1] samples (interleaved when [n, channels]) -> 16-bit PCM bytes."""
    pcm = np.clip(np.round(np.asarray(y) * 32768.0), -32768, 32767)
    return pcm.astype(">i2" if big_endian else "<i2").tobytes()


def tar_directory(src: str, archive: str) -> str:
    """Pack every entry of src, by its path under src, into a gzip tar."""
    with tarfile.open(archive, "w:gz") as t:
        for name in sorted(os.listdir(src)):
            t.add(os.path.join(src, name), arcname=name)
    return archive


def write_an4_archive(archive: str, seed: int, n_train: int = 24, n_val: int = 8,
                      n_test: int = 8, seconds: Sequence[float] = (1.0, 4.0),
                      short_seconds: float = 0.5) -> Dict[str, list]:
    """An an4.tar.gz in AN4's layout, {train,val,test}/{wav,txt}: n_* utterances
    a split of uniform(*seconds) seconds, and one of short_seconds in train
    and in test (``an4_<split>_short``). Returns {split: [(name, seconds)]}."""
    rng = np.random.default_rng(seed)
    written: Dict[str, list] = {}
    with tempfile.TemporaryDirectory() as stage:
        for split, n, short in (("train", n_train, True), ("val", n_val, False),
                                ("test", n_test, True)):
            os.makedirs(os.path.join(stage, split, "wav"))
            os.makedirs(os.path.join(stage, split, "txt"))
            items = [(f"an4_{split}_{i}", float(rng.uniform(*seconds))) for i in range(n)]
            if short:
                items.append((f"an4_{split}_short", short_seconds))
            for name, s in items:
                save_wav(os.path.join(stage, split, "wav", name + ".wav"), tone(rng, s), 16000)
                with open(os.path.join(stage, split, "txt", name + ".txt"), "w") as f:
                    f.write(transcript(rng, s))
            written[split] = items
        tar_directory(stage, archive)
    return written
