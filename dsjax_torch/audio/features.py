"""Spectrogram features on the host: STFT -> magnitude -> log1p -> normalize.

Copy of the host path of dsjax/audio/features.py (``spectrogram_np`` and
``FeatureExtractor``), which is what the server runs per request. The
batched device STFT (dsjax's ``spectrogram_jax``) comes with the eval slice.

  * n_fft = win_length = int(sample_rate * window_size)   (320 @ 16k/20ms)
  * hop   = int(sample_rate * window_stride)              (160 @ 16k/10ms)
  * center=True (reflect pad n_fft//2 each side), periodic window;
  * magnitude -> log1p;
  * optional per-utterance normalization by mean and unbiased std (ddof=1).
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple, Union

import numpy as np
from scipy.signal import get_window

from dsjax_torch.config import SpectConfig, SpectrogramWindow


def stft_params(cfg: SpectConfig) -> Tuple[int, int, int]:
    """(n_fft, hop_length, n_freq_bins) for a spect config."""
    n_fft = int(cfg.sample_rate * cfg.window_size)
    hop = int(cfg.sample_rate * cfg.window_stride)
    return n_fft, hop, n_fft // 2 + 1


def periodic_window(name: Union[str, SpectrogramWindow], n: int) -> np.ndarray:
    if isinstance(name, SpectrogramWindow):
        name = name.value
    return get_window(name, n, fftbins=True).astype(np.float32)


def num_frames(n_samples: int, hop: int) -> int:
    """Frame count for center=True STFT: 1 + n//hop."""
    return 1 + n_samples // hop


def spectrogram_np(y: np.ndarray, cfg: SpectConfig, normalize: bool = True) -> np.ndarray:
    """Single-utterance log-magnitude spectrogram, shape (F, T) float32."""
    n_fft, hop, _ = stft_params(cfg)
    window = periodic_window(cfg.window, n_fft)
    pad = n_fft // 2
    yp = np.pad(y.astype(np.float32), pad, mode="reflect")
    n_t = num_frames(len(y), hop)
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop][:n_t]
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)).T.astype(np.float32)  # (F, T)
    spec = np.log1p(spec)
    if normalize:
        mean = spec.mean()
        std = spec.std(ddof=1)
        spec = (spec - mean) / max(std, 1e-10)
    return spec.astype(np.float32)


class FeatureExtractor:
    """One utterance -> (F, T) features, plus fixed-length chunking."""

    def __init__(self, cfg: SpectConfig, normalize: bool = True):
        self.cfg = cfg
        self.normalize = normalize

    def __call__(self, y: np.ndarray) -> np.ndarray:
        return spectrogram_np(y, self.cfg, self.normalize)

    def chunks(self, y: np.ndarray, chunk_size_seconds: float = -1.0) -> Iterator[np.ndarray]:
        """Yield per-chunk signals; chunk_size_seconds <= 0 yields one chunk."""
        sr = self.cfg.sample_rate
        total_s = math.ceil(len(y) / sr)
        chunk_s = total_s if chunk_size_seconds <= 0 else chunk_size_seconds
        n_chunks = max(1, math.ceil(total_s / chunk_s)) if total_s else 1
        for i in range(n_chunks):
            start = int(i * chunk_s * sr)
            end = start + int(chunk_s * sr)
            yield y[start:end]
