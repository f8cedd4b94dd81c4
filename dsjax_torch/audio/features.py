"""Spectrogram features: STFT -> magnitude -> log1p -> normalize.

The counterpart of dsjax/audio/features.py, in two halves:
  * the host path, a copy: ``spectrogram_np`` and ``FeatureExtractor``
    (one utterance at a time; the server runs it per request);
  * the device path: ``pad_audio_for_device`` prepares raw audio on the
    host, and ``spectrogram_torch`` (dsjax's ``spectrogram_jax``) computes a
    padded batch's features on the tensors' device, with framing by
    reshape (n_fft == 2 * hop), one batched ``torch.fft.rfft`` and a masked
    per-utterance normalization. dsjax runs this outside any Pallas kernel,
    so it stays plain PyTorch.

Semantics (reference deepspeech_pytorch/loader/data_loader.py:73-94):

  * n_fft = win_length = int(sample_rate * window_size)   (320 @ 16k/20ms)
  * hop   = int(sample_rate * window_stride)              (160 @ 16k/10ms)
  * center=True (reflect pad n_fft//2 each side), periodic window;
  * magnitude -> log1p;
  * optional per-utterance normalization by mean and unbiased std (ddof=1).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
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


def pad_audio_for_device(y: np.ndarray, cfg: SpectConfig, pad_to_frames: Optional[int] = None
                         ) -> Tuple[np.ndarray, int]:
    """Host-side prep for :func:`spectrogram_torch`: reflect-pad (which
    depends on the true length, so it cannot run on a padded batch), then
    zero-pad or cut so the signal holds exactly ``pad_to_frames`` frames.

    Returns (padded_signal, n_valid_frames). The padded length is
    ``(pad_to_frames + 1) * hop`` with n_fft == 2 * hop, so framing on the
    device is a reshape.
    """
    n_fft, hop, _ = stft_params(cfg)
    assert n_fft == 2 * hop, "device framing path assumes 50% overlap (n_fft == 2*hop)"
    pad = n_fft // 2
    n_t = num_frames(len(y), hop)
    if pad_to_frames is None:
        pad_to_frames = n_t
    assert pad_to_frames >= n_t
    yp = np.pad(y.astype(np.float32), pad, mode="reflect")
    total = (pad_to_frames + 1) * hop
    if len(yp) < total:
        yp = np.pad(yp, (0, total - len(yp)))
    else:
        yp = yp[:total]
    return yp, n_t


def spectrogram_torch(yp_batch: torch.Tensor, n_valid: torch.Tensor, cfg: SpectConfig,
                      normalize: bool = True) -> torch.Tensor:
    """Batched spectrogram on the tensors' device.

    Args:
      yp_batch: (B, L_pad) signals prepared by :func:`pad_audio_for_device`,
        float32, or int16 PCM that is dequantized here (the int16 upload
        halves the host-to-device bytes).
      n_valid: (B,) valid frame counts.
    Returns:
      (B, F, T) float32 log-magnitude spectrograms, zero past n_valid and
      normalized per utterance over the valid region (mean, ddof=1 variance,
      ``rsqrt(max(var, 1e-20))``).
    """
    n_fft, hop, _ = stft_params(cfg)
    if not yp_batch.dtype.is_floating_point:
        yp_batch = yp_batch.to(torch.float32) * (1.0 / 32768.0)
    yp_batch = yp_batch.to(torch.float32)
    # pinned and copied without blocking: a pageable copy would wait for the
    # card's stream, which holds the other replicas' work on a shared card
    window = torch.from_numpy(periodic_window(cfg.window, n_fft))
    if yp_batch.is_cuda:
        window = window.pin_memory()
    window = window.to(yp_batch.device, non_blocking=True)
    b = yp_batch.shape[0]
    chunks = yp_batch.reshape(b, yp_batch.shape[1] // hop, hop)
    frames = torch.cat([chunks[:, :-1, :], chunks[:, 1:, :]], dim=-1)   # (B, T, n_fft)
    spec = torch.log1p(torch.fft.rfft(frames * window, dim=-1).abs())  # (B, T, F)
    t, f = spec.shape[1], spec.shape[2]
    n_valid = n_valid.to(device=spec.device)
    mask = (torch.arange(t, device=spec.device)[None, :] < n_valid[:, None]).to(spec.dtype)
    spec = spec * mask[:, :, None]
    if normalize:
        n = (n_valid.to(spec.dtype) * f)[:, None, None]
        mean = spec.sum(dim=(1, 2), keepdim=True) / n
        var = ((spec - mean).square() * mask[:, :, None]).sum(dim=(1, 2), keepdim=True) / (n - 1)
        spec = (spec - mean) * torch.rsqrt(var.clamp_min(1e-20))
        spec = spec * mask[:, :, None]
    return spec.transpose(1, 2)                                         # (B, F, T)


class FeatureExtractor:
    """One utterance -> (F, T) features on the host (``__call__``), a padded
    raw-audio batch -> (B, F, T) on its device (``batch``), and
    fixed-length chunking."""

    def __init__(self, cfg: SpectConfig, normalize: bool = True):
        self.cfg = cfg
        self.normalize = normalize
        self.n_fft, self.hop, self.n_freq = stft_params(cfg)

    def __call__(self, y: np.ndarray) -> np.ndarray:
        return spectrogram_np(y, self.cfg, self.normalize)

    def batch(self, yp_batch: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        return spectrogram_torch(yp_batch, n_valid, self.cfg, self.normalize)

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
