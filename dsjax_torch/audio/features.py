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

``LogMelConfig`` (``data.spect=logmel``) selects NeMo's log-mel front end
(``AudioToMelSpectrogramPreprocessor``, the Conformer's) beside it, with a
host twin (``logmel_np``) and a device function (``logmel_torch``):

  * pre-emphasis y[i] - 0.97 y[i - 1] over the utterance's own samples
    (its first sample kept), zero past its end;
  * zero padding of n_fft / 2 each side, a frame every hop, the symmetric
    Hann window of window_size seconds in the middle of n_fft points;
  * the power spectrum, ``features`` Slaney mel bands (``mel_filterbank``),
    log(x + 2^-24);
  * per-feature normalisation over the valid frames: mean, ddof=1 standard
    deviation plus 1e-5; zero past the valid frames.

On the device path ``pad_audio_for_device`` applies the pre-emphasis on
the host (it needs the true length) and lays each row out as
(frames - 1) * hop + n_fft samples; ``logmel_torch`` frames the padded
batch with ``unfold``. ``features_torch`` and ``FeatureExtractor`` pick the
front end from the config's class.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
from scipy.signal import get_window

from dsjax_torch.config import LogMelConfig, SpectConfig, SpectrogramWindow

PREEMPH = 0.97           # the log-mel front end's pre-emphasis
LOG_GUARD = 2.0 ** -24   # added to the mel power before its log
NORM_EPS = 1e-5          # added to the log-mel features' standard deviation


def stft_params(cfg: SpectConfig) -> Tuple[int, int, int]:
    """(n_fft, hop_length, feature rows) for a spect config: the linear
    spectrogram's frequency bins, or the log-mel's bands."""
    hop = int(cfg.sample_rate * cfg.window_stride)
    if isinstance(cfg, LogMelConfig):
        return cfg.n_fft, hop, cfg.features
    n_fft = int(cfg.sample_rate * cfg.window_size)
    return n_fft, hop, n_fft // 2 + 1


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float32 triangles on the Slaney mel scale
    (linear below 1 kHz, logarithmic above) from 0 Hz to Nyquist, each
    scaled to unit area by 2 / its width in Hz (librosa's ``norm='slaney'``)."""
    f_sp, break_hz = 200.0 / 3.0, 1000.0
    break_mel, log_step = break_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f < break_hz, f / f_sp,
                        break_mel + np.log(np.maximum(f, break_hz) / break_hz) / log_step)

    def to_hz(m):
        return np.where(m < break_mel, f_sp * m, break_hz * np.exp(log_step * (m - break_mel)))

    edges = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    rise = (bins[None, :] - edges[:-2, None]) / (edges[1:-1] - edges[:-2])[:, None]
    fall = (edges[2:, None] - bins[None, :]) / (edges[2:] - edges[1:-1])[:, None]
    tri = np.maximum(0.0, np.minimum(rise, fall))
    return (tri * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


def centred_window(cfg: LogMelConfig) -> np.ndarray:
    """The symmetric window of ``window_size`` seconds, zero-padded to
    ``n_fft`` points on both sides (as ``torch.stft`` centres a shorter
    window)."""
    win = int(cfg.sample_rate * cfg.window_size)
    name = cfg.window.value if isinstance(cfg.window, SpectrogramWindow) else cfg.window
    w = get_window(name, win, fftbins=False)
    left = (cfg.n_fft - win) // 2
    return np.pad(w, (left, cfg.n_fft - win - left)).astype(np.float32)


def preemphasis(y: np.ndarray) -> np.ndarray:
    """y[i] - 0.97 y[i - 1], the first sample kept, in float32."""
    y = np.asarray(y, np.float32)
    out = y.copy()
    out[1:] -= np.float32(PREEMPH) * y[:-1]
    return out


def logmel_np(y: np.ndarray, cfg: LogMelConfig, normalize: bool = True) -> np.ndarray:
    """One utterance's log-mel features, (features, T) float32, T = 1 + n // hop."""
    n_fft, hop, _ = stft_params(cfg)
    e = preemphasis(y).astype(np.float64)
    yp = np.pad(e, n_fft // 2)
    n_t = num_frames(len(y), hop)
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop][:n_t]
    power = np.abs(np.fft.rfft(frames * centred_window(cfg), axis=-1)) ** 2    # (T, n_fft/2+1)
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.features).astype(np.float64)
    spec = np.log(power @ fb.T + LOG_GUARD).T                         # (features, T)
    if normalize:
        mean = spec.mean(axis=1, keepdims=True)
        std = np.sqrt(((spec - mean) ** 2).sum(axis=1, keepdims=True) / max(n_t - 1, 1))
        spec = (spec - mean) / (std + NORM_EPS)
    return spec.astype(np.float32)


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
    """Host-side prep for :func:`features_torch`: reflect-pad (which
    depends on the true length, so it cannot run on a padded batch), then
    zero-pad or cut so the signal holds exactly ``pad_to_frames`` frames.
    A ``LogMelConfig`` takes its pre-emphasis here, over the true length,
    and zero padding of n_fft / 2 each side.

    Returns (padded_signal, n_valid_frames). The padded length is
    ``(pad_to_frames - 1) * hop + n_fft``: ``(pad_to_frames + 1) * hop``
    with n_fft == 2 * hop, so framing on the device is a reshape.
    """
    n_fft, hop, _ = stft_params(cfg)
    if isinstance(cfg, LogMelConfig):
        n_t = num_frames(len(y), hop)
        pad_to_frames = n_t if pad_to_frames is None else pad_to_frames
        assert pad_to_frames >= n_t
        yp = np.pad(preemphasis(y), n_fft // 2)
        total = (pad_to_frames - 1) * hop + n_fft
        return np.pad(yp, (0, max(0, total - len(yp))))[:total], n_t
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


def logmel_torch(yp_batch: torch.Tensor, n_valid: torch.Tensor, cfg: LogMelConfig,
                 normalize: bool = True) -> torch.Tensor:
    """Batched log-mel features on the tensors' device: ``logmel_np`` of
    each row.

    Args:
      yp_batch: (B, L_pad) rows prepared by :func:`pad_audio_for_device`
        (pre-emphasised, n_fft / 2 zeros in front), float32 or int16 PCM.
      n_valid: (B,) valid frame counts.
    Returns:
      (B, features, T) float32, T = (L_pad - n_fft) // hop + 1, zero past
      n_valid.
    """
    n_fft, hop, _ = stft_params(cfg)
    if not yp_batch.dtype.is_floating_point:
        yp_batch = yp_batch.to(torch.float32) * (1.0 / 32768.0)
    dev = yp_batch.device
    # pinned and copied without blocking, as in spectrogram_torch: a pageable
    # copy would wait for the card's stream, and the host could not issue a
    # step ahead of the card
    window, fb = (torch.from_numpy(a) for a in (
        centred_window(cfg), mel_filterbank(cfg.sample_rate, n_fft, cfg.features)))
    if yp_batch.is_cuda:
        window, fb = window.pin_memory(), fb.pin_memory()
    window, fb = window.to(dev, non_blocking=True), fb.to(dev, non_blocking=True)
    frames = yp_batch.to(torch.float32).unfold(1, n_fft, hop)            # (B, T, n_fft)
    power = torch.view_as_real(torch.fft.rfft(frames * window, dim=-1)).square().sum(-1)
    spec = torch.log(power @ fb.T + LOG_GUARD)                  # (B, T, features)
    mask = (torch.arange(spec.shape[1], device=dev)[None, :]
            < n_valid.to(dev)[:, None]).to(spec.dtype)[:, :, None]
    if normalize:
        n = mask.sum(dim=1, keepdim=True)
        mean = (spec * mask).sum(dim=1, keepdim=True) / n
        var = ((spec - mean).square() * mask).sum(dim=1, keepdim=True) / (n - 1).clamp_min(1)
        spec = (spec - mean) / (var.sqrt() + NORM_EPS)
    return (spec * mask).transpose(1, 2)


def features_torch(yp_batch: torch.Tensor, n_valid: torch.Tensor, cfg: SpectConfig,
                   normalize: bool = True) -> torch.Tensor:
    """The config's front end on a device batch: :func:`logmel_torch` for a
    ``LogMelConfig``, else :func:`spectrogram_torch`."""
    fn = logmel_torch if isinstance(cfg, LogMelConfig) else spectrogram_torch
    return fn(yp_batch, n_valid, cfg, normalize=normalize)


class FeatureExtractor:
    """One utterance -> (F, T) features on the host (``__call__``), a padded
    raw-audio batch -> (B, F, T) on its device (``batch``), and
    fixed-length chunking."""

    def __init__(self, cfg: SpectConfig, normalize: bool = True):
        self.cfg = cfg
        self.normalize = normalize
        self.n_fft, self.hop, self.n_freq = stft_params(cfg)

    def __call__(self, y: np.ndarray) -> np.ndarray:
        fn = logmel_np if isinstance(self.cfg, LogMelConfig) else spectrogram_np
        return fn(y, self.cfg, self.normalize)

    def batch(self, yp_batch: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        return features_torch(yp_batch, n_valid, self.cfg, self.normalize)

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
