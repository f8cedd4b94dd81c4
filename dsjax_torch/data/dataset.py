"""Dataset + collate: manifest -> (spectrogram or raw audio, transcript ids)
-> padded batch.

The counterpart of dsjax/data/dataset.py (reference
loader/data_loader.py:189-279), in two modes:
  * host features: per-sample wav load -> STFT/log1p/normalize on the host;
    ``collate`` sorts by length desc, zero-pads the time axis to a multiple
    of ``bucket_frames`` and the targets to a multiple of ``bucket_labels``,
    and marks batch-pad rows invalid;
  * device features (``device_features=True``, dsjax's default): the host
    only loads and reflect-pads the waveform and ships it as int16 PCM;
    ``collate_audio`` pads it to a bucketed frame count and the STFT runs
    on the device (``audio.features.spectrogram_torch``).
With ``aug_cfg`` the training set augments as dsjax's does: tempo/gain
and noise on the waveform before the STFT or the device padding, host
SpecAugment on the host spectrogram (which therefore forces host features,
unless ``spec_augment_device`` moves the masks into the step).
Held against dsjax's pipeline by tests/test_torch_data.py,
tests/test_torch_frontend.py and tests/test_torch_augment.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dsjax_torch.audio.augment import AugmentPipeline
from dsjax_torch.audio.features import FeatureExtractor, num_frames, pad_audio_for_device
from dsjax_torch.audio.io import load_audio, read_wav
from dsjax_torch.config import AugmentationConfig, SpectConfig
from dsjax_torch.data.manifest import parse_input
from dsjax_torch.labels import LabelMap


@dataclasses.dataclass
class Batch:
    """One padded batch: ``inputs`` (B, F, T) float32 spectrograms, or, in
    device-feature mode, ``inputs`` None and ``audio`` (B, L_pad) raw
    signal prepared by ``pad_audio_for_device``; ``input_lengths`` the valid
    frame counts in both modes, ``targets`` (B, L) padded with 0 and masked
    by ``target_lengths``; ``valid`` is False on batch-pad rows."""

    inputs: Optional[np.ndarray]
    input_lengths: np.ndarray      # (B,) valid frame counts
    targets: np.ndarray            # (B, L) padded with 0 (masked by lengths)
    target_lengths: np.ndarray     # (B,)
    input_percentages: np.ndarray  # (B,) reference-parity: len / padded T
    audio: Optional[np.ndarray] = None  # (B, L_pad) device-feature mode
    valid: Optional[np.ndarray] = None  # (B,) bool; False = batch-pad row

    @property
    def valid_mask(self) -> np.ndarray:
        """(B,) float32 row-validity mask; pad rows (pad_to_batch) are 0 so
        they contribute zero loss/gradient (a pad row with input_length=1
        otherwise yields nll = -log p_blank with real gradients)."""
        if self.valid is None:
            return np.ones((self.size,), np.float32)
        return self.valid.astype(np.float32)

    @property
    def size(self) -> int:
        arr = self.inputs if self.inputs is not None else self.audio
        return arr.shape[0]


def round_up(n: int, mult: int) -> int:
    if mult <= 1:
        return n
    return ((n + mult - 1) // mult) * mult


def collate(samples: Sequence[Tuple[np.ndarray, List[int]]],
            bucket_frames: int = 1, bucket_labels: int = 1,
            pad_to_batch: Optional[int] = None) -> Batch:
    """Sort by length desc (reference: data_loader.py:251), pad to bucketed
    max, emit padded targets. ``pad_to_batch`` repeats zero rows so the batch
    dimension is fixed too; pad rows are marked invalid (Batch.valid) and
    the train loop zeroes their loss."""
    samples = sorted(samples, key=lambda s: s[0].shape[1], reverse=True)
    b = len(samples)
    freq = samples[0][0].shape[0]
    max_t = round_up(max(s[0].shape[1] for s in samples), bucket_frames)
    max_l = round_up(max((len(s[1]) for s in samples), default=1) or 1, bucket_labels)
    b_pad = pad_to_batch if pad_to_batch is not None else b
    inputs = np.zeros((b_pad, freq, max_t), np.float32)
    input_lengths = np.ones((b_pad,), np.int32)
    targets = np.zeros((b_pad, max_l), np.int32)
    target_lengths = np.zeros((b_pad,), np.int32)
    percentages = np.zeros((b_pad,), np.float32)
    valid = np.zeros((b_pad,), bool)
    valid[:b] = True
    for i, (spect, transcript) in enumerate(samples):
        t = spect.shape[1]
        inputs[i, :, :t] = spect
        input_lengths[i] = t
        targets[i, : len(transcript)] = transcript
        target_lengths[i] = len(transcript)
        percentages[i] = t / float(max_t)
    return Batch(inputs, input_lengths, targets, target_lengths, percentages, valid=valid)


def collate_audio(samples: Sequence[Tuple[np.ndarray, int, List[int]]],
                  hop: int, bucket_frames: int = 1, bucket_labels: int = 1,
                  pad_to_batch: Optional[int] = None) -> Batch:
    """Device-feature twin of :func:`collate`: pads reflect-padded raw audio
    to a common bucketed frame count; the STFT happens on the device. Each
    row holds (frames - 1) * hop + n_fft samples, as
    ``pad_audio_for_device`` lays it out from the config's n_fft (2 * hop for
    the linear spectrogram), and the batch takes the same layout."""
    samples = sorted(samples, key=lambda s: s[1], reverse=True)
    b = len(samples)
    max_t = round_up(max(s[1] for s in samples), bucket_frames)
    max_l = round_up(max((len(s[2]) for s in samples), default=1) or 1, bucket_labels)
    n_fft = max((len(s[0]) - (s[1] - 1) * hop for s in samples), default=2 * hop)
    total = (max_t - 1) * hop + n_fft
    b_pad = pad_to_batch if pad_to_batch is not None else b
    audio = np.zeros((b_pad, total), samples[0][0].dtype if b else np.float32)
    input_lengths = np.ones((b_pad,), np.int32)
    targets = np.zeros((b_pad, max_l), np.int32)
    target_lengths = np.zeros((b_pad,), np.int32)
    percentages = np.zeros((b_pad,), np.float32)
    valid = np.zeros((b_pad,), bool)
    valid[:b] = True
    for i, (yp, n_frames, transcript) in enumerate(samples):
        audio[i, : len(yp)] = yp[:total]
        input_lengths[i] = n_frames
        targets[i, : len(transcript)] = transcript
        target_lengths[i] = len(transcript)
        percentages[i] = n_frames / float(max_t)
    return Batch(None, input_lengths, targets, target_lengths, percentages,
                 audio=audio, valid=valid)


class SpectrogramDataset:
    """Manifest- or directory-backed dataset (reference:
    data_loader.py:189-244).

    device_features=False: ``__getitem__`` -> (spect (F, T), ids), the STFT
    on the host. device_features=True: ``__getitem__`` -> (audio (L_pad,),
    n_frames, ids), the reflect-padded waveform as int16 PCM when
    ``audio_int16`` (exact for 16-bit sources), and the STFT and
    normalization run on the device. Host SpecAugment needs the
    spectrogram, so enabling it forces host features.
    """

    def __init__(self, spect_cfg: SpectConfig, input_path: str,
                 labels: Sequence[str], normalize: bool = True,
                 aug_cfg: Optional[AugmentationConfig] = None,
                 seed: int = 0, device_features: bool = False,
                 audio_int16: bool = True):
        self.ids = parse_input(input_path)
        self.label_map = LabelMap(labels)
        self.spect_cfg = spect_cfg
        self.extractor = FeatureExtractor(spect_cfg, normalize=normalize)
        self.augment = AugmentPipeline(aug_cfg, spect_cfg, seed=seed) if aug_cfg else None
        # host SpecAugment needs the spectrogram; its on-device variant
        # (spec_augment_device) keeps the raw-audio path
        self.device_features = device_features and not (
            aug_cfg is not None and aug_cfg.spec_augment
            and not aug_cfg.spec_augment_device)
        self.audio_int16 = audio_int16

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int):
        wav_path, transcript_path = self.ids[index]
        y = load_audio(str(wav_path), self.spect_cfg.sample_rate)
        if self.augment is not None:
            y = self.augment.apply_waveform(y)
        transcript = self.parse_transcript(str(transcript_path))
        if self.device_features:
            yp, n_frames = pad_audio_for_device(y, self.spect_cfg)
            if self.audio_int16:
                # tempo/gain augmentation saturates at full scale upstream
                # (reference sox -b 16 parity, audio/augment.py); a noise
                # mix can still exceed it (the reference keeps those
                # float) — peak-rescale rather than hard-clip, a constant
                # gain the per-utterance feature normalization mostly
                # absorbs, vs. clipping's harmonic distortion
                peak = float(np.max(np.abs(yp), initial=0.0))
                if peak > 1.0:
                    yp = yp / peak
                yp = np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
            return yp, n_frames, transcript
        spect = self.extractor(y)
        if self.augment is not None:
            spect = self.augment.apply_spectrogram(spect)
        return spect, transcript

    def parse_transcript(self, transcript_path: str) -> List[int]:
        with open(transcript_path, "r", encoding="utf8") as f:
            transcript = f.read().replace("\n", "")
        return self.label_map.encode(transcript)

    def frame_count(self, index: int) -> int:
        """Frame count from the file's samples, for bucketing."""
        wav_path, _ = self.ids[index]
        x, sr = read_wav(str(wav_path))
        n = x.shape[1]
        if sr != self.spect_cfg.sample_rate:
            n = int(n * self.spect_cfg.sample_rate / sr)
        return num_frames(n, self.extractor.hop)
