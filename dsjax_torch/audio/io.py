"""Audio I/O: WAV read/write, mono downmix, resampling, trim, tempo, gain.

Copy of the host half of dsjax/audio/io.py (numpy/scipy; held against it
by tests/test_torch_frontend.py, and trim, apply_gain and stretch_tempo by
tests/test_torch_augment.py). FLAC and compressed formats decode through
the port's native host library (``dsjax_torch.audio.native``, copies of
dsjax's C++ decoders), built at the first such file.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Optional, Tuple

import numpy as np
from scipy import signal as sps

from dsjax_torch.audio import native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV file -> (float32 array [channels, n], sample_rate)."""
    with open(path, "rb") as fh:
        header = fh.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_hdr = fh.read(8)
            if len(chunk_hdr) < 8:
                break
            cid = chunk_hdr[:4]
            size = int.from_bytes(chunk_hdr[4:8], "little")
            if cid == b"fmt ":
                fmt = fh.read(size)
            elif cid == b"data":
                data = fh.read(size)
            else:
                fh.seek(size + (size & 1), 1)
                continue
            if size & 1:
                fh.seek(1, 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format = int.from_bytes(fmt[0:2], "little")
    channels = int.from_bytes(fmt[2:4], "little")
    sample_rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if audio_format == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = int.from_bytes(fmt[24:26], "little")
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).T
    else:
        x = x.reshape(1, -1)
    return np.ascontiguousarray(x), sample_rate


_COMPRESSED_EXTS = {".mp3", ".ogg", ".oga", ".opus", ".webm", ".mka", ".mkv"}


def load_audio(path: str, sample_rate: Optional[int] = None) -> np.ndarray:
    """Load audio as mono float32, averaging channels; optionally resample
    to ``sample_rate``. WAV via the reader above; FLAC and mp3/ogg/opus/webm
    via the native decoders of ``dsjax_torch.audio.native``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flac":
        y, sr = native.decode_flac(path)
    elif ext in _COMPRESSED_EXTS:
        y, sr = native.decode_file(path)
    else:
        x, sr = read_wav(path)
        y = x[0] if x.shape[0] == 1 else x.mean(axis=0)
    if sample_rate is not None and sr != sample_rate:
        y = resample(y, sr, sample_rate)
    return np.ascontiguousarray(y, dtype=np.float32)


def save_wav(path: str, y: np.ndarray, sample_rate: int) -> None:
    """Write mono/multichannel float32 [-1,1] to 16-bit PCM WAV."""
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[None, :]
    # scale by 32768 (matching the reader's 1/32768) and clip the one
    # unrepresentable positive code; rounding halves the quantization error
    pcm = np.clip(np.round(y * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(y.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (sox `-r` equivalent)."""
    if orig_sr == target_sr:
        return y
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return sps.resample_poly(y, up, down).astype(np.float32)


def trim(y: np.ndarray, sample_rate: int, start_s: float, end_s: float) -> np.ndarray:
    """Crop [start_s, end_s) seconds (sox `trim` equivalent,
    reference: data_loader.py:363-374)."""
    i0 = max(0, int(round(start_s * sample_rate)))
    i1 = min(len(y), int(round(end_s * sample_rate)))
    return y[i0:i1]


def apply_gain(y: np.ndarray, gain_db: float) -> np.ndarray:
    """sox `gain` equivalent: scale by 10^(dB/20)."""
    return (y * (10.0 ** (gain_db / 20.0))).astype(np.float32)


def stretch_tempo(y: np.ndarray, sample_rate: int, tempo: float) -> np.ndarray:
    """Time-stretch preserving pitch (sox `tempo` / WSOLA equivalent).

    Output length ~= len(y)/tempo. Used by speed perturbation
    (reference: data_loader.py:377-404).
    """
    if abs(tempo - 1.0) < 1e-6 or len(y) == 0:
        return y.astype(np.float32)
    win = int(0.025 * sample_rate)          # 25 ms analysis window
    win -= win % 2
    hop_out = win // 2                      # 50% overlap synthesis hop
    hop_in = int(round(hop_out * tempo))
    seek = int(0.005 * sample_rate)         # +-5 ms WSOLA seek window
    n_out_frames = max(1, (int(len(y) / tempo) - win) // hop_out + 1)
    window = np.hanning(win).astype(np.float32)
    out = np.zeros(n_out_frames * hop_out + win, dtype=np.float32)
    norm = np.zeros_like(out)
    pos_in = 0.0
    prev_tail: Optional[np.ndarray] = None
    for i in range(n_out_frames):
        center = int(pos_in)
        if prev_tail is not None and seek > 0:
            lo = max(0, center - seek)
            hi = min(len(y) - win, center + seek)
            if hi > lo:
                best, best_corr = center, -np.inf
                for cand in range(lo, hi + 1, max(1, seek // 8)):
                    seg = y[cand:cand + hop_out]
                    if len(seg) < hop_out:
                        break
                    c = float(np.dot(seg, prev_tail))
                    if c > best_corr:
                        best_corr, best = c, cand
                center = best
        frame = y[center:center + win]
        if len(frame) < win:
            frame = np.pad(frame, (0, win - len(frame)))
        wf = frame * window
        out[i * hop_out:i * hop_out + win] += wf
        norm[i * hop_out:i * hop_out + win] += window
        prev_tail = y[center + hop_out:center + hop_out + hop_out]
        if len(prev_tail) < hop_out:
            prev_tail = np.pad(prev_tail, (0, hop_out - len(prev_tail)))
        pos_in += hop_in
        if pos_in >= len(y):
            out = out[: i * hop_out + win]
            norm = norm[: i * hop_out + win]
            break
    norm = np.where(norm > 1e-6, norm, 1.0)
    return (out / norm).astype(np.float32)


def duration(path: str) -> float:
    """Duration in seconds of a wav file (sox file_info.duration equivalent)."""
    x, sr = read_wav(path)
    return x.shape[1] / float(sr)
