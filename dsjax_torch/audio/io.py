"""Audio I/O: WAV read/write, mono downmix, resampling.

Copy of the host half of dsjax/audio/io.py (numpy/scipy; held against it
by tests/test_torch_frontend.py). FLAC and compressed formats decode through
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


def duration(path: str) -> float:
    """Duration in seconds of a wav file (sox file_info.duration equivalent)."""
    x, sr = read_wav(path)
    return x.shape[1] / float(sr)
