"""Shared dataset-prep helpers: download, extract, convert, manifest.

A copy of dsjax/datasets/common.py on the port's audio I/O. Reference
equivalents: deepspeech_pytorch/data/utils.py and the per-corpus scripts
under data/ (an4.py, librispeech.py, ted.py, common_voice.py, voxforge.py).
Audio conversion is done natively (no sox binary): WAV parsing/writing and
resampling live in dsjax_torch.audio.io; NIST SPHERE is parsed here; FLAC
decoding uses the port's native host library (dsjax_torch.audio.native).
"""

from __future__ import annotations

import argparse
import os
import tarfile
import urllib.request
import zipfile

import numpy as np

from dsjax_torch.audio import native
from dsjax_torch.audio.io import load_audio, read_wav, resample, save_wav


def add_data_opts(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Shared CLI options (reference: data/data_opts.py)."""
    data_opts = parser.add_argument_group("General Data Options")
    data_opts.add_argument("--manifest-dir", default="./", type=str,
                           help="Output directory for manifests")
    data_opts.add_argument("--min-duration", default=1, type=int,
                           help="Prunes training samples shorter than the min duration (given in seconds)")
    data_opts.add_argument("--max-duration", default=15, type=int,
                           help="Prunes training samples longer than the max duration (given in seconds)")
    data_opts.add_argument("--num-workers", default=4, type=int,
                           help="Number of workers for processing data")
    parser.add_argument("--sample-rate", default=16000, type=int,
                        help="Sample rate")
    return parser


def download(url: str, dest: str) -> str:
    """Download url -> dest path (skips when present)."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".", exist_ok=True)
    if os.path.exists(dest):
        return dest
    print(f"downloading {url} -> {dest}")
    tmp = dest + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.rename(tmp, dest)
    return dest


def extract(archive: str, target_dir: str) -> None:
    os.makedirs(target_dir, exist_ok=True)
    if archive.endswith((".tar.gz", ".tgz", ".tar.bz2", ".tar")):
        with tarfile.open(archive) as t:
            t.extractall(target_dir)
    elif archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(target_dir)
    else:
        raise ValueError(f"unknown archive format: {archive}")


# ---------------------------------------------------------------------------
# Non-WAV audio container support
# ---------------------------------------------------------------------------

def read_sphere(path: str) -> tuple[np.ndarray, int]:
    """Read a NIST SPHERE (.sph) file -> (float32 mono [n], sample_rate).
    TED-LIUM sph files are 16-bit linear PCM (reference converts them with
    sox, data/ted.py:20-146)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split()
            if len(parts) >= 3 and parts[0] != "end_head":
                fields[parts[0]] = parts[2]
        sample_rate = int(fields.get("sample_rate", 16000))
        channels = int(fields.get("channel_count", 1))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        fmt = fields.get("sample_coding", "pcm")
        byte_fmt = fields.get("sample_byte_format", "01")
        f.seek(header_size)
        data = f.read()
    if "ulaw" in fmt:
        x = _ulaw_decode(np.frombuffer(data, dtype=np.uint8))
    elif n_bytes == 2:
        dt = "<i2" if byte_fmt == "01" else ">i2"
        x = np.frombuffer(data, dtype=dt).astype(np.float32) / 32768.0
    else:
        raise ValueError(f"{path}: unsupported sphere coding {fmt}/{n_bytes}B")
    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels).mean(axis=1)
    return x.astype(np.float32), sample_rate


def _ulaw_decode(u: np.ndarray) -> np.ndarray:
    u = ~u
    sign = np.where(u & 0x80, -1.0, 1.0)
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa.astype(np.int32) << 3) + 0x84) << exponent
    return (sign * (magnitude - 0x84) / 32768.0).astype(np.float32)


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode FLAC via the port's native host library."""
    return native.decode_flac(path)


def convert_to_wav(src: str, dst: str, sample_rate: int = 16000) -> None:
    """Any supported container -> 16k mono 16-bit WAV."""
    ext = os.path.splitext(src)[1].lower()
    if ext == ".wav":
        y = load_audio(src)
        _, sr = read_wav(src)
    elif ext == ".sph":
        y, sr = read_sphere(src)
    elif ext == ".flac":
        y, sr = read_flac(src)
    else:
        raise ValueError(f"unsupported audio container {ext}; no native decoder")
    if sr != sample_rate:
        y = resample(y, sr, sample_rate)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    save_wav(dst, y, sample_rate)
