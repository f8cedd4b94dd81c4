"""The port's native host library: FLAC and compressed-audio decoders, the
Levenshtein distance, the word n-gram LM and the CTC prefix beam search,
bound with ctypes.

The C++ sources are copies of dsjax's (``dsjax_torch/csrc/host/``: flac.cpp,
audio_decode.cpp, lm.h, lm.cpp whole, beam.cpp without ``ds_levenshtein``,
which levenshtein.cpp defines once), so the port imports nothing of dsjax. They compile with g++ at first use into
``build/dsjax_torch/libdsjax_torch_host.so`` under the checkout's root, and
again only when a source or the flags change (a SHA-256 of both is kept
beside the library, as ``dsjax_torch/ops/_build.py`` does for the CUDA
kernels). The codec libraries (libmpg123, libvorbisfile, libopus) are
dlopen'd by audio_decode.cpp at first use; without them ``can_decode`` is
False and decoding raises. Importing this module builds and loads nothing.

The functions mirror dsjax/cpp/{flac_binding,audio_binding,beam_binding}.py:
``decode_flac``, ``decode_file``, ``decode_bytes``, ``can_decode``,
``available_formats`` and ``levenshtein``; ``decode/native_beam.py`` binds
the LM and the beam search on the same library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from dsjax_torch.ops import _build

SRC_DIR = _build.PACKAGE_DIR / "csrc" / "host"
LIB_PATH = _build.BUILD_DIR / "libdsjax_torch_host.so"
SOURCES = ("flac.cpp", "audio_decode.cpp", "levenshtein.cpp", "lm.cpp", "beam.cpp")
HEADERS = ("lm.h",)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-ldl"]                       # audio_decode.cpp dlopens the codecs

FMT_MP3, FMT_VORBIS, FMT_OPUS = 1, 2, 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile the sources into LIB_PATH unless an up-to-date build exists."""

    def make(work: str, out: str) -> None:
        _build.run_all([["g++", *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", out,
                         *LIBS]])

    return _build.stamped_build(LIB_PATH, source_hash(), make, force)


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ds_flac_decode.restype = ctypes.c_int
    lib.ds_flac_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(i32p),
                                   ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ds_flac_free.argtypes = [i32p]
    lib.ds_audio_decode.restype = ctypes.c_int
    lib.ds_audio_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(f32p),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ds_audio_free.argtypes = [f32p]
    lib.ds_audio_formats.restype = ctypes.c_int
    lib.ds_levenshtein.restype = ctypes.c_int
    lib.ds_levenshtein.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int]
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    strs = ctypes.POINTER(ctypes.c_char_p)
    lib.ds_lm_load.restype = p
    lib.ds_lm_load.argtypes = [ctypes.c_char_p]
    lib.ds_lm_free.restype = None
    lib.ds_lm_free.argtypes = [p]
    lib.ds_lm_score_word.restype = d
    lib.ds_lm_score_word.argtypes = [p, strs, i, ctypes.c_char_p]
    lib.ds_lm_order.restype = i
    lib.ds_lm_order.argtypes = [p]
    lib.ds_lm_build_binary.restype = i
    lib.ds_lm_build_binary.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ds_beam_create.restype = p
    lib.ds_beam_create.argtypes = [strs, i, i, i, p]
    lib.ds_beam_free.restype = None
    lib.ds_beam_free.argtypes = [p]
    lib.ds_beam_decode.restype = i
    lib.ds_beam_decode.argtypes = [p, f32p, i, i, d, d, i, i, d, i, i, ctypes.POINTER(i),
                                   ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(d)]


def load_library() -> ctypes.CDLL:
    """Build if needed and load the host library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC file -> (float32 mono signal, sample_rate); channels are
    averaged (reference load_audio parity, data_loader.py:20-26)."""
    lib = load_library()
    samples = ctypes.POINTER(ctypes.c_int32)()
    n, channels, rate, bps = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ds_flac_decode(path.encode(), ctypes.byref(samples), ctypes.byref(n),
                            ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bps))
    if rc != 0:
        raise IOError(f"FLAC decode failed for {path} (code {rc})")
    try:
        count = n.value * channels.value
        arr = (np.ctypeslib.as_array(samples, shape=(count,)).copy()
               if count else np.zeros((0,), np.int32))
    finally:
        lib.ds_flac_free(samples)
    x = arr.reshape(-1, max(channels.value, 1)).astype(np.float32) / float(1 << (bps.value - 1))
    y = x[:, 0] if x.shape[1] == 1 else x.mean(axis=1)
    return np.ascontiguousarray(y), rate.value


def available_formats() -> int:
    """Bitmask of decodable codecs (FMT_MP3 | FMT_VORBIS | FMT_OPUS); 0 when
    the system codec libraries, or the host library itself, are absent."""
    try:
        return int(load_library().ds_audio_formats())
    except (OSError, RuntimeError):
        return 0


def decode_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Compressed audio bytes (mp3, Ogg Vorbis/Opus, WebM) -> (float32 mono
    signal, sample_rate)."""
    lib = load_library()
    pcm = ctypes.POINTER(ctypes.c_float)()
    frames, channels, rate = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ds_audio_decode(data, len(data), ctypes.byref(pcm), ctypes.byref(frames),
                             ctypes.byref(channels), ctypes.byref(rate))
    if rc != 0:
        raise IOError(f"audio decode failed (code {rc}); "
                      f"available codec mask={available_formats()}")
    try:
        count = frames.value * channels.value
        arr = (np.ctypeslib.as_array(pcm, shape=(count,)).copy()
               if count else np.zeros((0,), np.float32))
    finally:
        lib.ds_audio_free(pcm)
    x = arr.reshape(-1, max(channels.value, 1))
    y = x[:, 0] if channels.value == 1 else x.mean(axis=1)
    return np.ascontiguousarray(y, np.float32), rate.value


def decode_file(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_bytes(f.read())


def can_decode(path_or_name: Optional[str]) -> bool:
    """True when the extension is a compressed format this host can decode."""
    if not path_or_name:
        return False
    ext = os.path.splitext(path_or_name)[1].lower().lstrip(".")
    mask = available_formats()
    if ext == "mp3":
        return bool(mask & FMT_MP3)
    if ext in ("ogg", "oga", "webm", "mka", "mkv"):
        return bool(mask & (FMT_VORBIS | FMT_OPUS))
    if ext == "opus":
        return bool(mask & FMT_OPUS)
    return False


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Edit distance between two integer sequences."""
    lib = load_library()
    aa = np.ascontiguousarray(a, dtype=np.int32)
    bb = np.ascontiguousarray(b, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return lib.ds_levenshtein(aa.ctypes.data_as(i32p), len(aa), bb.ctypes.data_as(i32p), len(bb))
