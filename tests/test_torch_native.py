"""The port's native host library against dsjax.cpp's (CPU).

``dsjax_torch.audio.native`` builds copies of dsjax's C++ FLAC and
compressed-audio decoders and its Levenshtein distance with g++; every
decode is held against dsjax.cpp's on the same bytes sample for sample
(exact equality: the same code on the same input), and so is the edit
distance. The test may import dsjax.cpp; the port may not.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dsjax.cpp import audio_binding, beam_binding, flac_binding
from dsjax_torch.audio import native
from dsjax_torch.audio.io import load_audio
from tests import codec_fixtures as fx
from tests.flac_encoder import encode_flac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sine(sr, seconds=0.6, freq=440.0):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


FLAC_CASES = {
    "mono_16_fixed": dict(channels=1, bps=16, modes=["fixed1", "fixed2", "verbatim"]),
    "mono_24_constant": dict(channels=1, bps=24, modes=["constant"]),
    "stereo_16_left_side": dict(channels=2, bps=16, modes=["fixed2"], stereo_mode="left_side"),
    "stereo_8_independent": dict(channels=2, bps=8, modes=["fixed0"]),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_decode_equals_dsjax(tmp_path, case):
    kw = dict(FLAC_CASES[case])
    channels, bps = kw.pop("channels"), kw.pop("bps")
    rng = np.random.default_rng(len(case))
    scale = 2 ** (bps - 1) - 1
    x = np.clip(np.sin(np.arange(9000)[:, None] * 0.01 * (1 + np.arange(channels)))
                * 0.6 * scale + rng.standard_normal((9000, channels)) * 0.01 * scale,
                -scale, scale).astype(np.int32)
    if "constant" in kw.get("modes", []):
        x[:] = -123
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(x[:, 0] if channels == 1 else x, 16000, bps=bps,
                                 block_size=4096, **kw))
    got, got_sr = native.decode_flac(str(path))
    want, want_sr = flac_binding.decode_flac(str(path))
    assert got_sr == want_sr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_audio(str(path)), want)


def _codec_blobs():
    """(name, bytes) of every compressed container the encoders here make."""
    y16, y48 = _sine(16000), _sine(48000)
    makers = {"mp3": lambda: fx.encode_mp3(y16, 16000),
              "ogg_vorbis": lambda: fx.encode_ogg_vorbis(y16, 16000),
              "ogg_opus": lambda: fx.encode_ogg_opus(y48),
              "webm_opus": lambda: fx.encode_webm_opus(y48),
              "webm_vorbis": lambda: fx.encode_webm_vorbis(y16, 16000)}
    return makers


@pytest.mark.parametrize("codec", list(_codec_blobs()))
def test_compressed_decode_equals_dsjax(tmp_path, codec):
    blob = _codec_blobs()[codec]()
    if blob is None:
        pytest.skip(f"no {codec} encoder on this host")
    got, got_sr = native.decode_bytes(blob)
    want, want_sr = audio_binding.decode_bytes(blob)
    assert got_sr == want_sr and got.dtype == np.float32 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    ext = {"mp3": "mp3", "ogg_vorbis": "ogg", "ogg_opus": "opus", "webm_opus": "webm",
           "webm_vorbis": "webm"}[codec]
    path = tmp_path / f"a.{ext}"
    path.write_bytes(blob)
    np.testing.assert_array_equal(native.decode_file(str(path))[0], want)
    np.testing.assert_array_equal(load_audio(str(path)), want)


def test_formats_and_garbage_agree_with_dsjax():
    assert native.available_formats() == audio_binding.available_formats()
    for name in ("a.mp3", "a.ogg", "a.oga", "a.opus", "a.webm", "a.mkv", "a.wav", "a", "", None):
        assert native.can_decode(name) == audio_binding.can_decode(name), name
    for bad in (b"\x00" * 1000, b"OggS" + b"\x01" * 200):
        with pytest.raises(IOError):
            native.decode_bytes(bad)
    with pytest.raises(IOError):
        native.decode_flac(os.path.join(ROOT, "README.md"))


def test_levenshtein_equals_dsjax():
    rng = np.random.default_rng(0)
    pairs = [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [2, 3]), ([], [1, 2]), ([5, 6], [7, 8, 9]),
             ([], [])]
    pairs += [(list(rng.integers(0, 5, rng.integers(0, 40))),
               list(rng.integers(0, 5, rng.integers(0, 40)))) for _ in range(50)]
    for a, b in pairs:
        assert native.levenshtein(a, b) == beam_binding.levenshtein(a, b), (a, b)


def test_metrics_use_the_port_library(monkeypatch):
    """WER/CER with python-Levenshtein absent take the port's native distance
    and give dsjax's integers."""
    from dsjax.train import metrics as jax_metrics
    from dsjax_torch.train import metrics

    monkeypatch.setitem(sys.modules, "Levenshtein", None)
    metrics._distance_fn.cache_clear()
    try:
        fn = metrics._distance_fn()
        assert fn is not metrics._py_distance
        for a, b in (("THE CAT SAT", "THE CAT SAT ON"), ("ABC", "XBCD"), ("", "AB")):
            assert metrics.wer_distance(a, b) == jax_metrics.wer_distance(a, b)
            assert metrics.cer_distance(a, b) == jax_metrics.cer_distance(a, b)
    finally:
        metrics._distance_fn.cache_clear()


def test_build_is_stamped_and_import_builds_nothing():
    native.load_library()
    stamp = native.LIB_PATH.with_name(native.LIB_PATH.name + ".sha256")
    assert stamp.read_text().strip() == native.source_hash()
    assert native.build() == native.LIB_PATH            # up to date: no rebuild
    code = ("import dsjax_torch.audio.native as n, dsjax_torch.audio.io, dsjax_torch.server\n"
            "import sys\n"
            "assert n._lib is None\n"
            "assert not any(m == 'dsjax' or m.startswith('dsjax.') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
