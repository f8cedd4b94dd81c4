"""dsjax_torch's host frontend, greedy decoder, labels and config against dsjax's.

The port carries copies of dsjax's host code (it imports nothing of the JAX
package but its native audio decoders); these tests hold each copy against
its original on the same inputs. The numpy paths are the same arithmetic, so
features and audio compare exactly.
"""

import dataclasses
import json
import typing

import numpy as np
import pytest
import torch

from dsjax.audio import features as jax_features
from dsjax.audio import io as jax_io
from dsjax import config as jax_config
from dsjax import labels as jax_labels
from dsjax.decode.greedy import GreedyDecoder as JaxGreedyDecoder
from dsjax.labels import DEFAULT_LABELS
from dsjax_torch import config, labels
from dsjax_torch.audio import features, io
from dsjax_torch.decode.greedy import GreedyDecoder


def signal(seed, n, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 159, 160, 4000, 16001])
@pytest.mark.parametrize("normalize", [True, False])
def test_spectrogram_matches_dsjax(n, normalize):
    cfg = config.SpectConfig()
    y = signal(n, n)
    want = jax_features.spectrogram_np(y, cfg, normalize)
    got = features.spectrogram_np(y, cfg, normalize)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(features.FeatureExtractor(cfg, normalize)(y),
                                  jax_features.FeatureExtractor(cfg, normalize)(y))


@pytest.mark.parametrize("window", list(config.SpectrogramWindow))
def test_stft_helpers_match_dsjax(window):
    cfg = config.SpectConfig(sample_rate=8000, window_size=0.025, window_stride=0.01,
                             window=window)
    assert features.stft_params(cfg) == jax_features.stft_params(cfg)
    np.testing.assert_array_equal(features.periodic_window(window, 200),
                                  jax_features.periodic_window(window, 200))
    assert features.num_frames(12345, 80) == jax_features.num_frames(12345, 80)


@pytest.mark.parametrize("chunk", [-1.0, 0.5, 1.0, 2.5])
def test_chunks_match_dsjax(chunk):
    cfg = config.SpectConfig()
    y = signal(1, 16000 * 3 + 1234)
    got = list(features.FeatureExtractor(cfg).chunks(y, chunk))
    want = list(jax_features.FeatureExtractor(cfg).chunks(y, chunk))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_wav_io_matches_dsjax(tmp_path):
    y = signal(2, 8000)
    stereo = np.stack([y, -0.5 * y])
    for name, data in (("mono", y), ("stereo", stereo)):
        port_path, jax_path = str(tmp_path / f"p_{name}.wav"), str(tmp_path / f"j_{name}.wav")
        io.save_wav(port_path, data, 16000)
        jax_io.save_wav(jax_path, data, 16000)
        assert open(port_path, "rb").read() == open(jax_path, "rb").read()
        x, sr = io.read_wav(port_path)
        xj, srj = jax_io.read_wav(port_path)
        assert sr == srj == 16000
        np.testing.assert_array_equal(x, xj)
        for target in (None, 16000, 8000, 22050):
            np.testing.assert_array_equal(io.load_audio(port_path, target),
                                          jax_io.load_audio(port_path, target))
    np.testing.assert_array_equal(io.resample(y, 16000, 12000),
                                  jax_io.resample(y, 16000, 12000))


def test_greedy_decoder_matches_dsjax():
    rng = np.random.default_rng(3)
    b, t, c = 5, 40, len(DEFAULT_LABELS)
    # few distinct labels so repeats and blanks between repeats both occur
    ids = rng.choice([0, 0, 1, 5, 5, 28, 9], size=(b, t))
    probs = rng.random((b, t, c)).astype(np.float32) * 0.5
    np.put_along_axis(probs, ids[..., None], 1.0, axis=-1)
    sizes = np.array([40, 33, 1, 0, 17], np.int32)
    want = JaxGreedyDecoder(DEFAULT_LABELS).decode(probs, sizes)
    dec = GreedyDecoder(DEFAULT_LABELS)
    for got in (dec.decode(probs, sizes), dec.decode(torch.from_numpy(probs),
                                                     torch.from_numpy(sizes))):
        assert got[0] == want[0]
        for a, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(a[0], w[0])
            assert a[0].dtype == w[0].dtype
    full = dec.decode(probs)
    assert full[0] == JaxGreedyDecoder(DEFAULT_LABELS).decode(probs)[0]
    assert any(s[0] for s in full[0])


def plain(cfg):
    """A config tree as nested dicts of plain values (enums by value), so
    the port's copies compare with dsjax's classes."""
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=lambda e: e.value))


def test_server_config_extends_dsjax_config():
    """The port's ServerConfig is dsjax's, field for field, plus `device`."""
    port_fields = [f.name for f in dataclasses.fields(config.ServerConfig)]
    jax_fields = [f.name for f in dataclasses.fields(jax_config.ServerConfig)]
    assert port_fields == jax_fields + ["device"]
    port = plain(config.ServerConfig())
    assert port.pop("device") == "cuda"
    assert port == plain(jax_config.ServerConfig())
    cfg = config.compose(config.ServerConfig, ["model.model_path=m.pt", "port=0",
                                               "device=cpu", "max_batch=4"])
    assert (cfg.model.model_path, cfg.port, cfg.device, cfg.max_batch) == ("m.pt", 0, "cpu", 4)


@pytest.mark.parametrize("name", ["SpectConfig", "BiDirectionalConfig", "UniDirectionalConfig",
                                  "LMConfig", "ModelLoadConfig", "InferenceConfig"])
def test_config_copy_matches_dsjax(name):
    port_cls, jax_cls = getattr(config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(port_cls)]
            == [f.name for f in dataclasses.fields(jax_cls)])
    port_types = typing.get_type_hints(port_cls)
    jax_types = typing.get_type_hints(jax_cls)
    assert {k: getattr(t, "__name__", str(t)) for k, t in port_types.items()} == \
        {k: getattr(t, "__name__", str(t)) for k, t in jax_types.items()}
    assert plain(port_cls()) == plain(jax_cls())


@pytest.mark.parametrize("name", ["DecoderType", "SpectrogramWindow", "RNNType"])
def test_config_enums_match_dsjax(name):
    assert ([(m.name, m.value) for m in getattr(config, name)]
            == [(m.name, m.value) for m in getattr(jax_config, name)])


@pytest.mark.parametrize("argv", [
    ["model.model_path=m.pt", "port=0", "max_batch=4"],
    ["batch_timeout_ms=5", "warmup_seconds=0", "chunk_size_seconds=2.5", "+host=127.0.0.1"],
    ["lm.decoder_type=beam", "lm.alpha=0.5", "lm.beam_width=16", "lm.device_beam=true",
     "model.precision=16"],
    ["lm.device_beam=off", "lm.cutoff_prob=1e-3", "lm.cutoff_top_n=0x10",
     "stream_session_ttl=-1", "lm.lm_path=null", "model.model_path='a b.pt'"],
    ["lm.top_paths=1_0", "lm.beta=.5", "lm.alpha=-1.5e+2", "model.model_path=yes",
     "host=~", "port=010"],
])
def test_compose_matches_dsjax(argv):
    """The same command line gives the same config in both packages (YAML's
    scalar rules, implemented in the port without PyYAML)."""
    port = plain(config.compose(config.ServerConfig, argv))
    assert port.pop("device") == "cuda"
    assert port == plain(jax_config.compose(jax_config.ServerConfig, argv))


def test_compose_overlay_and_errors_match_dsjax(tmp_path):
    overlay = tmp_path / "serve.yaml"
    overlay.write_text("max_batch: 2\nmodel:\n  precision: 16\n  model_path: x.pt\n"
                       "lm:\n  beam_width: 3\n")
    argv = [f"configs={overlay}", "max_batch=4"]
    port = plain(config.compose(config.ServerConfig, argv))
    port.pop("device")
    assert port == plain(jax_config.compose(jax_config.ServerConfig, argv))
    for bad in (["nope=1"], ["model.nope=1"], ["lm.alpha.x=1"]):
        with pytest.raises(KeyError):
            jax_config.compose(jax_config.ServerConfig, bad)
        with pytest.raises(KeyError):
            config.compose(config.ServerConfig, bad)


def test_labels_copy_matches_dsjax():
    assert labels.DEFAULT_LABELS == jax_labels.DEFAULT_LABELS
    assert labels.BLANK_INDEX == jax_labels.BLANK_INDEX
    for alphabet in (DEFAULT_LABELS, ["_", "A", "B"]):
        port, ref = labels.LabelMap(alphabet), jax_labels.LabelMap(alphabet)
        assert (len(port), port.space_index, port.blank_index, port.char_to_int) == \
            (len(ref), ref.space_index, ref.blank_index, ref.char_to_int)
        assert port.encode("AB Z'q") == ref.encode("AB Z'q")
        assert port.decode([2, 1, 0]) == ref.decode([2, 1, 0])


# ---------------------------------------------------------------------------
# the device half: raw-audio prep, the batched STFT, raw-audio batches
# ---------------------------------------------------------------------------

# float32 FFTs (pocketfft under XLA, torch's on the CPU) and sums in other
# orders: features of magnitude up to 7.8 differ by a few ulps (measured up
# to 6.6e-6 normalized, 2.4e-6 unnormalized)
SPECT_ATOL = 2e-5


def raw_batch(lengths, int16, cfg):
    """Raw audio prepared as both packages' datasets prepare it."""
    ys = [signal(100 + i, n) for i, n in enumerate(lengths)]
    items = [jax_features.pad_audio_for_device(y, cfg) for y in ys]
    n_valid = np.array([n for _, n in items], np.int32)
    max_t = int(n_valid.max()) + 5
    batch = np.zeros((len(ys), (max_t + 1) * features.stft_params(cfg)[1]), np.float32)
    for i, y in enumerate(ys):
        yp, _ = jax_features.pad_audio_for_device(y, cfg, max_t)
        batch[i] = yp
    if int16:
        batch = np.clip(np.rint(batch * 32768.0), -32768, 32767).astype(np.int16)
    return batch, n_valid


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
@pytest.mark.parametrize("normalize", [True, False])
def test_device_spectrogram_matches_dsjax(int16, normalize):
    import jax.numpy as jnp

    cfg = config.SpectConfig()
    batch, n_valid = raw_batch([4000, 16001, 160, 9000], int16, cfg)
    want = np.asarray(jax_features.spectrogram_jax(jnp.asarray(batch), jnp.asarray(n_valid),
                                                   cfg, normalize))
    got = features.spectrogram_torch(torch.from_numpy(batch), torch.from_numpy(n_valid), cfg,
                                     normalize)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=SPECT_ATOL, rtol=0)
    # zero past each utterance's valid frames, exactly
    for i, n in enumerate(n_valid):
        assert not got[i, :, n:].any()
    np.testing.assert_allclose(features.FeatureExtractor(cfg, normalize).batch(
        torch.from_numpy(batch), torch.from_numpy(n_valid)).numpy(), want, atol=SPECT_ATOL,
        rtol=0)


def test_device_spectrogram_matches_the_host_path():
    """On one unpadded float utterance the device path is the host STFT."""
    cfg = config.SpectConfig()
    y = signal(7, 12345)
    yp, n = features.pad_audio_for_device(y, cfg)
    got = features.spectrogram_torch(torch.from_numpy(yp[None]), torch.tensor([n]), cfg)[0]
    np.testing.assert_allclose(got.numpy(), features.spectrogram_np(y, cfg), atol=SPECT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("n,pad_to", [(1, None), (159, None), (160, 3), (16001, None),
                                      (4000, 40), (4000, 26)])
def test_pad_audio_for_device_matches_dsjax(n, pad_to):
    cfg = config.SpectConfig()
    y = signal(n, n)
    got = features.pad_audio_for_device(y, cfg, pad_to)
    want = jax_features.pad_audio_for_device(y, cfg, pad_to)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype


def test_raw_audio_dataset_and_collate_match_dsjax(tmp_path):
    from dsjax.data.dataset import SpectrogramDataset as JaxDataset
    from dsjax.data.dataset import collate_audio as jax_collate_audio
    from dsjax_torch.data.dataset import SpectrogramDataset, collate_audio
    from tests.synthetic_manifest import write_manifest

    cfg = config.SpectConfig()
    path = write_manifest(str(tmp_path), "raw", [0.3, 1.25, 0.71, 0.02], seed=9)
    port = SpectrogramDataset(cfg, path, DEFAULT_LABELS, device_features=True)
    ref = JaxDataset(jax_config.SpectConfig(), path, DEFAULT_LABELS, device_features=True)
    items = []
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert got[0].dtype == want[0].dtype == np.int16
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        assert port.frame_count(i) == ref.frame_count(i) == got[1]
        items.append(got)
    for bucket_frames, pad_to in ((1, None), (64, 6)):
        got = collate_audio(items, port.extractor.hop, bucket_frames, 8, pad_to)
        want = jax_collate_audio(items, ref.extractor.hop, bucket_frames, 8, pad_to)
        assert got.inputs is None and got.size == want.size
        for name in ("audio", "input_lengths", "targets", "target_lengths",
                     "input_percentages", "valid"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("name", ["EvalConfig", "TranscribeConfig"])
def test_eval_and_transcribe_configs_extend_dsjax(name):
    """dsjax's fields and defaults, without EvalConfig.save_output (read by
    nothing) and with `device`; the same command lines parse alike."""
    port_cls, jax_cls = getattr(config, name), getattr(jax_config, name)
    jax_fields = [f.name for f in dataclasses.fields(jax_cls) if f.name != "save_output"]
    assert [f.name for f in dataclasses.fields(port_cls)] == jax_fields + ["device"]
    port, want = plain(port_cls()), plain(jax_cls())
    want.pop("save_output", None)
    assert port.pop("device") == "cuda"
    assert port == want
    argv = ["model.model_path=m.pt", "lm.decoder_type=beam", "lm.beam_width=4",
            "lm.top_paths=2", "model.precision=16"]
    got = plain(config.compose(port_cls, argv + ["device=cpu"]))
    want = plain(jax_config.compose(jax_cls, argv))
    want.pop("save_output", None)
    assert got.pop("device") == "cpu"
    assert got == want
