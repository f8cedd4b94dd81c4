"""dsjax_torch's augmentation against dsjax's (CPU), exactly.

  * The host half (spline warp, time warp, SpecAugment, trim, gain, WSOLA
    tempo, noise injection, tempo/gain, the pipeline) is the same numpy
    code: for the same ``np.random.Generator`` both give equal arrays and
    leave their generators in equal states (the same number of draws).
  * The device masks: ``device_masks`` fed the uniforms that dsjax's
    ``spec_augment_device`` draws from ``jax.random.split(key, 4)`` gives
    its output bit for bit; the port's own draws (a torch.Generator seeded
    by (seed, step)) are checked by what they must satisfy.
  * The training set's items with augmentation on both feature routes, a
    training step with the device masks, and ``python -m
    dsjax_torch.noise_inject`` against the root ``noise_inject.py``.
"""

import itertools
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsjax import config as jax_config
from dsjax.audio import augment as jax_augment
from dsjax.audio import io as jax_io
from dsjax_torch import config
from dsjax_torch.audio import augment, io
from dsjax_torch.labels import DEFAULT_LABELS
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
UTTERANCE = int(round(1023 * 160 / SR * SR))    # 10.23 s: 1024 STFT frames


def bits(a):
    """float32 bit patterns, so -0.0 and +0.0 count as different."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def same_state(a: np.random.Generator, b: np.random.Generator):
    assert a.bit_generator.state == b.bit_generator.state


def noise_wavs(root, seed=0):
    """Noise WAVs the tests write: shorter and longer than a 1 s utterance
    at 16 kHz, and one at 8 kHz."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, n, sr in (("short", 6000, SR), ("long", 40000, SR), ("rate", 15000, 8000)):
        io.save_wav(os.path.join(root, f"{name}.wav"),
                    (0.3 * rng.standard_normal(n)).astype(np.float32), sr)
    return root


# ---------------------------------------------------------------------------
# the spline warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("boundary", [0, 2])
def test_sparse_image_warp_matches_dsjax(boundary, order):
    rng = np.random.default_rng(order + 10 * boundary)
    image = rng.standard_normal((23, 41)).astype(np.float32)
    src = np.array([[11.0, 20.0], [5.0, 7.5]])
    dst = src + rng.uniform(-3, 3, src.shape)
    got = augment.sparse_image_warp(image, src, dst, order=order,
                                    num_boundary_points=boundary)
    want = jax_augment.sparse_image_warp(image, src, dst, order=order,
                                         num_boundary_points=boundary)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))

    pts, vals, query = rng.uniform(0, 10, (5, 2)), rng.standard_normal((5, 2)), \
        rng.uniform(0, 10, (17, 2))
    np.testing.assert_array_equal(augment.interpolate_spline(pts, vals, query, order),
                                  jax_augment.interpolate_spline(pts, vals, query, order))
    flow = rng.uniform(-4, 4, (23, 41, 2))
    np.testing.assert_array_equal(bits(augment.dense_image_warp(image, flow)),
                                  bits(jax_augment.dense_image_warp(image, flow)))


# ---------------------------------------------------------------------------
# time warp and SpecAugment
# ---------------------------------------------------------------------------

def warp_draws_zero(seed, t_dim, w):
    """Whether time_warp's second draw (the distance) is 0 for this seed."""
    rng = np.random.default_rng(seed)
    rng.integers(w, t_dim - w)
    return int(rng.integers(-w, w)) == 0


@pytest.mark.parametrize("shape, w", [((161, 10), 5), ((161, 11), 5), ((40, 60), 5),
                                      ((161, 300), 5), ((20, 4), 2)])
def test_time_warp_matches_dsjax(shape, w):
    spec = np.abs(np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    for seed in range(12):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = augment.time_warp(spec, w, r1)
        want = jax_augment.time_warp(spec, w, r2)
        np.testing.assert_array_equal(bits(got), bits(want))
        same_state(r1, r2)
        if shape[1] - w <= w:   # t_dim <= 2W: returned as is, nothing drawn
            assert got is spec
            same_state(r1, np.random.default_rng(seed))
    if shape == (40, 60):
        # dist == 0 returns the input unwarped after two draws
        zero = next(s for s in range(200) if warp_draws_zero(s, shape[1], w))
        r1, r2 = np.random.default_rng(zero), np.random.default_rng(zero)
        assert augment.time_warp(spec, w, r1) is spec
        assert jax_augment.time_warp(spec, w, r2) is spec
        same_state(r1, r2)
        assert r1.bit_generator.state != np.random.default_rng(zero).bit_generator.state


@pytest.mark.parametrize("shape, kw", [
    ((161, 300), {}),
    ((161, 8), {}),                                           # t_dim <= 2W, time mask wider
    ((20, 80), {"freq_mask_param": 27}),                      # freq mask wider than F
    ((161, 120), {"freq_mask_num": 2, "time_mask_num": 3, "time_mask_param": 40}),
    ((64, 50), {"freq_mask_num": 0, "time_mask_num": 0, "time_warp_w": 2}),
])
def test_spec_augment_matches_dsjax(shape, kw):
    spec = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    for seed in range(10):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = augment.spec_augment(spec, r1, **kw)
        want = jax_augment.spec_augment(spec, r2, **kw)
        np.testing.assert_array_equal(bits(got), bits(want))
        same_state(r1, r2)


# ---------------------------------------------------------------------------
# waveform DSP and augmentations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 300, UTTERANCE], ids=["empty", "under_a_window", "10.23s"])
@pytest.mark.parametrize("tempo", [0.85, 1.0, 1.15])
def test_stretch_tempo_matches_dsjax(tempo, n):
    y = (0.2 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    got = io.stretch_tempo(y, SR, tempo)
    want = jax_io.stretch_tempo(y, SR, tempo)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("start, end", [(0.0, 0.5), (0.1234, 0.9), (-1.0, 5.0), (0.7, 0.2)])
def test_trim_and_gain_match_dsjax(start, end):
    y = np.random.default_rng(3).standard_normal(SR).astype(np.float32)
    np.testing.assert_array_equal(io.trim(y, SR, start, end), jax_io.trim(y, SR, start, end))
    for gain in (-6.0, 0.0, 3.3, 8.0):
        np.testing.assert_array_equal(bits(io.apply_gain(y, gain)),
                                      bits(jax_io.apply_gain(y, gain)))


def test_noise_injector_matches_dsjax(tmp_path):
    root = noise_wavs(str(tmp_path / "noise"))
    port = augment.NoiseInjector(root, SR, (0.1, 0.6), rng=np.random.default_rng(5))
    ref = jax_augment.NoiseInjector(root, SR, (0.1, 0.6), rng=np.random.default_rng(5))
    assert [os.path.basename(p) for p in port.paths] == ["long.wav", "rate.wav", "short.wav"]
    assert port.paths == ref.paths
    y = (0.1 * np.random.default_rng(6).standard_normal(SR)).astype(np.float32)
    for _ in range(12):
        np.testing.assert_array_equal(bits(port(y)), bits(ref(y)))
        same_state(port.rng, ref.rng)
    for path in port.paths:   # shorter (tiled), longer (a random start), 8 kHz
        np.testing.assert_array_equal(bits(port.inject_sample(y, path, 0.4)),
                                      bits(ref.inject_sample(y, path, 0.4)))
        same_state(port.rng, ref.rng)
    with pytest.raises(IOError):
        augment.NoiseInjector(str(tmp_path / "missing"), SR)


def test_random_tempo_gain_matches_dsjax():
    y = (0.5 * np.random.default_rng(7).standard_normal(8000)).astype(np.float32)
    for seed in range(8):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = augment.random_tempo_gain(y, SR, r1)
        want = jax_augment.random_tempo_gain(y, SR, r2)
        assert np.abs(got).max() <= 1.0
        np.testing.assert_array_equal(bits(got), bits(want))
        same_state(r1, r2)


@pytest.mark.parametrize("speed, noise, spec", list(itertools.product([False, True], repeat=3)))
def test_augment_pipeline_matches_dsjax(tmp_path, speed, noise, spec):
    root = noise_wavs(str(tmp_path / "noise")) if noise else ""
    flags = dict(speed_volume_perturb=speed, noise_dir=root, spec_augment=spec,
                 noise_prob=0.5)
    port = augment.AugmentPipeline(config.AugmentationConfig(**flags), config.SpectConfig(),
                                   seed=11)
    ref = jax_augment.AugmentPipeline(jax_config.AugmentationConfig(**flags),
                                      jax_config.SpectConfig(), seed=11)
    rng = np.random.default_rng(12)
    for _ in range(20):
        y = (0.2 * rng.standard_normal(int(rng.integers(2000, 9000)))).astype(np.float32)
        got, want = port.apply_waveform(y), ref.apply_waveform(y)
        np.testing.assert_array_equal(bits(got), bits(want))
        spec_in = rng.standard_normal((161, int(rng.integers(5, 60)))).astype(np.float32)
        np.testing.assert_array_equal(bits(port.apply_spectrogram(spec_in)),
                                      bits(ref.apply_spectrogram(spec_in)))
        same_state(port.rng, ref.rng)


# ---------------------------------------------------------------------------
# the device masks
# ---------------------------------------------------------------------------

def jax_uniforms(key, b, n_f, n_t):
    """The four uniforms dsjax's spec_augment_device draws
    (dsjax/audio/augment.py:188-199)."""
    keys = jax.random.split(key, 4)
    return [np.array(jax.random.uniform(k, (b, n)))
            for k, n in zip(keys, (n_f, n_f, n_t, n_t))]


@pytest.mark.parametrize("b, f_dim, t_dim, n_f, n_t, fp, tp, valid", [
    (3, 64, 100, 1, 1, 20, 30, [100, 60, 100]),
    (4, 161, 257, 1, 1, 27, 70, [257, 1, 69, 12]),       # a 1-frame row, rows under tp
    (2, 161, 40, 2, 3, 27, 70, [40, 33]),                # every row under the mask param
    (5, 13, 9, 0, 2, 27, 5, [9, 1, 2, 3, 9]),            # no freq mask, F under fp
    (6, 161, 1024, 3, 0, 80, 70, [1024, 1000, 512, 77, 70, 2]),
])
def test_device_masks_match_dsjax(b, f_dim, t_dim, n_f, n_t, fp, tp, valid):
    rng = np.random.default_rng(b * 100 + t_dim)
    spec = rng.standard_normal((b, f_dim, t_dim)).astype(np.float32)
    valid = np.asarray(valid, np.int32)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_augment.spec_augment_device(
            jnp.asarray(spec), jnp.asarray(valid), key, freq_mask_param=fp,
            time_mask_param=tp, n_freq_masks=n_f, n_time_masks=n_t))
        u = [torch.from_numpy(a) for a in jax_uniforms(key, b, n_f, n_t)]
        got = augment.device_masks(torch.from_numpy(spec), torch.from_numpy(valid), *u,
                                   freq_mask_param=fp, time_mask_param=tp)
        assert got.dtype == torch.float32 and got.shape == spec.shape
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def bands(keep):
    """[(start, stop)] of the masked (False) runs of a 1-D keep vector."""
    edges = np.flatnonzero(np.diff(np.concatenate([[1], keep.astype(int), [1]])))
    return list(zip(edges[::2], edges[1::2]))


def test_device_mask_draws_by_seed_and_step():
    b, f_dim, t_dim, fp, tp = 10000, 161, 300, 27, 70
    draws = augment.device_mask_draws(b, 1, 1, augment.step_generator(7, 3, "cpu"), "cpu")
    again = augment.device_mask_draws(b, 1, 1, augment.step_generator(7, 3, "cpu"), "cpu")
    later = augment.device_mask_draws(b, 1, 1, augment.step_generator(7, 4, "cpu"), "cpu")
    other = augment.device_mask_draws(b, 1, 1, augment.step_generator(8, 3, "cpu"), "cpu")
    for u, v, w, x in zip(draws, again, later, other):
        assert u.dtype == torch.float32 and u.shape == (b, 1)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert torch.equal(u, v) and not torch.equal(u, w) and not torch.equal(u, x)

    valid = torch.from_numpy(np.random.default_rng(0).integers(1, t_dim + 1, b)
                             .astype(np.int32))
    out = augment.device_masks(torch.ones((b, f_dim, t_dim)), valid, *draws,
                               freq_mask_param=fp, time_mask_param=tp)
    # no band covers a whole axis (27 < 161 rows, 70 < 300 frames)
    keep_f, keep_t = (out != 0).any(dim=2).numpy(), (out != 0).any(dim=1).numpy()
    widths = {"f": [], "t": []}
    for i in range(0, b, 97):                       # every band of a sample of rows
        for axis, keep, limit in (("f", keep_f[i], f_dim), ("t", keep_t[i], int(valid[i]))):
            runs = bands(keep)
            assert len(runs) <= 1
            for start, stop in runs:
                assert 0 <= start < limit and stop <= (f_dim if axis == "f" else t_dim)
    for axis, (u_w, param) in (("f", (draws[0], fp)), ("t", (draws[2], tp))):
        w = np.floor(u_w.numpy() * np.float32(param))
        mean, se = w.mean(), np.sqrt((param ** 2 - 1) / 12 / w.size)
        assert abs(mean - (param - 1) / 2) < 4 * se, (axis, mean)
        assert w.min() == 0 and w.max() == param - 1
    # the masked widths are the drawn ones where the band fits inside the row
    w_f = np.floor(draws[0].numpy()[:, 0] * np.float32(fp)).astype(int)
    np.testing.assert_array_equal((~keep_f).sum(axis=1), w_f)


# ---------------------------------------------------------------------------
# the training set and the training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["host_features", "device_features"])
def test_dataset_items_with_augmentation_match_dsjax(tmp_path, route):
    from dsjax.data.dataset import SpectrogramDataset as JaxDataset
    from dsjax_torch.data.dataset import SpectrogramDataset

    path = write_manifest(str(tmp_path), "aug", [1.0, 0.4, 1.3, 0.05, 0.8], seed=21)
    flags = dict(speed_volume_perturb=True, noise_dir=noise_wavs(str(tmp_path / "noise")),
                 noise_prob=0.7, noise_max=20.0, spec_augment=True,
                 spec_augment_device=route == "device_features")
    port = SpectrogramDataset(config.SpectConfig(), path, DEFAULT_LABELS,
                              aug_cfg=config.AugmentationConfig(**flags), seed=5,
                              device_features=True)
    ref = JaxDataset(jax_config.SpectConfig(), path, DEFAULT_LABELS,
                     aug_cfg=jax_config.AugmentationConfig(**flags), seed=5,
                     device_features=True)
    # host SpecAugment forces host features; its device variant keeps raw audio
    assert port.device_features == ref.device_features == (route == "device_features")
    clipped = 0
    for _ in range(2):
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got[0].dtype == want[0].dtype
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            if route == "device_features":
                clipped += int(np.abs(got[0].astype(np.int32)).max() >= 32767)
    same_state(port.augment.rng, ref.augment.rng)
    if route == "device_features":   # loud noise exceeds full scale: the peak rescale ran
        assert clipped > 0


def test_train_step_with_device_masks_equals_step_on_masked_features(tmp_path):
    """A raw-audio step with spec_augment_device equals a host-feature step
    on the spectrogram masked beforehand from the same (seed, step) draws,
    and the trainer warns that the device variant has no time warp."""
    from dsjax_torch import workflows
    from dsjax_torch.audio.features import spectrogram_torch
    from dsjax_torch.data.dataset import Batch
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [1.0, 0.9, 0.7], seed=8)
    base = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=3",
            "data.num_workers=1", "model.hidden_size=16", "model.hidden_layers=2",
            "model=unidirectional", "model.rnn_type=gru", "model.lookahead_context=3",
            "trainer.precision=32", "trainer.device=cpu", "seed=9"]
    aug = ["data.device_features=true", "data.augmentation.spec_augment=true",
           "data.augmentation.spec_augment_device=true"]
    cfg = config.compose(config.TrainConfig, base + aug)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(cfg, list(DEFAULT_LABELS))
    assert any("time warp" in str(w.message) for w in caught)
    plain_cfg = config.compose(config.TrainConfig, base + ["data.device_features=false"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain = Trainer(plain_cfg, list(DEFAULT_LABELS))
    assert not any("time warp" in str(w.message) for w in caught)

    batch = next(iter(workflows._pipelines(cfg, list(DEFAULT_LABELS))[0]))
    assert batch.inputs is None and batch.audio.dtype == np.int16
    lengths = torch.from_numpy(batch.input_lengths)
    feats = spectrogram_torch(torch.from_numpy(batch.audio), lengths, cfg.data.spect,
                              normalize=True)
    results = []
    for step in (0, 4):
        draws = augment.device_mask_draws(batch.size, 1, 1,
                                          augment.step_generator(cfg.seed, step, "cpu"), "cpu")
        masked = augment.device_masks(feats, lengths, *draws)
        assert int((masked == 0).sum()) > int((feats == 0).sum())
        host = Batch(masked.numpy(), batch.input_lengths, batch.targets, batch.target_lengths,
                     batch.input_percentages, valid=batch.valid)
        state, want_state = trainer.init_state(seed=0), plain.init_state(seed=0)
        state.step = want_state.step = step
        grads, loss = trainer.grad_step(state, batch)
        want_grads, want_loss = plain.grad_step(want_state, host)
        assert float(loss) == float(want_loss)
        for name, g in grads.items():
            torch.testing.assert_close(g, want_grads[name], rtol=0, atol=0, msg=name)
        results.append(float(loss))
    assert results[0] != results[1]   # another step, other masks


def test_noise_inject_module_matches_root_script(tmp_path):
    rng = np.random.default_rng(13)
    clean = str(tmp_path / "clean.wav")
    io.save_wav(clean, (0.2 * rng.standard_normal(12000)).astype(np.float32), SR)
    noise_dir = tmp_path / "noise"
    noise_dir.mkdir()
    # as long as the input once resampled, so the unseeded start is 0 (a
    # shorter noise is tiled past the input's length, then cut at random)
    noise = str(noise_dir / "hum.wav")
    io.save_wav(noise, (0.3 * rng.standard_normal(6000)).astype(np.float32), 8000)
    outs = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for name, cmd in (("root", [os.path.join(ROOT, "noise_inject.py")]),
                      ("port", ["-m", "dsjax_torch.noise_inject"])):
        outs[name] = str(tmp_path / f"{name}.wav")
        out = subprocess.run([sys.executable, *cmd, "--input-path", clean, "--noise-path", noise,
                              "--output-path", outs[name], "--noise-level", "0.35"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert f"Saved noise-injected audio to {outs[name]}" in out.stdout
    with open(outs["root"], "rb") as a, open(outs["port"], "rb") as b:
        assert a.read() == b.read()
