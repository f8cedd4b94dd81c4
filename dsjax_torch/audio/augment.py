"""Data augmentation: SpecAugment, noise injection, tempo/gain perturbation.

A copy of dsjax/audio/augment.py (held against it by
tests/test_torch_augment.py), in two halves.

Host half, numpy on the loader's threads, the same code as dsjax's, so
the same ``np.random.Generator`` gives the same output sample for sample
(reference: loader/spec_augment.py, loader/sparse_image_warp.py,
loader/data_loader.py:97-128,377-404):

  * SpecAugment (Park et al. 2019): time warp via a polyharmonic-spline
    sparse image warp (W=5), one frequency mask (F<=27) and one time mask
    (T<=70) by default. NOTE: the reference's time_warp passes the
    spectrogram *value* at a random position as the warp coordinate (an
    upstream bug in the widely-copied SpoonRadio port,
    spec_augment.py:56-62); we use the position itself, which is what the
    SpecAugment paper specifies.
  * Noise injection: mix a random noise file section, scaled by the energy
    ratio, with probability noise_prob (data_loader.py:97-128) — sox is
    replaced by our own trim/resample (dsjax_torch.audio.io).
  * Tempo/gain perturbation: tempo in (0.85, 1.15), gain in (-6, 8) dB
    (data_loader.py:392-404) — sox is replaced by WSOLA time-stretch.

Device half, torch on any device (``data.augmentation.spec_augment_device``,
the frequency and time masks inside the training step, no time warp):
``device_mask_draws`` draws the uniforms from an explicit
``torch.Generator`` on the spectrogram's device, and ``device_masks``
applies dsjax's ``spec_augment_device`` arithmetic to them. dsjax draws
from ``jax.random.split(key, 4)``, which torch cannot reproduce, so the
tests feed jax's uniforms to ``device_masks`` and check the port's own
draws by their distribution.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from dsjax_torch.audio import io as aio
from dsjax_torch.config import AugmentationConfig, SpectConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# sparse_image_warp (numpy): polyharmonic spline -> dense flow -> bilinear
# (capability of reference loader/sparse_image_warp.py:88-410)
# ---------------------------------------------------------------------------

def _phi(r2: np.ndarray, order: int) -> np.ndarray:
    """Polyharmonic radial basis phi(r) as a function of r^2."""
    eps = 1e-10
    if order == 1:
        return np.sqrt(r2 + eps)
    if order == 2:
        return 0.5 * r2 * np.log(np.maximum(r2, eps))
    if order == 4:
        return 0.5 * np.square(r2) * np.log(np.maximum(r2, eps))
    if order % 2 == 0:
        r2 = np.maximum(r2, eps)
        return 0.5 * r2 ** (order / 2) * np.log(r2)
    return (r2 + eps) ** (order / 2)


def interpolate_spline(train_points: np.ndarray, train_values: np.ndarray,
                       query_points: np.ndarray, order: int = 2,
                       regularization: float = 0.0) -> np.ndarray:
    """Fit a polyharmonic spline f: R^2 -> R^d to (points, values) and
    evaluate at query_points. train_points (K, 2), train_values (K, d),
    query_points (Q, 2) -> (Q, d)."""
    k = train_points.shape[0]
    d = train_values.shape[1]
    c = train_points.astype(np.float64)
    f = train_values.astype(np.float64)

    r2 = np.sum((c[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    a_mat = _phi(r2, order) + regularization * np.eye(k)
    b_mat = np.concatenate([c, np.ones((k, 1))], axis=1)       # (K, 3)

    # solve [[A, B], [B^T, 0]] [w; v] = [f; 0]
    lhs = np.zeros((k + 3, k + 3))
    lhs[:k, :k] = a_mat
    lhs[:k, k:] = b_mat
    lhs[k:, :k] = b_mat.T
    rhs = np.concatenate([f, np.zeros((3, d))], axis=0)
    sol = np.linalg.lstsq(lhs, rhs, rcond=None)[0]
    w, v = sol[:k], sol[k:]

    q = query_points.astype(np.float64)
    r2q = np.sum((q[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    return _phi(r2q, order) @ w + np.concatenate([q, np.ones((len(q), 1))], axis=1) @ v


def dense_image_warp(image: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Bilinear warp: out[y, x] = image[y - flow_y, x - flow_x]."""
    h, w = image.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    qy = np.clip(yy - flow[..., 0], 0, h - 1)
    qx = np.clip(xx - flow[..., 1], 0, w - 1)
    y0 = np.floor(qy).astype(int)
    x0 = np.floor(qx).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = qy - y0
    wx = qx - x0
    return ((1 - wy) * (1 - wx) * image[y0, x0] + (1 - wy) * wx * image[y0, x1]
            + wy * (1 - wx) * image[y1, x0] + wy * wx * image[y1, x1]).astype(image.dtype)


def sparse_image_warp(image: np.ndarray, src_pts: np.ndarray, dst_pts: np.ndarray,
                      order: int = 2, regularization: float = 0.0,
                      num_boundary_points: int = 0) -> np.ndarray:
    """Warp (H, W) image so pixels at src_pts move to dst_pts."""
    h, w = image.shape
    src = src_pts.astype(np.float64)
    dst = dst_pts.astype(np.float64)
    if num_boundary_points > 0:
        ys = np.linspace(0, h - 1, num_boundary_points + 2)
        xs = np.linspace(0, w - 1, num_boundary_points + 2)
        edge = [(y, 0) for y in ys] + [(y, w - 1) for y in ys] + \
               [(0, x) for x in xs[1:-1]] + [(h - 1, x) for x in xs[1:-1]]
        edge = np.asarray(edge)
        src = np.concatenate([src, edge], axis=0)
        dst = np.concatenate([dst, edge], axis=0)
    # TF convention: flow(dst) = dst - src, and dense_image_warp samples
    # out[loc] = img[loc - flow(loc)], so out[dst] = img[src].
    flows = dst - src
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    query = np.stack([yy.ravel(), xx.ravel()], axis=1)
    dense = interpolate_spline(dst, flows, query, order, regularization)
    return dense_image_warp(image, dense.reshape(h, w, 2))


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

def time_warp(spec: np.ndarray, w_param: int = 5,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Warp the time axis by up to +-W frames around a random anchor
    (reference: spec_augment.py:48-65, with the coordinate bug fixed)."""
    rng = rng or np.random.default_rng()
    f_dim, t_dim = spec.shape
    if t_dim - w_param <= w_param:
        return spec
    y = f_dim // 2
    anchor_t = int(rng.integers(w_param, t_dim - w_param))
    dist = int(rng.integers(-w_param, w_param))
    if dist == 0:
        return spec
    src = np.array([[y, anchor_t]], np.float64)
    dst = np.array([[y, anchor_t + dist]], np.float64)
    return sparse_image_warp(spec, src, dst)


def spec_augment(spec: np.ndarray, rng: Optional[np.random.Generator] = None,
                 time_warp_w: int = 5, freq_mask_param: int = 27,
                 time_mask_param: int = 70, freq_mask_num: int = 1,
                 time_mask_num: int = 1) -> np.ndarray:
    """SpecAugment on a (F, T) spectrogram (reference: spec_augment.py:68-115)."""
    rng = rng or np.random.default_rng()
    f_dim, t_dim = spec.shape
    out = time_warp(spec, time_warp_w, rng).copy()
    for _ in range(freq_mask_num):
        f = int(rng.uniform(0.0, freq_mask_param))
        if f_dim - f < 0 or f == 0:
            continue
        f0 = int(rng.integers(0, f_dim - f + 1))
        out[f0:f0 + f, :] = 0
    for _ in range(time_mask_num):
        t = int(rng.uniform(0.0, time_mask_param))
        if t_dim - t < 0 or t == 0:
            continue
        t0 = int(rng.integers(0, t_dim - t + 1))
        out[:, t0:t0 + t] = 0
    return out


# ---------------------------------------------------------------------------
# SpecAugment masks on the device
# ---------------------------------------------------------------------------

def device_mask_draws(b: int, n_freq: int, n_time: int, generator: torch.Generator,
                      device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The four (B, n) float32 uniforms in [0, 1) that ``device_masks``
    takes: frequency mask widths and positions (n = n_freq), then time mask
    widths and positions (n = n_time), drawn on ``device`` from
    ``generator`` (which lives there) without a host sync."""
    return tuple(torch.rand((b, n), generator=generator, device=device, dtype=torch.float32)
                 for n in (n_freq, n_freq, n_time, n_time))


def _keep(u_w: Tensor, u_p: Tensor, param: int, dim: int, limit: Tensor) -> Tensor:
    """(B, dim) True where no mask covers: n masks of width floor(u_w *
    param) starting at floor(u_p * max(limit - w, 1)), dsjax's float32
    arithmetic (dsjax/audio/augment.py:191-199)."""
    w = torch.floor(u_w * param)
    pos_max = torch.clamp_min(limit[:, None] - w, 1.0)
    p0 = torch.floor(u_p * pos_max)
    idx = torch.arange(dim, device=u_w.device, dtype=torch.float32)[None, None, :]
    inside = (idx >= p0[:, :, None]) & (idx < (p0 + w)[:, :, None])
    return ~torch.any(inside, dim=1)


def device_masks(spec: Tensor, valid_frames: Tensor, u_fw: Tensor, u_fp: Tensor,
                 u_tw: Tensor, u_tp: Tensor, freq_mask_param: int = 27,
                 time_mask_param: int = 70) -> Tensor:
    """Frequency and time masks of a (B, F, T) batch from given uniforms
    (``device_mask_draws``); time masks start inside each row's
    ``valid_frames``. Deterministic: the same uniforms give dsjax's
    ``spec_augment_device`` output bit for bit, on any device."""
    b, f_dim, t_dim = spec.shape
    keep_f = _keep(u_fw, u_fp, freq_mask_param, f_dim,
                   torch.full((b,), f_dim, dtype=torch.float32, device=spec.device))
    keep_t = _keep(u_tw, u_tp, time_mask_param, t_dim, valid_frames.to(torch.float32))
    out = spec * keep_f[:, :, None].to(spec.dtype)
    return out * keep_t[:, None, :].to(spec.dtype)


def spec_augment_device(spec: Tensor, valid_frames: Tensor, generator: torch.Generator,
                        freq_mask_param: int = 27, time_mask_param: int = 70,
                        n_freq_masks: int = 1, n_time_masks: int = 1,
                        world: int = 1, rank: int = 0) -> Tensor:
    """On-device SpecAugment masks of a (B, F, T) batch, the counterpart of
    dsjax's ``spec_augment_device``: positions from ``generator``. The
    spline time warp is host-only (``time_warp``); this variant applies
    frequency and time masks only, which dominate SpecAugment's effect
    (Park et al. 2019, Table 8 ablations). With ``world`` ranks the draws
    are the global batch's (world x B rows, as dsjax draws them for its
    sharded batch from one key) and ``spec`` is row block ``rank`` of it."""
    b = spec.shape[0]
    draws = device_mask_draws(world * b, n_freq_masks, n_time_masks, generator, spec.device)
    draws = tuple(d[rank * b:(rank + 1) * b] for d in draws)
    return device_masks(spec, valid_frames, *draws, freq_mask_param=freq_mask_param,
                        time_mask_param=time_mask_param)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, global step), as dsjax
    folds the step into its key (dsjax/train/loop.py:128-137): the same
    (seed, step) gives the same masks, the next step others."""
    mixed = np.random.SeedSequence([seed % 2 ** 63, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


# ---------------------------------------------------------------------------
# Waveform augmentations
# ---------------------------------------------------------------------------

class NoiseInjector:
    """Mix random noise-file sections into utterances
    (reference: data_loader.py:97-128)."""

    def __init__(self, noise_dir: str, sample_rate: int,
                 noise_levels: Tuple[float, float] = (0.0, 0.5),
                 rng: Optional[np.random.Generator] = None):
        if not os.path.exists(noise_dir):
            raise IOError(f"noise directory not found: {noise_dir}")
        self.paths: List[str] = sorted(
            str(p) for p in Path(noise_dir).rglob("*") if p.suffix.lower() == ".wav")
        if not self.paths:
            raise IOError(f"no .wav noise files under {noise_dir}")
        self.sample_rate = sample_rate
        self.noise_levels = noise_levels
        self.rng = rng or np.random.default_rng()

    def __call__(self, data: np.ndarray) -> np.ndarray:
        path = self.paths[int(self.rng.integers(len(self.paths)))]
        level = float(self.rng.uniform(*self.noise_levels))
        return self.inject_sample(data, path, level)

    def inject_sample(self, data: np.ndarray, noise_path: str, level: float) -> np.ndarray:
        noise = aio.load_audio(noise_path, self.sample_rate)
        data_len = len(data)
        if len(noise) < data_len:
            noise = np.tile(noise, data_len // len(noise) + 1)
        start = int(self.rng.uniform(0, len(noise) - data_len)) if len(noise) > data_len else 0
        noise_dst = noise[start:start + data_len]
        noise_energy = np.sqrt(noise_dst.dot(noise_dst) / noise_dst.size) + 1e-10
        data_energy = np.sqrt(data.dot(data) / data.size)
        return (data + level * noise_dst * data_energy / noise_energy).astype(np.float32)


def random_tempo_gain(y: np.ndarray, sample_rate: int,
                      rng: Optional[np.random.Generator] = None,
                      tempo_range: Tuple[float, float] = (0.85, 1.15),
                      gain_range: Tuple[float, float] = (-6.0, 8.0)) -> np.ndarray:
    """Random tempo + gain perturbation (reference: data_loader.py:392-404)."""
    rng = rng or np.random.default_rng()
    tempo = float(rng.uniform(*tempo_range))
    gain = float(rng.uniform(*gain_range))
    y = aio.stretch_tempo(y, sample_rate, tempo)
    y = aio.apply_gain(y, gain)
    # the reference round-trips augmented audio through a 16-bit signed
    # WAV (sox "-b 16 -e si", data_loader.py:377-390), so gain above full
    # scale saturates there; clip so the host-feature and int16
    # device-feature paths see the same waveform
    return np.clip(y, -1.0, 1.0)


class AugmentPipeline:
    """Bundles the configured augmentations in reference order
    (data_loader.py:151-165): tempo/gain -> noise -> [features] -> SpecAugment."""

    def __init__(self, cfg: Optional[AugmentationConfig], spect_cfg: SpectConfig,
                 seed: int = 0):
        self.cfg = cfg or AugmentationConfig()
        self.spect_cfg = spect_cfg
        self.rng = np.random.default_rng(seed)
        self.noise = None
        if self.cfg.noise_dir:
            self.noise = NoiseInjector(self.cfg.noise_dir, spect_cfg.sample_rate,
                                       (self.cfg.noise_min, self.cfg.noise_max),
                                       rng=self.rng)

    def apply_waveform(self, y: np.ndarray) -> np.ndarray:
        if self.cfg.speed_volume_perturb:
            y = random_tempo_gain(y, self.spect_cfg.sample_rate, self.rng)
        if self.noise is not None and self.rng.random() < self.cfg.noise_prob:
            y = self.noise(y)
        return y

    def apply_spectrogram(self, spec: np.ndarray) -> np.ndarray:
        if self.cfg.spec_augment:
            spec = spec_augment(spec, self.rng)
        return spec
