"""Workflow layer: training, evaluation and transcription, the
counterpart of dsjax/workflows.py (reference:
deepspeech_pytorch/{training,testing,inference}.py).

  * ``train`` takes a composed ``TrainConfig`` and wires the data pipelines,
    the trainer, checkpoints and metrics logging
    (``python -m dsjax_torch.train key=value ...``); under torchrun
    (``python -m torch.distributed.run --nproc_per_node N -m
    dsjax_torch.train ...``) it first joins the process group and each rank
    trains on its own card and its data index's share of the batches
    (``trainer.mesh_model`` > 1 shards the recurrent and head weights over
    each group of that many ranks, which load the same batches);
  * ``evaluate`` takes an ``EvalConfig`` and prints WER/CER over a manifest
    (``python -m dsjax_torch.evaluate ...``), in one process over every
    replica of the bundle (every visible card by default);
  * ``transcribe`` takes a ``TranscribeConfig`` and prints the result JSON
    of one file (``python -m dsjax_torch.transcribe ...``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dsjax_torch.audio.features import stft_params
from dsjax_torch.config import EvalConfig, LogMelConfig, TrainConfig, TranscribeConfig
from dsjax_torch.data.dataset import SpectrogramDataset
from dsjax_torch.data.loader import DataPipeline, DevicePrefetcher, stage
from dsjax_torch.data.sampler import (BucketBatchSampler, DistributedBucketSampler,
                                      DistributedOrderedSampler, OrderedBatchSampler)
from dsjax_torch.inference import decode_results, load_decoder, load_model, run_transcribe
from dsjax_torch.labels import load_labels
from dsjax_torch.ops import _build
from dsjax_torch.parallel import distributed
from dsjax_torch.parallel.mesh import data_coords
from dsjax_torch.train.checkpoint import CheckpointHandler, restore_from_path
from dsjax_torch.train.loop import Trainer
from dsjax_torch.train.metrics import CharErrorRate, WordErrorRate, update_batch
from dsjax_torch.train.state import TrainState


def _pipelines(cfg: TrainConfig, labels: List[str]) -> Tuple[DataPipeline, DataPipeline]:
    train_ds = SpectrogramDataset(cfg.data.spect, cfg.data.train_path, labels,
                                  normalize=True, aug_cfg=cfg.data.augmentation,
                                  seed=cfg.seed, device_features=cfg.data.device_features)
    val_ds = SpectrogramDataset(cfg.data.spect, cfg.data.val_path, labels,
                                normalize=True, device_features=cfg.data.device_features)
    # one share of the bins a data index: the ranks of a model group load
    # the same bins (trainer.mesh_model, parallel/mesh.py)
    dp, index = data_coords(cfg.trainer.mesh_model)
    if dp > 1:
        train_sampler = DistributedBucketSampler(len(train_ds), cfg.data.batch_size,
                                                 seed=cfg.seed, num_replicas=dp, rank=index)
        val_sampler = DistributedOrderedSampler(len(val_ds), cfg.data.batch_size,
                                                seed=cfg.seed, num_replicas=dp, rank=index)
    else:
        train_sampler = BucketBatchSampler(len(train_ds), cfg.data.batch_size, seed=cfg.seed)
        val_sampler = OrderedBatchSampler(len(val_ds), cfg.data.batch_size, seed=cfg.seed)

    def mk(ds, sampler, split):
        return DataPipeline(ds, sampler, bucket_frames=cfg.data.bucket_frames,
                            bucket_labels=cfg.data.bucket_labels,
                            num_workers=cfg.data.num_workers,
                            prefetch=cfg.data.prefetch_batches,
                            pad_to_batch=cfg.data.batch_size, ragged_split=split)

    return mk(train_ds, train_sampler, cfg.data.ragged_split), mk(val_ds, val_sampler, 1)


def train(cfg: TrainConfig) -> TrainState:
    """Full training workflow (reference: training.py:13-47). Returns the
    final state. Under torchrun's environment it joins the process group
    before any device use and leaves it when training ends or fails."""
    # replaces the reference's TorchElastic rendezvous; a no-op without it
    joined = distributed.initialize(cfg.trainer.device)
    try:
        return _train(cfg)
    finally:
        if joined:
            distributed.destroy()


def _train(cfg: TrainConfig) -> TrainState:
    np.random.seed(cfg.seed % (2 ** 32))
    labels = load_labels(cfg.data.labels_path if os.path.isfile(cfg.data.labels_path)
                         else None)
    trainer = Trainer(cfg, labels)
    if distributed.active() and trainer.device.type == "cuda":
        # one nvcc build a node: its local rank 0 builds, the others wait
        if distributed.local_rank() == 0:
            _build.build()
        distributed.barrier()
    ckpt_dir = cfg.checkpoint.dirpath or os.path.join(os.getcwd(), "checkpoints")
    handler = CheckpointHandler(ckpt_dir, monitor=cfg.checkpoint.monitor,
                                save_top_k=cfg.checkpoint.save_top_k,
                                save_last=cfg.checkpoint.save_last,
                                cfg=cfg, labels=labels, verbose=cfg.checkpoint.verbose)
    state = trainer.init_state()
    resume_extra: Dict[str, Any] = {}
    # auto-resume WINS over an explicit resume_from_checkpoint when the
    # run's own dirpath already holds a checkpoint (reference
    # training.py:24-27 overwrites resume_from_checkpoint the same way): a
    # relaunched fine-tune continues from ITS latest save, not from the
    # original warm-start point
    auto = cfg.load_auto_checkpoint and handler.latest_step() is not None
    if auto:
        state = handler.restore(state)
        resume_extra = handler.restore_extra()
        print(f"auto-resumed from step {state.step}")
    elif cfg.trainer.resume_from_checkpoint:
        state, resume_extra = restore_from_path(cfg.trainer.resume_from_checkpoint, state)
        print(f"resumed from {cfg.trainer.resume_from_checkpoint} at step {state.step}")
    train_pipe, val_pipe = _pipelines(cfg, labels)
    if resume_extra.get("start_index"):
        # mid-epoch resume: skip the bins already consumed this epoch
        train_pipe.sampler.start_index = int(resume_extra["start_index"])
    metrics_logger = None
    # rank 0 only: the logged loss and WER/CER are already reduced over ranks
    if cfg.trainer.log_dir and distributed.is_main_process():
        from dsjax_torch.train.logging import MetricsLogger

        metrics_logger = MetricsLogger(cfg.trainer.log_dir)
        print(f"logging metrics to {metrics_logger.path}")
    try:
        return trainer.fit(train_pipe, val_pipe, checkpoint_handler=handler, state=state,
                           metrics_logger=metrics_logger)
    finally:
        if metrics_logger is not None:
            metrics_logger.close()


def evaluate(cfg: EvalConfig) -> Tuple[float, float]:
    """Evaluation workflow (reference: testing.py:12-50). Returns (wer, cer).

    Samples load on a thread pool while the device runs the previous batch;
    the batch dimension is padded to ``batch_size`` rounded up to a multiple
    of the bundle's replicas (dsjax/workflows.py:200-205), so every batch
    takes the data-parallel forward over them; batch k+1's copy to the first
    device is staged ahead (DevicePrefetcher; the forward copies each
    shard on to its card from there) and its forward is issued before batch
    k is decoded. k's decode is queued behind that forward on the same
    stream, so the host waits for both (the device beam search's
    ``beam.fetch`` span, ``dsjax_torch.trace``) and then builds k's
    strings, the reference strings and the WER update (``beam.strings``,
    ``greedy.strings``, ``eval.score``) while the device has no work
    queued: the host's string building does not overlap a forward."""
    bundle = load_model(cfg.model.model_path, cfg.model.precision, cfg.device,
                        cfg.num_cpu_devices)
    decoder = load_decoder(bundle.labels, cfg.lm)
    target_decoder = load_decoder(bundle.labels, type(cfg.lm)())  # greedy
    dev_feats = cfg.device_features
    if dev_feats:
        n_fft, hop, _ = stft_params(bundle.spect_cfg)
        # the linear spectrogram's device framing assumes 50% window overlap;
        # the log-mel front end frames any layout
        if n_fft != 2 * hop and not isinstance(bundle.spect_cfg, LogMelConfig):
            print("device_features disabled: window overlap != 50%")
            dev_feats = False
    ds = SpectrogramDataset(bundle.spect_cfg, cfg.test_path, bundle.labels,
                            normalize=True, device_features=dev_feats)
    sampler = OrderedBatchSampler(len(ds), cfg.batch_size)
    n_rep = len(bundle.devices)
    pipe = DataPipeline(ds, sampler, bucket_frames=64, bucket_labels=64,
                        num_workers=cfg.num_workers, prefetch=2,
                        pad_to_batch=-(-cfg.batch_size // n_rep) * n_rep)
    wer, cer = WordErrorRate(), CharErrorRate()
    copy_stream = torch.cuda.Stream(bundle.device) if bundle.device.type == "cuda" else None

    def finish(pending) -> int:
        probs, out_lens, batch = pending
        n_real = int(batch.valid_mask.sum()) or batch.size
        # the full padded batch decodes on the device (pad rows decode to
        # ""); n_best=1: WER needs only the top hypothesis, so the beam
        # backtracks one char stream per utterance
        decoded, _ = decoder.decode(probs, out_lens, n_best=1)
        refs = target_decoder.convert_to_strings(
            [batch.targets[b, :batch.target_lengths[b]] for b in range(n_real)])
        transcripts = [d[0] for d in decoded[:n_real]]
        references = [r[0] for r in refs]
        update_batch(wer, cer, transcripts, references)
        if cfg.verbose:
            for t, r in zip(transcripts, references):
                print(f"Ref:  {r}\nHyp:  {t}\n")
        return n_real

    def stage_batch(batch):
        x = batch.inputs if batch.inputs is not None else batch.audio
        return stage((x, batch.input_lengths.astype(np.int32)), bundle.device, copy_stream)

    t0 = time.time()
    n_utts = 0
    pending = None  # (posteriors, out_lens, batch): decoded after the next forward
    t_warm = None   # when the first batch finished: before it, first-use work
    n_warm = 0
    for batch, staged in DevicePrefetcher(pipe, stage_batch):
        x, lens = staged.wait(bundle.device)
        probs, out_lens, _ = bundle.forward(x, lens)
        if pending is not None:
            n_utts += finish(pending)
            if t_warm is None:
                t_warm, n_warm = time.time(), n_utts
        pending = (probs, out_lens, batch)
    if pending is not None:
        n_utts += finish(pending)
        if t_warm is None:
            t_warm, n_warm = time.time(), n_utts
    t_end = time.time()
    dt = max(t_end - t0, 1e-9)
    w, c = wer.compute(), cer.compute()
    steady = ""
    if t_warm is not None and n_utts > n_warm and t_end > t_warm:
        steady = (f", {(n_utts - n_warm) / (t_end - t_warm):.1f} utt/s "
                  f"steady past warmup")
    print(f"Test Summary \tAverage WER {w:.3f}\tAverage CER {c:.3f}"
          f"\t({n_utts / dt:.1f} utt/s eval{steady})")
    return w, c


def transcribe(cfg: TranscribeConfig) -> Dict[str, Any]:
    """Transcription workflow (reference: inference.py:44-76): prints and
    returns the result JSON."""
    bundle = load_model(cfg.model.model_path, cfg.model.precision, cfg.device,
                        cfg.num_cpu_devices)
    decoder = load_decoder(bundle.labels, cfg.lm, want_offsets=cfg.offsets)
    decoded_output, decoded_offsets = run_transcribe(
        audio_path=cfg.audio_path, bundle=bundle, decoder=decoder,
        chunk_size_seconds=cfg.chunk_size_seconds, n_best=max(1, cfg.lm.top_paths))
    results = decode_results(decoded_output, decoded_offsets,
                             model_path=cfg.model.model_path, lm_cfg=cfg.lm,
                             offsets=cfg.offsets, top_paths=cfg.lm.top_paths)
    print(json.dumps(results))
    return results
