"""Workflow layer: training orchestration, the counterpart of the training
half of dsjax/workflows.py (reference: deepspeech_pytorch/training.py:13-47).

``train`` takes a composed ``TrainConfig`` and wires the data pipelines, the
trainer on one torch device, checkpoints and metrics logging. Run it as
``python -m dsjax_torch.train key=value ...``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from dsjax_torch.config import TrainConfig
from dsjax_torch.data.dataset import SpectrogramDataset
from dsjax_torch.data.loader import DataPipeline
from dsjax_torch.data.sampler import BucketBatchSampler, OrderedBatchSampler
from dsjax_torch.labels import load_labels
from dsjax_torch.train.checkpoint import CheckpointHandler, restore_from_path
from dsjax_torch.train.loop import Trainer
from dsjax_torch.train.state import TrainState


def _pipelines(cfg: TrainConfig, labels: List[str]) -> Tuple[DataPipeline, DataPipeline]:
    train_ds = SpectrogramDataset(cfg.data.spect, cfg.data.train_path, labels,
                                  normalize=True, aug_cfg=cfg.data.augmentation,
                                  device_features=cfg.data.device_features)
    val_ds = SpectrogramDataset(cfg.data.spect, cfg.data.val_path, labels,
                                normalize=True, device_features=cfg.data.device_features)
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
    final state."""
    np.random.seed(cfg.seed % (2 ** 32))
    labels = load_labels(cfg.data.labels_path if os.path.isfile(cfg.data.labels_path)
                         else None)
    trainer = Trainer(cfg, labels)
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
    if cfg.trainer.log_dir:
        from dsjax_torch.train.logging import MetricsLogger

        metrics_logger = MetricsLogger(cfg.trainer.log_dir)
        print(f"logging metrics to {metrics_logger.path}")
    try:
        return trainer.fit(train_pipe, val_pipe, checkpoint_handler=handler, state=state,
                           metrics_logger=metrics_logger)
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
