"""Training and validation loops on one torch device: the counterpart of
dsjax/train/loop.py.

One optimizer step does: forward (bf16 compute under precision=16, f32
parameters) -> log_softmax in f32 -> CTC (sum over rows, zero_infinity,
zero weight on batch-pad rows) -> backward (through the LSTM kernels K2 and
K3 on CUDA) -> global-norm clip -> AdamW/SGD at base * anneal^epoch.
Validation runs the eval forward (K1), greedy decoding and WER/CER. With
``data.device_features=true`` (dsjax's default) a batch arrives as int16 raw
audio and the spectrogram is computed on the device at the top of the step
(``audio.features.spectrogram_torch``), as dsjax's ``Trainer._features``
does inside its compiled step; with ``data.augmentation.spec_augment`` and
``spec_augment_device`` the step then masks it (``audio.augment``, draws
from a generator on the device seeded by (seed, global step)).
``trainer.profile`` traces a window of steps with ``torch.profiler``
(``train.logging.profile_steps``), each step a ``train_step <n>`` span
holding the spans of ``dsjax_torch.trace``: ``train.step``, and inside it
``train.forward``, ``train.loss``, ``train.backward`` and ``train.update``,
so the trace shows which phase launched each kernel.

Under torchrun (``parallel.distributed.initialize``, which
``workflows.train`` calls) every rank runs this loop on its own card, and
each step gives dsjax's answers on the global batch. With
``trainer.mesh_model`` = M (dsjax's model axis; ``parallel/mesh.py``) the
world is dp = world / M data indices of M ranks each; the M ranks of a
model group hold the same rows, and each holds only its block of the
recurrent and head weights and of their optimizer moments
(``parallel/tensor.py``; at M = 1, the default, every rank holds the whole
model and the data group is the world). The model is wrapped in
``DistributedDataParallel`` over the data group (one gradient all-reduce an
optimizer step, averaged over dp, which is the gradient of dsjax's ``loss /
dp``), the host arrays are zero-padded to the ranks' common shapes before
they are staged (``multihost.agree_shapes``), BatchNorm takes the data
group's statistics (``model/ds2.py:TorchBatchNorm``), the device
SpecAugment masks are drawn for the rank's row block of the global batch,
the global-norm clip adds the shards' squares over the model group, the
logged loss is the data group's sum over dp, and validation sums the
WER/CER counts of model index 0 over the ranks. Outside torchrun none of
this runs.

The state lives in a ``TrainState`` that the methods update in place and
return, so calls read like dsjax's functional ones: ``state, loss =
trainer.train_step(state, batch)``.

Settings the port does not carry raise instead of being ignored: more
than one card in one process, ``mesh_*`` settings that do not describe the
world size, and the fields that select or tune JAX (``refuse_unported``).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dsjax_torch.audio.augment import spec_augment_device, step_generator
from dsjax_torch.audio.features import features_torch
from dsjax_torch.config import TrainConfig, TrainerConfig
from dsjax_torch.data.dataset import Batch
from dsjax_torch.data.loader import DevicePrefetcher, Staged, stage
from dsjax_torch.decode.greedy import GreedyDecoder
from dsjax_torch.inference import resolve_device
from dsjax_torch.model.ctc import ctc_loss
from dsjax_torch.model.build import build_model
from dsjax_torch.parallel import distributed, tensor
from dsjax_torch.parallel.mesh import check_mesh, make_groups
from dsjax_torch.parallel.multihost import agree_count, agree_shapes, sum_ints
from dsjax_torch.trace import span
from dsjax_torch.train.metrics import CharErrorRate, WordErrorRate, update_batch
from dsjax_torch.train.state import (TrainState, clip_by_global_norm, epoch_lr,
                                     make_optimizer, set_lr)

Tensor = torch.Tensor

# TrainerConfig fields that select or tune JAX itself
_JAX_ONLY = ("platform", "num_cpu_devices", "matmul_precision", "donate_state")

TORCHRUN = "python -m torch.distributed.run --nproc_per_node <cards> -m dsjax_torch.train ..."


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise for every setting the port's training slice does not carry, so
    none is silently ignored. ``trainer.devices`` counts a node's cards:
    under torchrun -1 or LOCAL_WORLD_SIZE (one process a card), outside it
    -1 or 1; the ``mesh_*`` settings must describe the world size
    (``parallel.mesh.check_mesh``)."""
    tr, default = cfg.trainer, TrainerConfig()
    for name in _JAX_ONLY:
        if getattr(tr, name) != getattr(default, name):
            raise ValueError(f"trainer.{name} selects or tunes JAX; the port does not read "
                             f"it: leave it at {getattr(default, name)!r}")
    if distributed.launched() and not distributed.active():
        raise RuntimeError("torchrun's environment is set but this process has not joined "
                           "its group: call dsjax_torch.parallel.distributed.initialize() "
                           "first (workflows.train does)")
    tensor.refuse_unsharded(cfg.model, tr.mesh_model)
    check_mesh(tr.mesh_data, tr.mesh_model, tr.mesh_dcn, distributed.world_size())
    if distributed.active():
        local = int(os.environ["LOCAL_WORLD_SIZE"])
        if tr.devices not in (-1, local):
            raise ValueError(f"trainer.devices={tr.devices} but torchrun started {local} "
                             f"process(es) on this node, one a card: leave it at -1 or set "
                             f"{local}")
    elif tr.devices not in (-1, 1):
        raise NotImplementedError(f"trainer.devices={tr.devices}: one process trains on one "
                                  f"card; launch one process a card with {TORCHRUN}")
    elif (tr.devices == -1 and torch.device(tr.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(f"trainer.devices=-1 asks for all "
                                  f"{torch.cuda.device_count()} cards, but one process trains "
                                  f"on one card: set trainer.devices=1, or launch one process "
                                  f"a card with {TORCHRUN}")
    if tr.deterministic or cfg.checkpoint.filename:
        raise ValueError("trainer.deterministic and checkpoint.filename are read neither "
                         "by dsjax nor by the port: leave them at their defaults")


def _limit(n_batches: int, limit: float) -> int:
    if limit is None:
        return n_batches
    if limit <= 1.0:
        return max(1, int(n_batches * limit)) if limit > 0 else 0
    return min(n_batches, int(limit))


class Trainer:
    def __init__(self, cfg: TrainConfig, labels: List[str]):
        refuse_unported(cfg)
        self.cfg = cfg
        self.labels = list(labels)
        self.device = resolve_device(cfg.trainer.device)
        # the model and data groups (a collective at mesh_model > 1)
        self.groups = make_groups(cfg.trainer.mesh_model)
        if self.device.type == "cuda" and self.device.index is None and distributed.active():
            self.device = torch.device("cuda", distributed.local_rank())
        self.dtype = torch.bfloat16 if cfg.trainer.precision == 16 else torch.float32
        if cfg.trainer.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)
        aug = cfg.data.augmentation
        if aug.spec_augment and aug.spec_augment_device:
            # close the silent-narrowing trap: the device variant applies
            # freq/time masks only (audio/augment.py spec_augment_device)
            warnings.warn(
                "spec_augment_device=true runs SpecAugment's frequency/time "
                "masks inside the training step but SKIPS the sparse-image-"
                "warp time warp (host-only). Set spec_augment_device=false "
                "(with device_features=false) to keep the full augmentation.",
                stacklevel=2)
        self.decoder = GreedyDecoder(labels)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._ddp = None  # the DistributedDataParallel wrapper of the state's model

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh model with weights drawn from ``seed`` (cfg.seed by
        default) and a fresh optimizer."""
        gen = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        model = build_model(len(self.labels), self.cfg.data.spect, self.cfg.model,
                            dtype=self.dtype, generator=gen)
        # at mesh_model > 1 each rank keeps its block of the sharded weights
        # (taken before the copy to the card, so only the blocks reach it),
        # and the optimizer's moments are made on those blocks
        tensor.shard_model(model, self.groups)
        model = model.to(self.device)
        return TrainState(model, make_optimizer(model.parameters(), self.cfg.optim))

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def put_batch(self, batch: Batch, agree: bool = True) -> Staged:
        """Host batch -> device tensors. On CUDA the host arrays are pinned
        and copied without blocking on the trainer's side stream, so a
        DevicePrefetcher thread can run this ahead of the step. A
        device-feature batch ships its raw audio (int16) as the inputs.
        With more than one rank and ``agree`` the arrays are first
        zero-padded to the ranks' common shapes (a collective: every rank
        calls this in step); the eval forward runs no collective and skips it."""
        with span("train.put_batch"):
            x = batch.inputs if batch.inputs is not None else batch.audio
            arrays = (x, batch.input_lengths.astype(np.int32), batch.targets.astype(np.int32),
                      batch.target_lengths.astype(np.int32), batch.valid_mask)
            return stage(agree_shapes(arrays) if agree else arrays, self.device,
                         self._copy_stream)

    def _module(self, state: TrainState) -> torch.nn.Module:
        """What the training forward calls: the model, or inside a process
        group its DDP wrapper over the data group (made at the first step,
        a collective). The running stats are equal on every rank by
        construction, so buffers are not broadcast; ``state.model`` stays
        the bare model, so checkpoints and the server see no ``module.``
        prefix."""
        if not distributed.active():
            return state.model
        if self._ddp is None or self._ddp.module is not state.model:
            from torch.nn.parallel import DistributedDataParallel

            with warnings.catch_warnings():
                # newer torch renames broadcast_buffers (forward_sync_buffers
                # still syncs at init); the card's torch has only this name
                warnings.filterwarnings("ignore", "`broadcast_buffers` is deprecated",
                                        FutureWarning)
                self._ddp = DistributedDataParallel(
                    state.model, device_ids=[self.device.index] if self.device.type == "cuda"
                    else None, process_group=self.groups.data, broadcast_buffers=False,
                    gradient_as_bucket_view=True)
        return self._ddp

    def _features(self, x: Tensor, input_lengths: Tensor) -> Tensor:
        """(B, L_pad) raw audio -> (B, F, T) features on the device (the
        config's front end, ``features_torch``); host features pass through
        (dsjax's Trainer._features)."""
        if x.dim() == 2:
            return features_torch(x, input_lengths, self.cfg.data.spect, normalize=True)
        return x

    def _device_augment(self, feats: Tensor, input_lengths: Tensor, step: int) -> Tensor:
        """On-device SpecAugment masks (AugmentationConfig.spec_augment_device),
        drawn from a generator on the device seeded by (seed, global step),
        for the global batch of which this rank's data index holds a row
        block."""
        aug = self.cfg.data.augmentation
        if not (aug.spec_augment and aug.spec_augment_device):
            return feats
        return spec_augment_device(feats, input_lengths,
                                   step_generator(self.cfg.seed, step, feats.device),
                                   world=self.groups.data_size, rank=self.groups.data_index)

    def _backward(self, state: TrainState, batch: Batch,
                  staged: Optional[Staged] = None, sync: bool = True) -> Tensor:
        """Forward, loss and backward on one batch; gradients accumulate in
        the parameters' .grad and the BatchNorm running stats move. Under
        DDP the backward of the rank's loss sum all-reduces the gradients,
        averaged over the data group, unless ``sync`` is False (a
        micro-batch before the last of an optimizer step); the returned
        loss is the data group's sum over dp, dsjax's ``loss / dp``."""
        staged = staged if staged is not None else self.put_batch(batch)
        x, input_lengths, targets, _, valid = staged.wait(self.device)
        module = self._module(state)
        state.model.train()
        with (contextlib.nullcontext() if sync or module is state.model else module.no_sync()):
            with span("train.forward"):
                feats = self._features(x, input_lengths)
                if x.dim() == 2:  # raw-audio mode: augment on the device, keyed by the step
                    feats = self._device_augment(feats, input_lengths, state.step)
                out, _, _ = module(feats, input_lengths)
            with span("train.loss"):
                logp = torch.log_softmax(out.float(), dim=-1)
                # the lengths from the host batch, by the model's own rule: torch's
                # CTC reads them on the host, and reading the device's would hold
                # the host here until the forward ends, with none of the backward
                # issued
                nll = ctc_loss(logp, state.model.output_lengths(
                    torch.from_numpy(batch.input_lengths)), targets,
                    torch.from_numpy(batch.target_lengths), reduction="none",
                    zero_infinity=True)
                # batch-pad rows (Batch.valid=False) carry zero loss and gradient
                loss = torch.sum(nll * valid)
            with span("train.backward"):
                loss.backward()
                loss = loss.detach()
                if module is not state.model:
                    with span("ddp.reduce"):
                        torch.distributed.all_reduce(loss, group=self.groups.data)
                    loss = loss / self.groups.data_size
        return loss

    def _update(self, state: TrainState, n_accum: int) -> TrainState:
        """Scale the accumulated gradients by 1 / n_accum, clip, and step
        the optimizer at this epoch's learning rate. At mesh_model > 1 the
        replicated parameters' gradients are first made equal across the
        model group, and the clip's norm counts the shards over it."""
        with span("train.update"):
            named = [(n, p) for n, p in state.model.named_parameters() if p.grad is not None]
            params = [p for _, p in named]
            if n_accum != 1:
                for p in params:
                    p.grad.mul_(1.0 / max(1, n_accum))
            tensor.agree_replicated(state.model, self.groups)
            clip = self.cfg.trainer.gradient_clip_val
            if clip and clip > 0:
                sharded = tensor.sharded_dims(state.model)
                clip_by_global_norm([p.grad for p in params], clip,
                                    [n in sharded for n, _ in named], self.groups.model)
            set_lr(state.optimizer, epoch_lr(self.cfg.optim, state.epoch))
            state.optimizer.step()
            state.step += 1
            return state

    @staticmethod
    def _agree_micro_batches(n: int) -> None:
        """The first collective of every optimizer step: the ranks' counts of
        micro-batches, which must be equal, since each micro-batch issues
        the same BatchNorm and gradient all-reduces on every rank."""
        agree_count(n, "the micro-batches of an optimizer step (ragged_split gives a bin "
                       "of fewer than 2 x ragged_split utterances one sub-batch)")

    def train_step(self, state: TrainState, batch: Batch,
                   staged: Optional[Staged] = None) -> Tuple[TrainState, Tensor]:
        """One optimizer step. ``staged`` short-circuits put_batch with
        tensors a DevicePrefetcher already copied. With more than one rank
        it first agrees its count of one micro-batch with the other ranks,
        whichever of this and ``train_step_accum`` they took."""
        with span("train.step"):
            self._agree_micro_batches(1)
            state.optimizer.zero_grad(set_to_none=True)
            loss = self._backward(state, batch, staged)
            return self._update(state, 1), loss

    def grad_step(self, state: TrainState, batch: Batch) -> Tuple[Dict[str, Tensor], Tensor]:
        """Gradients of one batch's loss by parameter name, and the loss;
        moves the BatchNorm running stats, changes no parameter."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._backward(state, batch)
        return {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}, loss

    def apply_grads(self, state: TrainState, grads: Dict[str, Tensor],
                    n_accum: int) -> TrainState:
        """One optimizer step from summed gradients of n_accum batches."""
        for n, p in state.model.named_parameters():
            p.grad = grads[n].clone()
        return self._update(state, n_accum)

    def train_step_accum(self, state: TrainState, batches: List[Batch],
                         n_accum: int = 0) -> Tuple[TrainState, Tensor]:
        """One optimizer step from several micro-batches.

        ``n_accum`` is the divisor applied to the summed gradients: the
        number of REAL batches accumulated (Lightning parity: each batch
        contributes its mean). ragged_split sub-batches of one batch are
        partitions of a single sum-reduced loss, so they sum WITHOUT
        scaling (n_accum=1); callers mixing both pass the real-batch
        count. 0 (default) = len(batches), the plain accumulation case.

        Under DDP the gradients are all-reduced once, in the last backward;
        every rank must hold as many batches (a short bin gives fewer
        ragged_split sub-batches), else every rank raises."""
        with span("train.step"):
            self._agree_micro_batches(len(batches))
            state.optimizer.zero_grad(set_to_none=True)
            loss = None
            for i, b in enumerate(batches):
                loss = self._backward(state, b, sync=i == len(batches) - 1)
            return self._update(state, n_accum or len(batches)), loss

    @torch.inference_mode()
    def eval_step(self, state: TrainState, batch: Batch) -> Tuple[Tensor, Tensor]:
        """The eval forward (K1 on CUDA) of this rank's rows: (probs (B, T',
        C) f32, out_lens). It runs no collective, so its shapes need no
        agreement."""
        x, input_lengths = self.put_batch(batch, agree=False).wait(self.device)[:2]
        state.model.eval()
        out, out_lens, _ = state.model(self._features(x, input_lengths), input_lengths)
        return out, out_lens

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def validate(self, state: TrainState, pipeline: Iterable[Batch],
                 max_batches: Optional[int] = None, verbose: bool = False
                 ) -> Tuple[float, float]:
        wer, cer = WordErrorRate(), CharErrorRate()
        for i, batch in enumerate(pipeline):
            if max_batches is not None and i >= max_batches:
                break
            out, out_lens = self.eval_step(state, batch)
            n_real = int(batch.valid_mask.sum()) or batch.size
            decoded, _ = self.decoder.decode(out, out_lens, n_best=1)
            refs = self.decoder.convert_to_strings(
                [batch.targets[b, :batch.target_lengths[b]] for b in range(batch.size)])
            transcripts = [d[0] for d in decoded[:n_real]]
            references = [r[0] for r in refs[:n_real]]
            update_batch(wer, cer, transcripts, references)
            if verbose:
                for t, r in zip(transcripts, references):
                    print(f"Ref:  {r}\nHyp:  {t}\n")
        # each data index decoded its own rows: exact integer sums over the
        # ranks (torchmetrics dist_reduce_fx="sum" parity, dsjax's validate),
        # where only model index 0 of each model group counts its rows
        counts = [wer.distance, wer.denom, cer.distance, cer.denom]
        if self.groups.model_index:
            counts = [0] * len(counts)
        wer.distance, wer.denom, cer.distance, cer.denom = sum_ints(counts)
        return wer.compute(), cer.compute()

    def fit(self, train_pipeline, val_pipeline, checkpoint_handler=None,
            state: Optional[TrainState] = None,
            log_fn: Callable[[str], None] = print,
            metrics_logger=None) -> TrainState:
        from dsjax_torch.train.logging import StepTimer, profile_steps

        state = state if state is not None else self.init_state()
        cfg, tr = self.cfg, self.cfg.trainer
        start_epoch = state.epoch
        n_val = _limit(len(val_pipeline), cfg.trainer.limit_val_batches)
        timer = StepTimer()
        tracing = False
        # trainer.profile's window, closed at its last step or when fit ends
        with contextlib.ExitStack() as trace:
            for epoch in range(start_epoch, cfg.trainer.max_epochs):
                train_pipeline.sampler.set_epoch(epoch)
                # recompute per epoch: after a mid-epoch auto-resume the first
                # epoch is shorter (sampler.start_index > 0) but later epochs,
                # whose start_index resets to 0, must run full length
                n_train = _limit(len(train_pipeline), cfg.trainer.limit_train_batches)
                state.epoch = epoch
                t0 = time.time()
                losses = []
                timer.start()
                accum = max(1, cfg.trainer.accumulate_grad_batches)
                micro: List[Batch] = []
                micro_batches = 0
                # copy batches to the device ahead of the step; with more
                # than one rank put_batch is a collective of the host group,
                # which stays on this thread (as dsjax's prefetch gate)
                use_dp = (cfg.data.device_prefetch > 0 and accum == 1
                          and distributed.world_size() == 1)
                if use_dp:
                    import itertools

                    # bound the SOURCE so the producer never copies batches
                    # past the n_train limit
                    train_iter = DevicePrefetcher(
                        itertools.islice(iter(train_pipeline), n_train),
                        self.put_batch, depth=cfg.data.device_prefetch)
                else:
                    train_iter = train_pipeline
                for i, item in enumerate(train_iter):
                    batch, staged = item if use_dp else (item, None)
                    if i >= n_train:
                        break
                    # trainer.profile traces the optimizer steps whose pre-step
                    # counts run from profile_start_step to profile_start_step +
                    # profile_num_steps, as dsjax's fit does
                    pre_step = state.step
                    if tr.profile and not tracing and pre_step == tr.profile_start_step:
                        trace.enter_context(profile_steps(tr.profile_dir))
                        tracing = True
                    # ragged_split pipelines yield each batch as a list of
                    # length-quantile sub-batches -> one summed-grad step
                    subs = batch if isinstance(batch, list) else [batch]
                    if accum > 1:
                        micro.extend(subs)
                        micro_batches += 1
                        if micro_batches < accum and i + 1 < n_train:
                            continue
                    with span(f"train_step {pre_step}"):
                        if accum > 1:
                            # scale by REAL batches accumulated, not sub-batches:
                            # ragged_split partitions one sum-reduced loss
                            state, loss = self.train_step_accum(state, micro,
                                                                n_accum=micro_batches)
                            micro = []
                            micro_batches = 0
                        elif len(subs) > 1:
                            state, loss = self.train_step_accum(state, subs, n_accum=1)
                        else:
                            state, loss = self.train_step(state, batch, staged=staged)
                    if tracing and pre_step == tr.profile_start_step + tr.profile_num_steps:
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        trace.close()
                        tracing = False
                    losses.append(loss)
                    # mid-epoch validation (Lightning val_check_interval parity)
                    vci = cfg.trainer.val_check_interval
                    if 0 < vci < 1.0:
                        every_val = max(1, int(n_train * vci))
                        if (i + 1) % every_val == 0 and (i + 1) < n_train:
                            wer_i, cer_i = self.validate(state, val_pipeline, max_batches=n_val)
                            log_fn(f"epoch {epoch} step {i + 1}: wer {wer_i:.2f} cer {cer_i:.2f}")
                            if metrics_logger is not None:
                                metrics_logger.log(state.step, wer=wer_i, cer=cer_i, epoch=epoch)
                    # mid-epoch checkpointing with the sampler position, for a
                    # mid-epoch resume (reference: samplers' start_index)
                    every = cfg.checkpoint.every_n_steps
                    if (checkpoint_handler is not None and every > 0
                            and (i + 1) % every == 0 and (i + 1) < n_train):
                        checkpoint_handler.save(
                            state, {"loss": float(loss)},
                            extra={"start_index": train_pipeline.sampler.start_index + i + 1,
                                   "epoch": epoch},
                            last_only=True)
                    if (i + 1) % max(1, cfg.trainer.log_every_n_steps) == 0:
                        loss_val = float(loss)  # device sync only when logging
                        timer.tick(sum(b.size for b in subs)
                                   * max(1, cfg.trainer.log_every_n_steps))
                        log_fn(f"epoch {epoch} step {i + 1}/{n_train} "
                               f"loss {loss_val:.3f} "
                               f"({timer.utterances_per_sec:.1f} utt/s)")
                        if metrics_logger is not None:
                            metrics_logger.log(state.step, loss=loss_val,
                                               utt_per_sec=timer.utterances_per_sec, epoch=epoch)
                train_time = time.time() - t0
                mean_loss = float(np.mean([float(l) for l in losses])) if losses else 0.0
                wer, cer = self.validate(state, val_pipeline, max_batches=n_val)
                log_fn(f"epoch {epoch}: loss {mean_loss:.3f} "
                       f"wer {wer:.2f} cer {cer:.2f} ({train_time:.1f}s)")
                if metrics_logger is not None:
                    metrics_logger.log(state.step, wer=wer, cer=cer, mean_loss=mean_loss,
                                       epoch=epoch)
                if checkpoint_handler is not None and cfg.trainer.enable_checkpointing:
                    # saved with epoch + 1, so a resume continues at the NEXT epoch
                    state.epoch = epoch + 1
                    checkpoint_handler.save(
                        state, {"wer": wer, "cer": cer, "loss": mean_loss, "epoch": epoch})
                    state.epoch = epoch
                # sampler start_index reset after completing an epoch
                train_pipeline.sampler.start_index = 0
        return state
