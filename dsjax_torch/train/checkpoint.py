"""Checkpointing: best-k by a monitored metric, last, and resume.

Counterpart of dsjax/train/checkpoint.py with ``torch.save`` files in place
of orbax (reference capability: Lightning ModelCheckpoint monitoring "wer"
with save_top_k and save_last, deepspeech_pytorch/checkpoint.py). Layout:

  <dirpath>/meta.json            the run's config and labels
  <dirpath>/last/step_<n>.pt     the newest save (one kept)
  <dirpath>/best/step_<n>.pt     the save_top_k saves with the lowest monitor
  <dirpath>/best/index.json      each best save's metrics

Each file is what ``dsjax_torch.model.convert.save_checkpoint`` writes (the
reference-layout state_dict and hyper-parameters, so
``dsjax_torch.inference.load_model`` and the server load it as a model)
plus the optimizer state, the step and epoch counters, the metrics and the
host-side extras (the sampler's mid-epoch ``start_index``). A save that is
both last and best is written once and hard-linked. Files are written
beside their target and renamed into place, so a reader never sees half a
file. Inside a process group only rank 0 writes (``meta.json`` and every
save, as dsjax's handler does) and every rank waits at a barrier after each
save; on resume every rank reads the same files. Under tensor parallelism
(``trainer.mesh_model`` > 1) every rank first gathers the sharded
parameters and optimizer moments over its model group
(``parallel.tensor.whole_state_dicts``), so rank 0 writes the whole model
in the file ``mesh_model=1`` writes, and a restore takes each rank's blocks
of it: a run saved at one mesh_model resumes at another.

A dsjax run continues here after ``tools/dsjax_checkpoint_to_torch.py``
mirrors its directory into this layout through ``from_dsjax_state`` (the
weights, Adam's moments and count or SGD's trace, the counters and the
sampler position). On resume the run's optimizer settings win over the
file's, as in dsjax, whose optax chain is built from the new config; a file
of another optimizer kind raises. A dsjax directory itself (orbax's
numbered step directories) is refused with the tool's name.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from dsjax_torch.config import SGDConfig, TrainConfig, to_dict
from dsjax_torch.model.convert import (CONVERT_TOOL, from_dsjax_params, from_dsjax_variables,
                                       from_reference_state_dict, load_checkpoint,
                                       save_checkpoint)
from dsjax_torch.model.build import build_model
from dsjax_torch.parallel import distributed, tensor
from dsjax_torch.train.state import TrainState, make_optimizer


def _steps(folder: str) -> List[int]:
    if not os.path.isdir(folder):
        return []
    return sorted(int(name[5:-3]) for name in os.listdir(folder)
                  if name.startswith("step_") and name.endswith(".pt"))


def _path(folder: str, step: int) -> str:
    return os.path.join(folder, f"step_{step}.pt")


def refuse_dsjax_layout(path: str) -> None:
    """Raise for a dsjax checkpoint directory (``meta.json`` beside
    ``last/`` or ``best/`` holding orbax's numbered step directories), or
    one of its ``last``/``best`` subdirectories: the port reads the
    directory the conversion tool mirrors from it."""
    path = os.path.abspath(path)
    root = os.path.dirname(path) if os.path.basename(path) in ("last", "best") else path
    if not os.path.isfile(os.path.join(root, "meta.json")):
        return
    for sub in ("last", "best"):
        folder = os.path.join(root, sub)
        if os.path.isdir(folder) and any(name.isdigit() and os.path.isdir(os.path.join(
                folder, name)) for name in os.listdir(folder)):
            raise IsADirectoryError(
                f"{path} is a dsjax checkpoint directory (orbax steps under {folder}). "
                f"Convert it with python {CONVERT_TOOL} {root} OUT (needs jax and orbax), then "
                f"resume with checkpoint.dirpath=OUT load_auto_checkpoint=true or "
                f"trainer.resume_from_checkpoint=OUT")


def write_state(path: str, state: TrainState, labels: Sequence[str],
                metrics: Mapping[str, float], extra: Mapping[str, Any],
                whole: Optional[Tuple[Mapping[str, torch.Tensor], Mapping[str, Any]]] = None
                ) -> None:
    """The trainer's checkpoint file: the model as ``save_checkpoint`` writes
    it, plus the optimizer state, the counters, the metrics and the
    host-side extras; written beside ``path`` and renamed into place.
    ``whole`` is the (model, optimizer) state_dicts of the whole model
    (``parallel.tensor.whole_state_dicts``), required for a sharded one."""
    model = state.model
    if whole is None:
        if tensor.sharded_dims(model):
            raise ValueError("a sharded model's file needs its whole state_dicts: gather "
                             "them on every rank with parallel.tensor.whole_state_dicts")
        whole = (model.state_dict(), state.optimizer.state_dict())
    tmp = path + ".tmp"
    save_checkpoint(tmp, whole[0], model.model_cfg, model.spect_cfg, labels, extra={
        "optimizer": whole[1], "step": state.step, "epoch": state.epoch,
        "metrics": dict(metrics), "extra": dict(extra)})
    os.replace(tmp, path)


class CheckpointHandler:
    """Manages <dir>/best (top-k by the monitored metric) and <dir>/last."""

    def __init__(self, dirpath: str, monitor: str = "wer", save_top_k: int = 1,
                 save_last: bool = True, cfg: Any = None,
                 labels: Optional[List[str]] = None, verbose: bool = False):
        self.dirpath = os.path.abspath(dirpath)
        self.monitor = monitor
        self.save_top_k = max(1, save_top_k)
        self.save_last = save_last
        self.verbose = verbose
        self.labels = list(labels) if labels is not None else None
        self.best_dir = os.path.join(self.dirpath, "best")
        self.last_dir = os.path.join(self.dirpath, "last")
        refuse_dsjax_layout(self.dirpath)
        os.makedirs(self.best_dir, exist_ok=True)
        os.makedirs(self.last_dir, exist_ok=True)
        meta: Dict[str, Any] = {"format_version": 1}
        if cfg is not None:
            meta["config"] = to_dict(cfg)
        if labels is not None:
            meta["labels"] = list(labels)
        if distributed.is_main_process():
            with open(os.path.join(self.dirpath, "meta.json"), "w") as f:
                json.dump(meta, f)

    # -- save ----------------------------------------------------------

    def _write(self, path: str, state: TrainState, metrics: Dict[str, float],
               extra: Dict[str, Any], whole=None) -> None:
        write_state(path, state, self.labels or [], metrics, extra, whole)

    def _index(self) -> Dict[int, Dict[str, float]]:
        path = os.path.join(self.best_dir, "index.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def save(self, state: TrainState, metrics: Dict[str, float],
             extra: Optional[Dict[str, Any]] = None, last_only: bool = False) -> None:
        """Save last and, unless ``last_only`` (a mid-epoch save that does
        not compete in the ranking), best-k. ``extra`` carries host-side
        state such as the sampler's start_index. A sharded model's whole
        state is gathered on every rank first; rank 0 writes; every rank
        returns after the files are in place."""
        whole = (tensor.whole_state_dicts(state.model, state.optimizer)
                 if tensor.sharded_dims(state.model) else None)
        if distributed.is_main_process():
            self._save(state, metrics, extra, last_only, whole)
        distributed.barrier()

    def _save(self, state: TrainState, metrics: Dict[str, float],
              extra: Optional[Dict[str, Any]], last_only: bool, whole=None) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        extra = dict(extra or {})
        step = state.step
        written = None
        if self.save_last or last_only:
            written = _path(self.last_dir, step)
            self._write(written, state, metrics, extra, whole)
            for old in _steps(self.last_dir):
                if old != step:
                    os.unlink(_path(self.last_dir, old))
        if not last_only:
            best = _path(self.best_dir, step)
            if os.path.exists(best):
                os.unlink(best)
            if written is not None:
                os.link(written, best)
            else:
                self._write(best, state, metrics, extra, whole)
            index = self._index()
            index[step] = metrics
            ranked = sorted(index, key=lambda s: (index[s].get(self.monitor, float("inf")), s))
            for old in ranked[self.save_top_k:]:
                del index[old]
                if os.path.exists(_path(self.best_dir, old)):
                    os.unlink(_path(self.best_dir, old))
            tmp = os.path.join(self.best_dir, "index.json.tmp")
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in index.items()}, f)
            os.replace(tmp, os.path.join(self.best_dir, "index.json"))
        if self.verbose:
            print(f"saved checkpoint step={step} {metrics}")

    # -- restore -------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.last_dir if self.save_last else self.best_dir)
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        index = self._index()
        if not index:
            return None
        return min(index, key=lambda s: (index[s].get(self.monitor, float("inf")), s))

    def path(self, best: bool = False) -> str:
        """The file of the newest last save, or of the best save."""
        step = self.best_step() if best else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.dirpath}")
        return _path(self.best_dir if best else self.last_dir, step)

    def restore(self, state: TrainState, best: bool = False) -> TrainState:
        return restore_file(self.path(best), state)[0]

    def restore_extra(self) -> Dict[str, Any]:
        """Host-side extras (sampler state) of the last checkpoint."""
        try:
            path = self.path()
        except FileNotFoundError:
            return {}
        return dict(load_checkpoint(path).get("extra") or {})


def _kind(groups: Sequence[Mapping[str, Any]]) -> str:
    """The optimizer a state_dict's param_groups belong to, by its options."""
    return "adamw" if "betas" in groups[0] else "sgd" if "momentum" in groups[0] else "unknown"


def restore_file(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Load a checkpoint file into ``state``. A file the trainer wrote
    restores the optimizer's moments and the counters as well, with the
    run's own optimizer options (betas, eps, weight_decay, momentum; the
    learning rate is set every step): dsjax builds its optax chain from the
    new config and restores only the moments and counts into it. A file of
    another optimizer kind raises, as dsjax's restore does. Any other file
    with a reference-layout state_dict (a ``save_checkpoint`` model, a
    reference ``.ckpt``) warm-starts the weights with a fresh optimizer.
    Every file holds the whole model: a sharded model (``trainer.mesh_model``
    > 1) takes its blocks of the weights and moments. Returns the state and
    the host-side extras."""
    ckpt = load_checkpoint(path)
    weights = from_reference_state_dict(ckpt.get("state_dict", ckpt))
    want = tensor.whole_shapes(state.model)
    got = {k: tuple(v.shape) for k, v in weights.items()}
    if want != got:
        raise ValueError(f"checkpoint {path} does not match the configured model (set "
                         f"model.hidden_size/hidden_layers/rnn_type and model=bidirectional "
                         f"or unidirectional, or model=conformer and its widths, to the "
                         f"checkpoint's): {got} vs {want}")
    weights = tensor.own_blocks(state.model, weights)
    if "optimizer" not in ckpt:
        state.model.load_state_dict(weights)
        print(f"warm-started weights from {path} (fresh optimizer state)")
        return state, {}
    saved, groups = ckpt["optimizer"], state.optimizer.param_groups
    if _kind(saved["param_groups"]) != _kind(groups):
        raise ValueError(f"checkpoint {path} holds {_kind(saved['param_groups'])} state but "
                         f"the run's optimizer is {_kind(groups)}: set optim= to the "
                         f"checkpoint's, as dsjax cannot restore another optimizer's state")
    state.model.load_state_dict(weights)
    options = [{k: v for k, v in g.items() if k not in ("params", "lr")} for g in groups]
    state.optimizer.load_state_dict(tensor.own_optimizer_blocks(state.model, state.optimizer,
                                                                saved))
    for group, own in zip(state.optimizer.param_groups, options):
        group.update(own)
    state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])
    return state, dict(ckpt.get("extra") or {})


def restore_from_path(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """trainer.resume_from_checkpoint: a checkpoint file, or a checkpoint
    directory (the handler's dirpath, whose ``last`` save is preferred over
    its ``best``, or one of those two subdirectories), whose newest save
    is restored, as dsjax's restore_from_path does. A dsjax directory
    raises (``refuse_dsjax_layout``)."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return restore_file(path, state)
    refuse_dsjax_layout(path)
    if os.path.basename(path) in ("last", "best"):
        candidates = [path]
    else:
        candidates = [os.path.join(path, "last"), os.path.join(path, "best")]
    for folder in candidates:
        steps = _steps(folder)
        if steps:
            return restore_file(_path(folder, steps[-1]), state)
    raise FileNotFoundError(f"no restorable checkpoint at {path}")


def from_dsjax_state(path: str, cfg: TrainConfig, labels: Sequence[str],
                     params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                     moments: Mapping[str, Any], step: int, epoch: int,
                     metrics: Optional[Mapping[str, float]] = None,
                     extra: Optional[Mapping[str, Any]] = None) -> TrainState:
    """Write a dsjax train state as the trainer's checkpoint file at
    ``path`` (``restore_file`` reads it as a file the trainer wrote) and
    return it as a TrainState on the CPU. Inputs are plain numpy trees and
    numbers: dsjax's ``params`` and ``batch_stats``, the optimizer's moments
    (``{"count", "mu", "nu"}`` of optax's ScaleByAdamState for AdamW,
    ``{"trace"}`` of its TraceState for SGD, in ``params``' layout), the
    step and epoch counters, the metrics and the host-side extras. The
    model and optimizer are the port's own for ``cfg``; each parameter's
    state takes torch's keys (AdamW ``step``, a float32 CPU tensor equal to
    optax's count, ``exp_avg``, ``exp_avg_sq``; SGD ``momentum_buffer``)
    through the weights' layout map, which carries every value exactly.
    Raises when the moments do not match ``cfg.optim``'s kind or the
    parameters one to one."""
    sgd = isinstance(cfg.optim, SGDConfig)
    keys = {"trace"} if sgd else {"count", "mu", "nu"}
    if set(moments) != keys:
        raise ValueError(f"optim is {type(cfg.optim).__name__}, whose dsjax state is "
                         f"{sorted(keys)}, but the moments hold {sorted(moments)}")
    model = build_model(len(labels), cfg.data.spect, cfg.model,
                        dtype=torch.bfloat16 if cfg.trainer.precision == 16 else torch.float32)
    model.load_state_dict(from_dsjax_variables({"params": params, "batch_stats": batch_stats}))
    optimizer = make_optimizer(model.parameters(), cfg.optim)
    named = dict(model.named_parameters())
    trees = {k: from_dsjax_params(moments[k]) for k in keys - {"count"}}
    for k, tree in trees.items():
        shapes = {n: tuple(t.shape) for n, t in tree.items()}
        if shapes != {n: tuple(p.shape) for n, p in named.items()}:
            raise ValueError(f"dsjax's {k} does not match the port's parameters one to one: "
                             f"{shapes} vs {[(n, tuple(p.shape)) for n, p in named.items()]}")
    for name, p in named.items():
        if sgd:
            optimizer.state[p] = {"momentum_buffer": trees["trace"][name]}
        else:
            optimizer.state[p] = {"step": torch.tensor(float(moments["count"]),
                                                       dtype=torch.float32),
                                  "exp_avg": trees["mu"][name], "exp_avg_sq": trees["nu"][name]}
    state = TrainState(model, optimizer, int(step), int(epoch))
    write_state(path, state, labels, {k: float(v) for k, v in (metrics or {}).items()},
                extra or {})
    return state
