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
save; on resume every rank reads the same files.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from dsjax_torch.model.convert import from_reference_state_dict, load_checkpoint, save_checkpoint
from dsjax_torch.parallel import distributed
from dsjax_torch.train.state import TrainState


def _plain(cfg: Any) -> Any:
    return json.loads(json.dumps(dataclasses.asdict(cfg),
                                 default=lambda v: v.value if isinstance(v, enum.Enum) else str(v)))


def _steps(folder: str) -> List[int]:
    if not os.path.isdir(folder):
        return []
    return sorted(int(name[5:-3]) for name in os.listdir(folder)
                  if name.startswith("step_") and name.endswith(".pt"))


def _path(folder: str, step: int) -> str:
    return os.path.join(folder, f"step_{step}.pt")


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
        os.makedirs(self.best_dir, exist_ok=True)
        os.makedirs(self.last_dir, exist_ok=True)
        meta: Dict[str, Any] = {"format_version": 1}
        if cfg is not None:
            meta["config"] = _plain(cfg)
        if labels is not None:
            meta["labels"] = list(labels)
        if distributed.is_main_process():
            with open(os.path.join(self.dirpath, "meta.json"), "w") as f:
                json.dump(meta, f)

    # -- save ----------------------------------------------------------

    def _write(self, path: str, state: TrainState, metrics: Dict[str, float],
               extra: Dict[str, Any]) -> None:
        model = state.model
        tmp = path + ".tmp"
        save_checkpoint(tmp, model.state_dict(), model.model_cfg, model.spect_cfg,
                        self.labels or [], extra={
                            "optimizer": state.optimizer.state_dict(), "step": state.step,
                            "epoch": state.epoch, "metrics": dict(metrics),
                            "extra": dict(extra)})
        os.replace(tmp, path)

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
        state such as the sampler's start_index. Rank 0 writes; every rank
        returns after the files are in place."""
        if distributed.is_main_process():
            self._save(state, metrics, extra, last_only)
        distributed.barrier()

    def _save(self, state: TrainState, metrics: Dict[str, float],
              extra: Optional[Dict[str, Any]], last_only: bool) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        extra = dict(extra or {})
        step = state.step
        written = None
        if self.save_last or last_only:
            written = _path(self.last_dir, step)
            self._write(written, state, metrics, extra)
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
                self._write(best, state, metrics, extra)
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


def restore_file(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Load a checkpoint file into ``state``. A file the trainer wrote
    restores the optimizer and counters as well; any other file with a
    reference-layout state_dict (a ``save_checkpoint`` model, a reference
    ``.ckpt``) warm-starts the weights with a fresh optimizer. Returns the
    state and the host-side extras."""
    ckpt = load_checkpoint(path)
    weights = from_reference_state_dict(ckpt.get("state_dict", ckpt))
    want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in weights.items()}
    if want != got:
        raise ValueError(f"checkpoint {path} does not match the configured model (set "
                         f"model.hidden_size/hidden_layers/rnn_type and model=bidirectional "
                         f"or unidirectional to the checkpoint's): {got} vs {want}")
    state.model.load_state_dict(weights)
    if "optimizer" not in ckpt:
        print(f"warm-started weights from {path} (fresh optimizer state)")
        return state, {}
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])
    return state, dict(ckpt.get("extra") or {})


def restore_from_path(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """trainer.resume_from_checkpoint: a checkpoint file, or a checkpoint
    directory (the handler's dirpath, whose ``last`` save is preferred over
    its ``best``, or one of those two subdirectories), whose newest save
    is restored, as dsjax's restore_from_path does."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return restore_file(path, state)
    if os.path.basename(path) in ("last", "best"):
        candidates = [path]
    else:
        candidates = [os.path.join(path, "last"), os.path.join(path, "best")]
    for folder in candidates:
        steps = _steps(folder)
        if steps:
            return restore_file(_path(folder, steps[-1]), state)
    raise FileNotFoundError(f"no restorable checkpoint at {path}")
