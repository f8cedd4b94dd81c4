#!/usr/bin/env python
"""Convert a dsjax checkpoint directory for dsjax_torch: the whole directory,
to continue the run, or one checkpoint file.

    JAX_PLATFORMS=cpu python tools/dsjax_checkpoint_to_torch.py CKPT_DIR OUT
    JAX_PLATFORMS=cpu python tools/dsjax_checkpoint_to_torch.py CKPT_DIR OUT.pt

CKPT_DIR is what dsjax's ``CheckpointHandler`` writes (``meta.json``,
``best/``, ``last/``). Each step is restored with dsjax's own handler into a
train state built from ``meta.json``'s config on one CPU device (orbax
restores global arrays, so a run of several devices converts too, a
tensor-parallel one of ``trainer.mesh_model`` > 1 included), and
written by ``dsjax_torch.train.checkpoint.from_dsjax_state``: the weights,
the optimizer's moments (AdamW's count, mu and nu, or SGD's trace), the step
and epoch counters, the step's metrics and its host-side extras (the
sampler's ``start_index``), as the port's trainer writes them.

OUT (no ``.pt``) becomes a port checkpoint directory: ``meta.json`` (the
config as the port's TrainConfig, and the labels), ``last/step_N.pt`` from
dsjax's last save and ``best/step_M.pt`` for each kept best save, with
``best/index.json`` from their metrics. The run continues with

    python -m dsjax_torch.train checkpoint.dirpath=OUT load_auto_checkpoint=true ...

(or ``trainer.resume_from_checkpoint=OUT``), on the card or with
``trainer.device=cpu``; a run of ``trainer.mesh_model=M`` continues at M
under ``python -m torch.distributed.run``, or at any other M, since the
files hold the whole model. OUT.pt is one such file, from the best checkpoint,
else the last one; ``python -m dsjax_torch.evaluate model.model_path=OUT.pt``
and the port's other entry points load it as a model.

This tool, unlike the port, imports jax, orbax and dsjax: run it where
they are installed (the CPU is enough).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def optimizer_moments(opt_state):
    """optax's chain state -> the plain moments ``from_dsjax_state`` takes:
    {"count", "mu", "nu"} from the ScaleByAdamState (its count counts
    updates, not the micro-batches of gradient accumulation), or {"trace"}
    from the TraceState."""
    import jax
    import numpy as np

    found = []

    def visit(node):
        names = getattr(node, "_fields", ())  # optax's states are namedtuples
        if "mu" in names and "nu" in names:
            found.append({"count": int(np.asarray(node.count)),
                          "mu": jax.tree_util.tree_map(np.asarray, node.mu),
                          "nu": jax.tree_util.tree_map(np.asarray, node.nu)})
        elif "trace" in names:
            found.append({"trace": jax.tree_util.tree_map(np.asarray, node.trace)})
        elif isinstance(node, tuple):
            for child in node:
                visit(child)

    visit(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam or trace state in the optimizer state, "
                         f"found {len(found)}")
    return found[0]


def _json_item(manager, step, name):
    """A step's JSON item (``metrics`` or ``extra``): dsjax's handler writes
    both with every save."""
    import orbax.checkpoint as ocp

    restored = manager.restore(step, args=ocp.args.Composite(**{name: ocp.args.JsonRestore()}))
    return dict(restored[name] or {})


def convert(ckpt_dir: str, out_path: str) -> str:
    """Convert ``ckpt_dir`` into ``out_path``: a port checkpoint directory,
    or with a ``.pt`` suffix one file. Returns what it took: "best" or
    "last" for a file, "last and best" or one of them for a directory."""
    import jax
    import numpy as np

    from dsjax.config import TrainConfig, from_dict
    from dsjax.labels import DEFAULT_LABELS
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.checkpoint import CheckpointHandler, load_meta
    from dsjax.train.loop import Trainer
    from dsjax_torch import config as port_config
    from dsjax_torch.train.checkpoint import from_dsjax_state

    meta = load_meta(ckpt_dir)
    cfg = from_dict(meta["config"], TrainConfig)
    port_cfg = port_config.from_dict(meta["config"], port_config.TrainConfig)
    labels = meta.get("labels") or list(DEFAULT_LABELS)
    # one CPU device, whatever mesh the run had: orbax restores global arrays
    trainer = Trainer(cfg, labels, mesh=make_mesh(1, 1, devices=jax.devices("cpu")[:1]))
    target = trainer.init_state()
    handler = CheckpointHandler(ckpt_dir, cfg=cfg, labels=labels)

    def write(path, step, best):
        manager = handler.best if best else handler.last
        state = handler.restore(target, step=step, best=best)
        metrics = _json_item(manager, step, "metrics")
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        from_dsjax_state(path, port_cfg, labels, tree(state.params), tree(state.batch_stats),
                         optimizer_moments(state.opt_state), int(np.asarray(state.step)),
                         int(np.asarray(state.epoch)), metrics, _json_item(manager, step, "extra"))
        return metrics

    try:
        best_steps = list(handler.best.all_steps())
        last_step = handler.last.latest_step()
        if out_path.endswith(".pt"):
            if best_steps:
                write(out_path, handler.best.best_step(), best=True)
                return "best"
            if last_step is None:
                raise FileNotFoundError(f"no restorable checkpoint in {ckpt_dir}")
            write(out_path, last_step, best=False)
            return "last"
        if last_step is None and not best_steps:
            raise FileNotFoundError(f"no restorable checkpoint in {ckpt_dir}")
        for sub in ("last", "best"):
            os.makedirs(os.path.join(out_path, sub), exist_ok=True)
        with open(os.path.join(out_path, "meta.json"), "w") as f:
            json.dump({"format_version": 1, "config": port_config.to_dict(port_cfg),
                       "labels": list(labels)}, f)
        if last_step is not None:
            write(os.path.join(out_path, "last", f"step_{last_step}.pt"), last_step, best=False)
        index = {}
        for step in best_steps:
            index[str(step)] = {k: float(v) for k, v in write(
                os.path.join(out_path, "best", f"step_{step}.pt"), step, best=True).items()}
        with open(os.path.join(out_path, "best", "index.json"), "w") as f:
            json.dump(index, f)
        return " and ".join(name for name, there in (("last", last_step is not None),
                                                       ("best", bool(best_steps))) if there)
    finally:
        handler.close()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt_dir", help="a dsjax checkpoint directory (holds meta.json)")
    parser.add_argument("out_path", help="the dsjax_torch checkpoint directory to write, or "
                                         "with a .pt suffix one checkpoint file")
    args = parser.parse_args()
    which = convert(args.ckpt_dir, args.out_path)
    print(f"wrote {args.out_path} from the {which} checkpoint of {args.ckpt_dir}")


if __name__ == "__main__":
    main()
