#!/usr/bin/env python
"""Convert a dsjax checkpoint directory into a dsjax_torch checkpoint file.

    JAX_PLATFORMS=cpu python tools/dsjax_checkpoint_to_torch.py CKPT_DIR OUT.pt

CKPT_DIR is what dsjax's ``CheckpointHandler`` writes (``meta.json``,
``best/``, ``last/``). The weights are read as dsjax's own ``load_model``
reads them (dsjax/inference.py:126-147): ``load_meta``, then
``CheckpointHandler.restore``, the best checkpoint first and the last one
when there is no best. OUT.pt is written by
``dsjax_torch.model.convert.save_checkpoint`` from
``from_dsjax_variables``, with the labels, the spectrogram config and the
model config of ``meta.json``; ``python -m dsjax_torch.evaluate
model.model_path=OUT.pt ...`` and the port's other entry points load it.
The optimizer state is not converted.

This tool, unlike the port, imports jax, orbax and dsjax: run it where
they are installed (the CPU is enough).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def convert(ckpt_dir: str, out_path: str) -> str:
    """Write ``out_path`` from the dsjax checkpoint directory ``ckpt_dir``;
    returns which checkpoint it took, "best" or "last"."""
    import jax
    import numpy as np

    from dsjax.config import TrainConfig, from_dict
    from dsjax.labels import DEFAULT_LABELS
    from dsjax.train.checkpoint import CheckpointHandler, load_meta
    from dsjax.train.loop import Trainer
    from dsjax_torch import config as port_config
    from dsjax_torch.model.convert import from_dsjax_variables, save_checkpoint

    meta = load_meta(ckpt_dir)
    cfg = from_dict(meta["config"], TrainConfig)
    labels = meta.get("labels") or list(DEFAULT_LABELS)
    state = Trainer(cfg, labels).init_state()
    handler = CheckpointHandler(ckpt_dir, cfg=cfg, labels=labels)
    try:
        try:
            state, which = handler.restore(state, best=True), "best"
        except FileNotFoundError as e:  # no best checkpoint: the last one
            try:
                state, which = handler.restore(state, best=False), "last"
            except FileNotFoundError:
                raise FileNotFoundError(f"no restorable checkpoint in {ckpt_dir}") from e
    finally:
        handler.close()
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    m = cfg.model
    model_cls = (port_config.UniDirectionalConfig if hasattr(m, "lookahead_context")
                 else port_config.BiDirectionalConfig)
    model_cfg = model_cls(**{f: getattr(m, f) for f in model_cls.__dataclass_fields__})
    model_cfg.rnn_type = port_config.RNNType(m.rnn_type.value)
    sp = cfg.data.spect
    spect = port_config.SpectConfig(sample_rate=sp.sample_rate, window_size=sp.window_size,
                                    window_stride=sp.window_stride,
                                    window=port_config.SpectrogramWindow(sp.window.value))
    save_checkpoint(out_path, from_dsjax_variables(variables), model_cfg, spect, labels)
    return which


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt_dir", help="a dsjax checkpoint directory (holds meta.json)")
    parser.add_argument("out_path", help="the dsjax_torch checkpoint file to write")
    args = parser.parse_args()
    which = convert(args.ckpt_dir, args.out_path)
    print(f"wrote {args.out_path} from the {which} checkpoint of {args.ckpt_dir}")


if __name__ == "__main__":
    main()
