"""Training CLI: ``python -m dsjax_torch.train key=value ...`` (the
counterpart of dsjax's root ``train.py``), for example

    python -m dsjax_torch.train data.train_path=train.json data.val_path=val.json \
        data.device_features=false trainer.max_epochs=2

``trainer.device`` defaults to cuda and raises without a card; pass
``trainer.device=cpu`` to train on the CPU. Data-parallel over the cards of
one or more nodes, one process a card, under torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m dsjax_torch.train ...
"""

import sys

from dsjax_torch.config import TrainConfig, compose_cli
from dsjax_torch.workflows import train

if __name__ == "__main__":
    train(compose_cli(TrainConfig, __doc__, sys.argv[1:]))
