"""The one place a model is made from its config: ``build_model`` gives a
``Conformer`` for a ``ConformerConfig`` (``model=conformer``) and a
``DeepSpeech2`` for the recurrent configs. The trainer, ``load_model`` and
the dsjax state converter build through it."""

from __future__ import annotations

from typing import Optional, Union

import torch

from dsjax_torch.config import BiDirectionalConfig, ConformerConfig, SpectConfig
from dsjax_torch.model.conformer import Conformer
from dsjax_torch.model.ds2 import DeepSpeech2

ModelConfig = Union[BiDirectionalConfig, ConformerConfig]


def build_model(num_classes: int, spect_cfg: SpectConfig, model_cfg: ModelConfig,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    cls = Conformer if isinstance(model_cfg, ConformerConfig) else DeepSpeech2
    return cls(num_classes, spect_cfg, model_cfg, dtype=dtype, generator=generator)

