"""The recurrent cells of the reference, one file each:
``reference/cells/<rnn_type>.py``, the file's name the configuration's
``rnn_type``. A recurrent type comes into the reference with its file
alone; nothing here names one.

Each file declares:

  MODULE   the packed float32 layer, a ``torch.nn`` recurrent module whose
           weights are named as deepspeech.pytorch's ``BatchRNN`` holds
           them (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``,
           ``bias_hh_l0``, ``_reverse`` for the second direction);
  GATES    the gates a unit, the rows of ``weight_hh_l0`` over H;
  CARRIES  the tensors carried from step to step, h first;
  update   update(x_t, hp, carries) -> the new carries, h first: one step
           of the cell from the projected input x_t (with b_ih) and the
           recurrent product hp = h W_hh^T + b_hh, each (D, B, GATES * H),
           as the rounded step loop of ``reference/ds2.py`` runs it.
"""

from __future__ import annotations

import importlib
from types import ModuleType


def find(rnn_type: str) -> ModuleType:
    """The cell file of ``rnn_type``."""
    try:
        return importlib.import_module(f"{__name__}.{rnn_type}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{rnn_type}":
            raise
        raise KeyError(f"no reference cell for rnn_type {rnn_type!r}: add "
                       f"portbench/reference/cells/{rnn_type}.py") from None
