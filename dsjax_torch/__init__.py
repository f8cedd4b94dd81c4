"""dsjax_torch — the PyTorch/CUDA port of dsjax for one NVIDIA Hopper card.

The JAX package ``dsjax`` is the reference; each module here mirrors the
dsjax module of the same name and is held against it by a CPU test
(``tests/test_torch_*.py``). Plain tensor code is PyTorch. The Pallas TPU
kernels become kernels written by hand for sm_90a under ``csrc/``, built
with nvcc at first use (``dsjax_torch.ops._build``).

Four paths are ported, for every model dsjax supports (LSTM, GRU or
vanilla RNN layers; bidirectional, or unidirectional with Lookahead):
  * serving: host STFT features, the DeepSpeech2 forward (the LSTM and GRU
    recurrences run in ``csrc/lstm_fwd.cu`` and ``csrc/gru_fwd.cu``),
    greedy or beam CTC decoding and the HTTP server
    (``python -m dsjax_torch.server model.model_path=...``);
  * training, with the STFT on the device from raw audio or on the host:
    CTC, the backward through the recurrent layers (the forwards saving
    residuals, ``csrc/lstm_bwd.cu`` and ``csrc/gru_bwd.cu``), AdamW or SGD,
    validation and checkpoints the server loads
    (``python -m dsjax_torch.train ...``), on one card or data-parallel on
    several, one process a card under torchrun (``parallel/``:
    ``python -m torch.distributed.run --nproc_per_node N -m
    dsjax_torch.train ...``);
  * evaluation and transcription (``python -m dsjax_torch.evaluate ...``,
    ``python -m dsjax_torch.transcribe ...``): WER/CER over a manifest and
    the result JSON of a file, greedy or with the device beam search,
    whose top-k runs in ``csrc/topk.cu`` and whose whole no-LM scan can
    run in ``csrc/beam_scan.cu``;
  * n-gram LM decoding (``lm.lm_path``): the LM packed into device hash
    tables and fused into the beam scan (``lm.device_beam=true``), or the
    native host beam with the LM; the tuner
    (``python -m dsjax_torch.search_lm_params``, ``select_lm_params``) and
    ``python -m dsjax_torch.build_lm_binary``.

The package never imports jax. Importing it builds and loads nothing.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy public API: submodules load on first use."""
    api = {
        "DeepSpeech2": ("dsjax_torch.model.ds2", "DeepSpeech2"),
        "BeamCTCDecoder": ("dsjax_torch.decode.beam", "BeamCTCDecoder"),
        "DeviceBeamDecoder": ("dsjax_torch.decode.beam_device", "DeviceBeamDecoder"),
        "GreedyDecoder": ("dsjax_torch.decode.greedy", "GreedyDecoder"),
        "ModelBundle": ("dsjax_torch.inference", "ModelBundle"),
        "load_model": ("dsjax_torch.inference", "load_model"),
        "lstm_scan": ("dsjax_torch.ops.lstm", "lstm_scan"),
        "gru_scan": ("dsjax_torch.ops.gru", "gru_scan"),
        "ServerConfig": ("dsjax_torch.config", "ServerConfig"),
        "TrainConfig": ("dsjax_torch.config", "TrainConfig"),
        "Trainer": ("dsjax_torch.train.loop", "Trainer"),
        "compose": ("dsjax_torch.config", "compose"),
    }
    if name in api:
        import importlib

        module, attr = api[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'dsjax_torch' has no attribute {name!r}")
