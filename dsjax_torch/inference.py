"""Inference: model loading, the batched and carried forward, decoders,
transcription.

Counterpart of dsjax/inference.py. ``load_model`` reads a ``.pt``/``.ckpt``
file holding a reference-layout state_dict and the hyper-parameters beside
it: the reference's Lightning checkpoints, or what
``dsjax_torch.model.convert.save_checkpoint`` writes (both through
``convert.load_checkpoint``); a dsjax checkpoint directory converts first
with ``tools/dsjax_checkpoint_to_torch.py``. ``ModelBundle`` holds one
replica of the model on each local device (``local_devices``: every
visible card by default) and ``forward`` splits a batch whose size the
replica count divides into row shards, one a device, as dsjax's bundle
shards over its ('data',) mesh, and gathers the posteriors onto the first
device, where they are decoded once; any other batch, and every carried
forward, runs on the first device. ``forward`` takes (B, F, T) features, or
(B, L_pad) raw audio with the STFT on the device before the model.
``load_decoder`` gives the greedy decoder, the device beam search (with an
n-gram LM fused into it under ``lm.device_beam``) or the host beam search
with the LM. The device defaults to ``cuda``; without a CUDA card the caller
must ask for ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsjax_torch.audio.features import FeatureExtractor, features_torch
from dsjax_torch.audio.io import load_audio
from dsjax_torch.config import DecoderType, LMConfig, SpectConfig
from dsjax_torch.decode.beam import BeamCTCDecoder
from dsjax_torch.decode.beam_device import DeviceBeamDecoder
from dsjax_torch.decode.lm import BINARY_MAGIC
from dsjax_torch.decode.greedy import GreedyDecoder
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model.build import build_model
from dsjax_torch.model.convert import (CONVERT_TOOL, from_reference_state_dict, load_checkpoint,
                                       model_from_hparams, plain_hparams, spect_cfg_from)
from dsjax_torch.trace import span


def resolve_device(device: Any) -> torch.device:
    """torch.device for ``device``; refuses CUDA where there is none rather
    than running on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the "
                           "model on the CPU")
    return device


def local_devices(device: Any = "cuda", num_cpu_devices: int = 0) -> List[torch.device]:
    """The replicas' devices that ``device`` names, as dsjax takes
    ``jax.devices()``: ``cuda`` every visible card (cuda:0 .. cuda:N-1),
    ``cuda:k`` that card alone, ``cpu`` one replica or ``num_cpu_devices``
    of them when that is more than 0 (dsjax's fake CPU devices), and a
    list, or a comma-separated string (``cuda:0,cuda:1``), the devices of
    each of its items, where one may repeat (replicas sharing a card, which
    drive the data-parallel path on one card). A CUDA device always carries
    its index."""
    if isinstance(device, str) and "," in device:
        device = [name.strip() for name in device.split(",")]
    if not isinstance(device, (str, torch.device)):
        return [d for item in device for d in local_devices(item)]
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * max(1, num_cpu_devices)
    if device.type != "cuda":
        raise ValueError(f"no replica on {device}: pass cuda, cuda:k or cpu")
    count = torch.cuda.device_count()
    if device.index is None:
        return [torch.device("cuda", i) for i in range(count)]
    if device.index >= count:
        raise ValueError(f"{device}: only {count} CUDA device(s) are visible")
    return [device]


def _to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy, a list or a tensor) on ``device``. A host array bound
    for a card is pinned and copied without blocking: a pageable copy would
    wait for the card's stream, which holds the previous shard's work when
    replicas share the card."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@dataclasses.dataclass
class ModelBundle:
    """The model with one replica on each device of ``local_devices(devices)``
    (``devices`` is anything that takes; a device may repeat). Each
    replica's weights are copied to its device once, here; replicas that
    repeat a device share one module and that device's current stream, so
    their launches run in turn (two whole-card cooperative scans in flight
    on one card would have no co-residency guarantee). ``device`` is the
    first device, where a batch that does not shard runs and where
    ``forward`` returns its results."""
    model: torch.nn.Module
    labels: List[str]
    spect_cfg: SpectConfig
    devices: Any = "cuda"

    def __post_init__(self):
        self.devices = local_devices(self.devices)
        if not self.devices:
            raise ValueError("a ModelBundle needs at least one device")
        self.replicas: Dict[torch.device, torch.nn.Module] = {
            dev: copy.deepcopy(self.model).to(dev).eval()
            for dev in dict.fromkeys(self.devices[1:]) if dev != self.device}
        self.replicas[self.device] = self.model.to(self.device).eval()

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def shards(self, batch: int) -> int:
        """How many row shards ``forward`` splits an uncarried batch of
        ``batch`` rows into: the replica count where it divides the batch
        (dsjax/inference.py:91), else 1."""
        n = len(self.devices)
        return n if n > 1 and batch % n == 0 else 1

    def forward(self, spect, lengths, carry=None):
        """(B, F, T) features, or (B, L_pad) raw audio prepared by
        ``pad_audio_for_device`` (float32 or int16) with the STFT run on the
        device first -> (probs (B, T', C) float32, out_lens (B,), carry),
        all on the first device. ``carry`` is the value returned by the
        previous call of a chunked stream (features only).

        Where ``shards`` splits the batch, contiguous row shards go one to
        each replica: every shard's copy to its device is issued first, then
        each shard's STFT and model on its device's current stream, with no
        host synchronisation between them, and the shards' posteriors and
        out_lens are gathered onto the first device (the copies wait on the
        devices' streams, not the host), where the decoders run once; the
        carry is then None. Otherwise everything runs on the first device.
        The call is an ``infer.forward`` span (``dsjax_torch.trace``)."""
        with span("infer.forward"):
            n = self.shards(len(spect)) if carry is None else 1
            if n == 1:
                return self._forward_on(self.device, spect, lengths, carry)
            rows = len(spect) // n
            parts = [slice(i * rows, (i + 1) * rows) for i in range(n)]
            # every shard on its device before any model work is issued: a
            # copy between cards runs behind the work on the source card's
            # stream
            shards = [(dev, _to_device(spect[p], dev), _to_device(lengths[p], dev))
                      for dev, p in zip(self.devices, parts)]
            outs = []
            for dev, x, lens in shards:
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    outs.append(self._forward_on(dev, x, lens, None))
            first = self.device
            return (torch.cat([p.to(first, non_blocking=True) for p, _, _ in outs]),
                    torch.cat([o.to(first, non_blocking=True) for _, o, _ in outs]), None)

    def _forward_on(self, dev: torch.device, spect, lengths, carry):
        raw = spect.dim() == 2 if isinstance(spect, torch.Tensor) else np.ndim(spect) == 2
        with torch.inference_mode():
            lens = _to_device(lengths, dev).to(torch.int32)
            if raw:
                if carry is not None:
                    raise ValueError("the raw-audio forward starts a new utterance: "
                                     "pass features to carry state")
                x = features_torch(_to_device(spect, dev), lens, self.spect_cfg,
                                   normalize=True)
            else:
                x = _to_device(spect, dev).to(torch.float32)
            return self.replicas[dev](x, lens, carry)


def load_model(model_path: str, precision: int = 32, device: Any = "cuda",
               num_cpu_devices: int = 0) -> ModelBundle:
    """Load a checkpoint written by ``save_checkpoint`` or a reference
    Lightning ``.ckpt``: a reference-layout state_dict with labels and
    spect_cfg among its hyper-parameters (plain data, or omegaconf objects
    read through ``load_checkpoint``'s stubs). The weights' shapes decide a
    DeepSpeech2's architecture (rnn_type, widths, direction, Lookahead
    context); a Conformer's is its recorded model_cfg. The
    replicas go on ``local_devices(device, num_cpu_devices)``. A dsjax
    checkpoint directory (it holds ``meta.json``) raises: convert it
    first."""
    if os.path.isdir(model_path):
        hint = (f"{model_path} holds meta.json: it is a dsjax checkpoint directory. Convert it "
                f"with python {CONVERT_TOOL} {model_path} OUT.pt (needs jax and orbax) and load "
                f"OUT.pt" if os.path.isfile(os.path.join(model_path, "meta.json"))
                else f"{model_path} is a directory, not a checkpoint file")
        raise IsADirectoryError(hint)
    devices = local_devices(device, num_cpu_devices)
    ckpt = load_checkpoint(model_path)
    state = ckpt.get("state_dict", ckpt)
    hparams = plain_hparams(ckpt.get("hyper_parameters")) or {}
    model_cfg, num_classes = model_from_hparams(state, hparams)
    labels = hparams.get("labels")
    if not (isinstance(labels, list) and labels and all(isinstance(c, str) for c in labels)):
        labels = list(DEFAULT_LABELS)
    spect = spect_cfg_from(hparams.get("spect_cfg"))
    dtype = torch.bfloat16 if precision == 16 else torch.float32
    model = build_model(num_classes, spect, model_cfg, dtype=dtype)
    model.load_state_dict(from_reference_state_dict(state))
    return ModelBundle(model, labels, spect, devices)


def load_decoder(labels: Sequence[str], cfg: LMConfig, want_offsets: bool = False):
    """Greedy or beam decoder from config (reference: utils.py:37-54), as
    dsjax's load_decoder chooses:

      * beam without an LM: the beam search on the posteriors' device;
      * beam with an LM and ``lm.device_beam``: the same search with the LM
        packed into device tables and fused into its scan, from an ARPA or
        a DSLMBIN2 file; a DSLMBIN1 binary cannot give device tables (its
        words are one-way hashes), so it warns and takes the host beam;
      * beam with an LM otherwise: the native host beam with the LM
        (``decode.beam.BeamCTCDecoder``, ``lm.lm_workers`` threads).

    ``want_offsets``: the caller shows per-char offsets (transcribe
    offsets=true), so a device beam rebuilds ctcdecode-parity timesteps (one
    posterior copy to the host a decode); WER-only paths keep the emission
    frames."""
    if cfg.decoder_type != DecoderType.beam:
        return GreedyDecoder(labels)
    if not cfg.lm_path:
        return DeviceBeamDecoder(labels, beam_width=cfg.beam_width,
                                 cutoff_top_n=cfg.cutoff_top_n, cutoff_prob=cfg.cutoff_prob,
                                 ctc_offsets=want_offsets)
    if cfg.device_beam:
        with open(cfg.lm_path, "rb") as f:
            is_v1_binary = f.read(8) == BINARY_MAGIC
        if not is_v1_binary:
            return DeviceBeamDecoder(labels, beam_width=cfg.beam_width, lm_path=cfg.lm_path,
                                     alpha=cfg.alpha, beta=cfg.beta,
                                     cutoff_top_n=cfg.cutoff_top_n, cutoff_prob=cfg.cutoff_prob,
                                     ctc_offsets=want_offsets)
        warnings.warn("lm.device_beam=true but the LM is a DSLMBIN1 binary: falling back to "
                      "the host beam. Rebuild the binary with python -m "
                      "dsjax_torch.build_lm_binary (writes DSLMBIN2, which the device beam "
                      "can load) or pass the ARPA file.")
    return BeamCTCDecoder(labels, lm_path=cfg.lm_path, alpha=cfg.alpha, beta=cfg.beta,
                          cutoff_top_n=cfg.cutoff_top_n, cutoff_prob=cfg.cutoff_prob,
                          beam_width=cfg.beam_width, num_processes=cfg.lm_workers)


def run_transcribe(audio_path: str, bundle: ModelBundle, decoder,
                   chunk_size_seconds: float = -1.0, normalize: bool = True,
                   n_best: Optional[int] = None
                   ) -> Tuple[List[List[str]], List[List[np.ndarray]]]:
    """Chunked transcription carrying the RNN state from chunk to chunk;
    chunk_size_seconds <= 0 transcribes in one shot. n_best caps the
    hypotheses per utterance (None = all)."""
    extractor = FeatureExtractor(bundle.spect_cfg, normalize=normalize)
    y = load_audio(audio_path, bundle.spect_cfg.sample_rate)
    carry = None
    outs = []
    for y_chunk in extractor.chunks(y, chunk_size_seconds):
        if len(y_chunk) == 0:
            continue
        spect = extractor(y_chunk)[None]  # (1, F, T)
        probs, _, carry = bundle.forward(spect, [spect.shape[2]], carry)
        outs.append(probs)
    if not outs:
        return [[""]], [[np.zeros((0,), np.int32)]]
    return decoder.decode(torch.cat(outs, dim=1), n_best=n_best)


def decode_results(decoded_output: List[List[str]],
                   decoded_offsets: List[List[np.ndarray]],
                   model_path: str = "", lm_cfg: Optional[LMConfig] = None,
                   offsets: bool = False, top_paths: int = 1) -> Dict[str, Any]:
    """The reference's result JSON."""
    lm_cfg = lm_cfg or LMConfig()
    results: Dict[str, Any] = {
        "output": [],
        "_meta": {
            "acoustic_model": {"path": model_path},
            "language_model": {"path": lm_cfg.lm_path},
            "decoder": {
                "alpha": lm_cfg.alpha,
                "beta": lm_cfg.beta,
                "type": lm_cfg.decoder_type.value,
            },
        },
    }
    for b in range(len(decoded_output)):
        for pi in range(min(top_paths, len(decoded_output[b]))):
            result = {"transcription": decoded_output[b][pi]}
            if offsets:
                result["offsets"] = np.asarray(decoded_offsets[b][pi]).tolist()
            results["output"].append(result)
    return results
