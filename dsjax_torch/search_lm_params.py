"""LM hyper-parameter search over (alpha, beta) for the beam decoder.

Counterpart of dsjax's search_lm_params.py (reference parity:
search_lm_params.py:38-103): minimize CER or WER over the beam decoder's LM
weight alpha and word bonus beta. The acoustic model runs once on the card
(``device``, default ``cuda``) through the port's ``load_model``; each trial
only decodes again, after the decoder's ``reset_params``. optuna is replaced
by TPE-lite (a uniform warmup, then sampling around the elite trials), or an
exhaustive grid whose JSON feeds ``python -m dsjax_torch.select_lm_params``.
With ``device_beam=true`` the trials decode with the device beam, the
``n_jobs`` decoders sharing one packed LM on the card; otherwise with the
native host beam.

    python -m dsjax_torch.search_lm_params model_path=model.pt test_path=val.json \\
        lm_path=3-gram.arpa n_trials=100 output_path=grid.json
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from dsjax_torch.config import compose
from dsjax_torch.data.dataset import SpectrogramDataset, collate
from dsjax_torch.decode.beam import BeamCTCDecoder
from dsjax_torch.decode.greedy import GreedyDecoder
from dsjax_torch.inference import load_model
from dsjax_torch.train.metrics import CharErrorRate, WordErrorRate, update_batch


@dataclass
class OptimizerConfig:
    model_path: str = ""
    test_path: str = ""
    is_character_based: bool = True   # minimize CER (else WER)
    lm_path: str = ""
    beam_width: int = 10
    cutoff_top_n: int = 40            # the same candidate pruning for the
    cutoff_prob: float = 1.0          # host and the device trial decoders
    alpha_from: float = 0.0
    alpha_to: float = 3.0
    beta_from: float = 0.0
    beta_to: float = 1.0
    n_trials: int = 500
    n_jobs: int = 2
    precision: int = 16
    batch_size: int = 8
    num_workers: int = 1
    grid: bool = False                # exhaustive grid instead of TPE-lite
    grid_steps: int = 10
    device_beam: bool = False         # decode the trials with the device beam
    output_path: str = ""             # write [(alpha, beta, wer, cer), ...]
    seed: int = 0
    device: str = "cuda"              # "cpu" only when asked for


class Objective:
    """Evaluates (alpha, beta) -> (wer, cer). The acoustic model runs once;
    a trial only decodes. ``evaluate_many`` runs up to n_jobs trials at once
    (reference parity: optuna n_jobs, search_lm_params.py:95-100), each
    worker with its own decoder."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        bundle = load_model(cfg.model_path, cfg.precision, cfg.device)
        self.labels = bundle.labels
        blank = self.labels.index("_")
        if cfg.device_beam and cfg.lm_path:
            from dsjax_torch.decode.beam_device import DeviceBeamDecoder
            from dsjax_torch.decode.lm_device import DeviceNgramLM

            packed = DeviceNgramLM(cfg.lm_path, self.labels, blank).device(bundle.device)

            # one table set on the card shared by the workers; the pruning
            # of the host decoder, so tuned (alpha, beta) carry over
            def make_decoder():
                return DeviceBeamDecoder(self.labels, beam_width=cfg.beam_width, blank_index=blank,
                                         cutoff_top_n=cfg.cutoff_top_n,
                                         cutoff_prob=cfg.cutoff_prob, shared_lm=packed)
        else:
            def make_decoder():
                return BeamCTCDecoder(self.labels, lm_path=cfg.lm_path or None,
                                      beam_width=cfg.beam_width, num_processes=cfg.num_workers,
                                      cutoff_top_n=cfg.cutoff_top_n,
                                      cutoff_prob=cfg.cutoff_prob, blank_index=blank)
        self.decoder = make_decoder()
        self._pool_decoders = [self.decoder] + [make_decoder()
                                                for _ in range(max(1, cfg.n_jobs) - 1)]
        self.target_decoder = GreedyDecoder(self.labels, blank_index=blank)
        ds = SpectrogramDataset(bundle.spect_cfg, cfg.test_path, self.labels, normalize=True)
        # the posteriors stay on the card for the device beam; the host beam
        # takes them on the host, copied once here rather than every trial
        self.cached: List[Tuple[object, object, List[str]]] = []
        for start in range(0, len(ds), cfg.batch_size):
            samples = [ds[i] for i in range(start, min(start + cfg.batch_size, len(ds)))]
            batch = collate(samples, bucket_frames=64)
            probs, out_lens, _ = bundle.forward(batch.inputs, batch.input_lengths)
            if not cfg.device_beam:
                probs, out_lens = probs.cpu().numpy(), out_lens.cpu().numpy()
            refs = self.target_decoder.convert_to_strings(
                [batch.targets[b, :batch.target_lengths[b]] for b in range(batch.size)])
            self.cached.append((probs, out_lens, [r[0] for r in refs]))

    def _eval(self, decoder, alpha: float, beta: float) -> Tuple[float, float]:
        decoder.reset_params(alpha, beta)
        wer, cer = WordErrorRate(), CharErrorRate()
        for probs, out_lens, refs in self.cached:
            decoded, _ = decoder.decode(probs, out_lens, n_best=1)
            update_batch(wer, cer, [d[0] for d in decoded], refs)
        return wer.compute(), cer.compute()

    def __call__(self, alpha: float, beta: float) -> Tuple[float, float]:
        return self._eval(self.decoder, alpha, beta)

    def evaluate_many(self, points) -> List[Tuple[float, float]]:
        """Evaluate [(alpha, beta), ...] with one decoder a worker (the
        native beam releases the interpreter lock, so threads run at once)."""
        if len(points) <= 1 or len(self._pool_decoders) <= 1:
            return [self(a, b) for a, b in points]
        from concurrent.futures import ThreadPoolExecutor

        results: List[Optional[Tuple[float, float]]] = [None] * len(points)
        n = len(self._pool_decoders)

        def run(k: int) -> None:
            dec = self._pool_decoders[k]
            for i in range(k, len(points), n):
                a, b = points[i]
                results[i] = self._eval(dec, a, b)

        with ThreadPoolExecutor(n) as pool:
            list(pool.map(run, range(n)))
        return results  # type: ignore[return-value]


def tpe_lite(objective: Objective, cfg: OptimizerConfig):
    """Uniform warmup, then gaussian sampling around the elite quantile.
    Proposals come in batches of n_jobs, evaluated concurrently."""
    rng = np.random.default_rng(cfg.seed)
    lo = np.array([cfg.alpha_from, cfg.beta_from])
    hi = np.array([cfg.alpha_to, cfg.beta_to])
    trials: List[Tuple[float, float, float, float]] = []
    n_warmup = max(4, cfg.n_trials // 4)
    batch = max(1, cfg.n_jobs)
    i = 0
    while i < cfg.n_trials:
        k = min(batch, cfg.n_trials - i)
        points = []
        for _ in range(k):
            if i + len(points) < n_warmup or len(trials) < 4:
                x = rng.uniform(lo, hi)
            else:
                key = 3 if cfg.is_character_based else 2
                elite = sorted(trials, key=lambda t: t[key])[: max(2, len(trials) // 4)]
                centers = np.array([[t[0], t[1]] for t in elite])
                c = centers[rng.integers(len(centers))]
                x = np.clip(rng.normal(c, (hi - lo) / 8), lo, hi)
            points.append((float(x[0]), float(x[1])))
        for (a, b), (wer, cer) in zip(points, objective.evaluate_many(points)):
            trials.append((a, b, wer, cer))
            i += 1
            print(f"trial {i}/{cfg.n_trials}: alpha={a:.4f} beta={b:.4f} "
                  f"wer={wer:.3f} cer={cer:.3f}")
    return trials


def grid_search(objective: Objective, cfg: OptimizerConfig):
    alphas = np.linspace(cfg.alpha_from, cfg.alpha_to, cfg.grid_steps)
    betas = np.linspace(cfg.beta_from, cfg.beta_to, cfg.grid_steps)
    points = [(float(a), float(b)) for a in alphas for b in betas]
    trials = []
    for (a, b), (wer, cer) in zip(points, objective.evaluate_many(points)):
        trials.append((a, b, wer, cer))
        print(f"alpha={a:.3f} beta={b:.3f} wer={wer:.3f} cer={cer:.3f}")
    return trials


def main(argv: Optional[List[str]] = None) -> None:
    cfg = compose(OptimizerConfig, argv if argv is not None else sys.argv[1:])
    objective = Objective(cfg)
    trials = grid_search(objective, cfg) if cfg.grid else tpe_lite(objective, cfg)
    key = 3 if cfg.is_character_based else 2
    best = min(trials, key=lambda t: t[key])
    print(f"Best Params\nalpha: {best[0]}\nbeta: {best[1]}\n"
          f"{'cer' if cfg.is_character_based else 'wer'}: {best[key]}")
    if cfg.output_path:
        with open(cfg.output_path, "w") as f:
            json.dump(trials, f)


if __name__ == "__main__":
    main()
