"""Pick, and optionally plot, the best (alpha, beta) of a search_lm_params
JSON (reference parity: select_lm_params.py:12-40; the counterpart of
dsjax's select_lm_params.py).

    python -m dsjax_torch.select_lm_params --input-path grid.json [--output-plot wer.png]

The JSON holds [alpha, beta, WER, CER] rows; the row of least WER is
printed. ``--output-plot`` needs matplotlib, imported only then.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

import numpy as np


def select(results: Sequence[Sequence[float]]) -> Sequence[float]:
    """The (alpha, beta, WER, CER) row of least WER (the first of equals)."""
    return min(results, key=lambda x: x[2])


def plot(results: Sequence[Sequence[float]], path: str) -> None:
    """The WER surface of a grid, or a scatter of TPE trials, as a PNG."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--output-plot needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    alpha, beta, *_ = list(zip(*results))
    alphas = np.array(sorted(set(alpha)))
    betas = np.array(sorted(set(beta)))
    table = {(a, b): (w, c) for a, b, w, c in results}
    if all((a, b) in table for a in alphas for b in betas):
        x, y = np.meshgrid(alphas, betas)
        wer = np.array([[table[(a, b)][0] for a in alphas] for b in betas])
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.plot_surface(x, y, wer, cmap="rainbow", linewidth=0, antialiased=False)
        ax.set_xlabel("Alpha")
        ax.set_ylabel("Beta")
        ax.set_zlabel("WER")
    else:  # scattered trials (TPE mode)
        fig, ax = plt.subplots()
        sc = ax.scatter(alpha, beta, c=[r[2] for r in results], cmap="rainbow")
        fig.colorbar(sc, label="WER")
        ax.set_xlabel("Alpha")
        ax.set_ylabel("Beta")
    plt.savefig(path, dpi=120)
    print(f"saved plot to {path}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Select the best parameters based on the WER")
    parser.add_argument("--input-path", type=str, required=True,
                        help="Output json file from search_lm_params")
    parser.add_argument("--output-plot", type=str, default="",
                        help="Optional path to save the WER surface plot (png)")
    args = parser.parse_args(argv)
    with open(args.input_path) as f:
        results = json.load(f)
    print("Alpha: %f \nBeta: %f \nWER: %f\nCER: %f" % tuple(select(results)))
    if args.output_plot:
        plot(results, args.output_plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
