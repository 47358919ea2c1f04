"""Loss curves from metrics.jsonl: the port's own copy of
`dpig_tpu/utils/plot.py` (reference tflib/plot.py:15-41 drew matplotlib
curves and a log.pkl for the standalone WGAN demo; here the `Trainer`'s
JSONL stream, `train/harness.py`, is the source).

matplotlib is imported inside `plot_metrics`, as in JAX, and only there:
the card's machine lacks it, so plotting is a host-side step with no
fallback; `load_metrics` needs nothing.

    python -m dpig_tpu_torch.utils.plot <model_dir>   # -> curves.png
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


def load_metrics(model_dir: str) -> Dict[str, List]:
    """{metric: [(step, value), ...]} in file order, every key of each
    record but `step`."""
    path = os.path.join(model_dir, "metrics.jsonl")
    series: Dict[str, List] = defaultdict(list)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step")
            for k, v in rec.items():
                series[k].append((step, v))
    return dict(series)


def plot_metrics(model_dir: str, out_path: Optional[str] = None) -> str:
    """One panel per metric but `imgs_per_sec`, three to a row, written as
    a PNG (default `<model_dir>/curves.png`, 80 dpi); returns its path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = load_metrics(model_dir)
    keys = [k for k in series if k != "imgs_per_sec"]
    ncols = min(3, max(len(keys), 1))
    nrows = (len(keys) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        xs, ys = zip(*series[k])
        ax.plot(xs, ys)
        ax.set_title(k)
        ax.set_xlabel("step")
    fig.tight_layout()
    out_path = out_path or os.path.join(model_dir, "curves.png")
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    import sys
    print(plot_metrics(sys.argv[1]))
