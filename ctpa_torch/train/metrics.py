"""Training metrics tracking — JSON-persisted per-step scalars + optional
plots (an own copy of ``ctpa/train/metrics.py``, which imports no JAX; the
port imports nothing of ``ctpa``)."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Optional


class MetricsTracker:
    def __init__(self, path: str, flush_every: int = 50):
        self.path = path
        self.flush_every = flush_every
        self.history: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self.t_start = time.time()
        self._since_flush = 0

    def log(self, step: int, metrics: dict[str, float]):
        for k, v in metrics.items():
            self.history[k].append((step, float(v)))
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def best(self, key: str, mode: str = "min") -> Optional[tuple[int, float]]:
        if key not in self.history or not self.history[key]:
            return None
        fn = min if mode == "min" else max
        return fn(self.history[key], key=lambda sv: sv[1])

    def flush(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        payload = {
            "wall_time_sec": time.time() - self.t_start,
            "metrics": {k: v for k, v in self.history.items()},
        }
        with open(self.path, "w") as f:
            json.dump(payload, f)
        self._since_flush = 0

    def plot(self, out_path: Optional[str] = None, keys: Optional[list[str]] = None):
        """Loss/LR training plots (data_utils.py:166-212 parity)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = keys or list(self.history.keys())
        n = max(len(keys), 1)
        fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.2))
        if n == 1:
            axes = [axes]
        for ax, k in zip(axes, keys):
            pts = self.history.get(k, [])
            if pts:
                xs, ys = zip(*pts)
                ax.plot(xs, ys)
            ax.set_title(k)
            ax.set_xlabel("step")
        fig.tight_layout()
        out_path = out_path or self.path.replace(".json", ".png")
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
