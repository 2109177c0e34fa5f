"""The trainers' metrics (counterpart of the part of
``dalle_pytorch_tpu/utils/metrics.py`` that ``train_dalle.py``,
``train_vae.py`` and ``train_clip.py`` use):
named counters, the samples-per-second window and the console logger,
whose lines are JAX's (``step N: loss=... epoch=...``). There is no
process-wide ``Counters``: the command line makes one and hands it to
the tar-shard loader, and each serving engine holds its own
(``Engine.counters``: the ``serve.prefix.*`` and ``serve.spec.*``
tallies). One card is one
process, the root; there is no Weights & Biases sink (``--wandb`` is
refused).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional


class Counters:
    """Thread-safe named counters for fault accounting: the trainer counts
    ``train.nan_skips`` here, the tar-shard loader ``webdata.*``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self, prefix: str = "") -> Dict[str, int]:
        """The counters whose names start with ``prefix``."""
        with self._lock:
            return {k: v for k, v in sorted(self._counts.items()) if k.startswith(prefix)}


class MetricsLogger:
    """Console metrics: ``log`` prints ``step N: k=v ...`` (floats with 5
    significant digits); the run's config is printed first as JSON."""

    def __init__(self, config: Optional[dict] = None):
        if config:
            self.log_text(f"config: {json.dumps(config, default=str)}")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in metrics.items())
        print((f"step {step}: " if step is not None else "") + line, flush=True)

    def log_text(self, text: str) -> None:
        print(text, flush=True)

    def log_histogram(self, name: str, values, step: Optional[int] = None) -> None:
        """A compact summary of ``values``' distribution (the VAE trainer's
        codebook-usage monitor): its size, quantiles and unique count."""
        import numpy as np

        flat = np.asarray(values).reshape(-1)
        qs = np.percentile(flat, [0, 25, 50, 75, 100])
        self.log_text(f"step {step}: {name} histogram n={flat.size} "
                      f"min/q25/med/q75/max={'/'.join(f'{q:g}' for q in qs)} "
                      f"unique={np.unique(flat).size}")

    def log_counters(self, counters: Counters, step: Optional[int] = None,
                     prefix: str = "") -> None:
        """Log ``counters``' nonzero values under ``prefix`` as metrics."""
        snap = {k: v for k, v in counters.snapshot(prefix).items() if v}
        if snap:
            self.log(snap, step=step)


class Throughput:
    """Samples a second over a window of ``window`` steps: ``update``
    returns the rate once a window, None otherwise."""

    def __init__(self, window: int = 10):
        assert window > 0
        self.window = window
        self._t0 = time.perf_counter()
        self._steps = 0
        self._samples = 0

    def update(self, samples: int) -> Optional[float]:
        self._steps += 1
        self._samples += samples
        if self._steps % self.window == 0:
            now = time.perf_counter()
            rate = self._samples / (now - self._t0)
            self._t0, self._samples = now, 0
            return rate
        return None
