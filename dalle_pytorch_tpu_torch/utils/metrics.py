"""The metrics registries and the trainers' console metrics (counterpart
of ``dalle_pytorch_tpu/utils/metrics.py``).

The process-wide registries ``counters``, ``gauges`` and ``histograms``
hold named series with Prometheus-style labels: a series is (name,
labels), ``serve.pool_occupancy{replica="1"}``. ``child(labels)`` returns
a view with the labels bound (``child(None)`` is the registry itself);
the serving engine writes through such views (``Engine(...,
metric_labels=)``), so engines without labels add into one series. The
trainer counts ``train.nan_skips`` here and hands ``counters`` to the
tar-shard loader; ``utils/telemetry.py`` observes every span's duration
into a ``<span>_s`` histogram and renders all three registries as
Prometheus text. ``GaugeRing`` and ``HistogramCheckpoint`` are the
windowed readers (nothing in the port reads them yet).

The console logger prints JAX's lines (``step N: loss=... epoch=...``);
one card is one process, the root, and there is no Weights & Biases sink
(``--wandb`` is refused).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Dict[str, Any]]) -> LabelSet:
    """The canonical (sorted, stringified) labels of a series."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_series(name: str, labelset: LabelSet) -> str:
    """``name{k="v",...}`` (the bare name without labels), the
    exposition's sample syntax."""
    if not labelset:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labelset)
    return f"{name}{{{inner}}}"


class _ChildView:
    """A registry with labels bound in advance: every call forwards with
    the bound labels under the call's own (the call wins on a shared
    key). Children of children compose."""

    def __init__(self, base, labels: Dict[str, Any]):
        self._base = base
        self._labels = {str(k): str(v) for k, v in labels.items()}

    def _merge(self, labels: Optional[Dict[str, Any]]) -> Dict[str, str]:
        if not labels:
            return self._labels
        return {**self._labels, **{str(k): str(v) for k, v in labels.items()}}

    def child(self, labels: Optional[Dict[str, Any]] = None):
        if not labels:
            return self
        return _ChildView(self._base, self._merge(labels))

    def inc(self, name, n=1, labels=None):
        return self._base.inc(name, n, labels=self._merge(labels))

    def set(self, name, value, labels=None):
        return self._base.set(name, value, labels=self._merge(labels))

    def observe(self, name, value, labels=None, **kw):
        return self._base.observe(name, value, labels=self._merge(labels), **kw)

    def get(self, name, *a, labels=None, **kw):
        return self._base.get(name, *a, labels=self._merge(labels), **kw)


class Counters:
    """Thread-safe named counters with labels (fault accounting and the
    engine's tallies: degradation is counted, not only warned about)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, LabelSet], int] = {}

    def inc(self, name: str, n: int = 1, labels: Optional[Dict[str, Any]] = None) -> int:
        key = (name, _labelset(labels))
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
            return self._counts[key]

    def get(self, name: str, labels: Optional[Dict[str, Any]] = None) -> int:
        with self._lock:
            return self._counts.get((name, _labelset(labels)), 0)

    def total(self, name: str) -> int:
        """The sum over every label variant of ``name``."""
        with self._lock:
            return sum(v for (n, _), v in self._counts.items() if n == name)

    def child(self, labels: Optional[Dict[str, Any]] = None):
        return self if not labels else _ChildView(self, labels)

    def series(self, prefix: str = "") -> List[Tuple[str, LabelSet, int]]:
        """(name, labelset, value) of the series whose names start with
        ``prefix``, sorted."""
        with self._lock:
            return sorted((n, ls, v) for (n, ls), v in self._counts.items()
                          if n.startswith(prefix))

    def snapshot(self, prefix: str = "") -> Dict[str, int]:
        """The series under ``prefix`` by rendered name."""
        return {render_series(n, ls): v for n, ls, v in self.series(prefix)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


counters = Counters()


class Gauges:
    """Named gauges with labels, the last value wins: the engine publishes
    its pool occupancy and queue depths here every iteration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, LabelSet], float] = {}

    def set(self, name: str, value: float, labels: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._values[(name, _labelset(labels))] = float(value)

    def get(self, name: str, default: float = 0.0,
            labels: Optional[Dict[str, Any]] = None) -> float:
        with self._lock:
            return self._values.get((name, _labelset(labels)), default)

    def child(self, labels: Optional[Dict[str, Any]] = None):
        return self if not labels else _ChildView(self, labels)

    def series(self, prefix: str = "") -> List[Tuple[str, LabelSet, float]]:
        with self._lock:
            return sorted((n, ls, v) for (n, ls), v in self._values.items()
                          if n.startswith(prefix))

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        return {render_series(n, ls): v for n, ls, v in self.series(prefix)}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


gauges = Gauges()


class Histogram:
    """A distribution over fixed log-spaced buckets (``per_decade`` a
    factor of 10 over [lo, hi), one overflow bucket above). count, sum,
    min and max are exact; a percentile is the upper bound of the bucket
    holding that rank, capped at the observed maximum (within one bucket
    factor, 10^0.1 by default, of the true order statistic). Thread-safe;
    an observation is a bisect and three adds."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e3, per_decade: int = 10):
        assert 0 < lo < hi and per_decade > 0
        n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
        self.bounds: List[float] = [lo * 10.0 ** (i / per_decade) for i in range(n)]
        self._counts = [0] * (n + 1)  # the last: overflow (+Inf)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """The upper bound of the bucket holding the q-th percentile
        (Prometheus' ``histogram_quantile`` side); the exact maximum for
        the overflow bucket."""
        with self._lock:
            return self._rank_walk(self._counts, self.count, q)

    def _rank_walk(self, counts: List[int], count: int, q: float) -> float:
        if count <= 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * count))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                if i >= len(self.bounds):
                    return self.max
                return min(self.bounds[i], self.max)
        return self.max  # unreachable: the counts sum to count

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": 0.0 if self.count == 0 else self.min,
                "max": 0.0 if self.count == 0 else self.max,
                "p50": self._rank_walk(self._counts, self.count, 50),
                "p95": self._rank_walk(self._counts, self.count, 95),
                "p99": self._rank_walk(self._counts, self.count, 99),
            }

    def buckets(self) -> List[Tuple[float, int]]:
        """(upper bound, cumulative count) up to the last bucket in use,
        then (+Inf, count): the ``_bucket{le=...}`` samples."""
        with self._lock:
            return self._buckets_locked()

    def _buckets_locked(self) -> List[Tuple[float, int]]:
        out: List[Tuple[float, int]] = []
        cum = 0
        last = max((i for i, c in enumerate(self._counts) if c), default=-1)
        for i, c in enumerate(self._counts[:len(self.bounds)]):
            cum += c
            if i <= last:
                out.append((self.bounds[i], cum))
        out.append((math.inf, self.count))
        return out

    def exposition(self) -> Dict[str, Any]:
        """Buckets, sum, count and quantiles from one lock hold, so that a
        scrape's ``_count`` equals its ``le="+Inf"`` bucket."""
        with self._lock:
            return {
                "buckets": self._buckets_locked(),
                "sum": self.sum,
                "count": self.count,
                "quantiles": {q: self._rank_walk(self._counts, self.count, q)
                              for q in (50, 95, 99)},
            }

    def checkpoint(self) -> "HistogramCheckpoint":
        """The cumulative state, frozen for a later ``snapshot_delta`` (a
        window is the reader's subtraction; the series is never reset)."""
        with self._lock:
            return HistogramCheckpoint(counts=tuple(self._counts), count=self.count,
                                       sum=self.sum, max=self.max)

    def snapshot_delta(self, prev: Optional["HistogramCheckpoint"] = None) -> Dict[str, float]:
        """count, sum, mean and p50 / p95 / p99 since ``prev``, over the
        differences of the bucket counts. Without ``prev``, or with one of
        another geometry or newer than the state (a reset registry), the
        whole lifetime. An overflow percentile is the lifetime maximum."""
        with self._lock:
            dc = list(self._counts)
            count, total = self.count, self.sum
            if prev is not None and len(prev.counts) == len(dc):
                cand = [c - p for c, p in zip(dc, prev.counts)]
                if min(cand, default=0) >= 0 and self.count >= prev.count:
                    dc = cand
                    count = self.count - prev.count
                    total = self.sum - prev.sum
            out = {"count": float(count), "sum": total,
                   "mean": total / count if count else 0.0}
            for q in (50, 95, 99):
                out[f"p{q}"] = self._rank_walk(dc, count, q)
            return out


class HistogramCheckpoint:
    """A histogram's cumulative state (bucket counts, count, sum, max)
    frozen in one lock hold, for ``Histogram.snapshot_delta``."""

    __slots__ = ("counts", "count", "sum", "max")

    def __init__(self, counts: Tuple[int, ...], count: int, sum: float, max: float):
        self.counts = counts
        self.count = count
        self.sum = sum
        self.max = max


class GaugeRing:
    """The last ``capacity`` samples of a level (occupancy, queue depth),
    for windows a gauge's last value cannot answer. ``push`` is O(1);
    ``window()`` reduces the live samples in one lock hold."""

    def __init__(self, capacity: int = 64):
        assert capacity >= 1, capacity
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: List[float] = [0.0] * capacity
        self._next = 0
        self._filled = 0

    def push(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._buf[self._next] = v
            self._next = (self._next + 1) % self.capacity
            if self._filled < self.capacity:
                self._filled += 1

    def values(self) -> List[float]:
        """The live samples, oldest first."""
        with self._lock:
            if self._filled < self.capacity:
                return self._buf[:self._filled]
            return self._buf[self._next:] + self._buf[:self._next]

    def window(self) -> Dict[str, float]:
        """count, last, mean, min and max of the live samples (all 0
        before the first push)."""
        with self._lock:
            n = self._filled
            if n == 0:
                return {"count": 0.0, "last": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0}
            live = self._buf[:n] if n < self.capacity else self._buf
            return {"count": float(n), "last": self._buf[(self._next - 1) % self.capacity],
                    "mean": sum(live) / n, "min": min(live), "max": max(live)}


class Histograms:
    """Named histograms with labels, each made at its first observation
    (``hist_kw`` its geometry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, LabelSet], Histogram] = {}

    def observe(self, name: str, value: float, labels: Optional[Dict[str, Any]] = None,
                **hist_kw) -> None:
        key = (name, _labelset(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(**hist_kw)
        h.observe(value)

    def get(self, name: str, labels: Optional[Dict[str, Any]] = None) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get((name, _labelset(labels)))

    def child(self, labels: Optional[Dict[str, Any]] = None):
        return self if not labels else _ChildView(self, labels)

    def series(self, prefix: str = "") -> List[Tuple[str, LabelSet, Histogram]]:
        with self._lock:
            return sorted(((n, ls, h) for (n, ls), h in self._hists.items()
                           if n.startswith(prefix)), key=lambda t: (t[0], t[1]))

    def snapshot(self, prefix: str = "") -> Dict[str, Dict[str, float]]:
        return {render_series(n, ls): h.snapshot() for n, ls, h in self.series(prefix)}

    def items(self) -> List[Tuple[str, Histogram]]:
        """(rendered name, histogram) pairs."""
        return [(render_series(n, ls), h) for n, ls, h in self.series()]

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


histograms = Histograms()


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
