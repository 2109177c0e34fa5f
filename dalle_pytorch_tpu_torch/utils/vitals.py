"""Engine vitals: sliding-window reductions over numbers the serving
engine already produces (counterpart of ``dalle_pytorch_tpu/utils/vitals.py``).

The cumulative series of ``utils/metrics.py`` answer "since start"; the
control loop (``serving/control.py``) needs "over the last few dozen
iterations": the speculative accept rate now, the gap between iterations
now. The engine pushes one sample set of plain numbers per worked
iteration (``observe_iteration``; counters as lifetime values, windowed
here as ring deltas, never reset); ``snapshot`` reduces the live windows
to the dict the controller reads and ``publish`` writes them as the
``serve.vitals.*`` gauges.

``CostLedger`` holds once-per-name FLOP and byte costs of the serving
dispatches, from which ``roofline_frac`` is the fraction of the card's
binding roof an iteration reached. The engine does not charge it (the
JAX package charges each jit with XLA's ``cost_analysis()``, which torch
has no counterpart of), so the gauge reads 0.0 until a charge comes from
the port's own count. ``DEVICE_PEAKS`` is keyed by
``torch.cuda.get_device_name()``: its one entry is the H100's dense bf16
tensor-core rate and HBM rate (NVIDIA's data sheet, the figures
``chip_smoke.py`` bounds its kernels with); any other name has none.
Host-side only: imports nothing of torch.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .metrics import GaugeRing

DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_ps": 3.35e12},
}


def peaks_for(device_name: Optional[str]) -> Optional[Dict[str, float]]:
    """Peak operations/s and memory bytes/s of a card by its name; None
    for a name without an entry (the roofline gauge then stays 0)."""
    if device_name is None:
        return None
    return DEVICE_PEAKS.get(device_name)


class CostLedger:
    """Per-dispatch cost entries of the serving dispatches, charged once
    per name (the first charge wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, float]] = {}

    def charge(self, name: str, flops: float, bytes_accessed: float) -> bool:
        """Record ``name``'s cost; False when it was already charged."""
        with self._lock:
            if name in self._entries:
                return False
            self._entries[name] = {"flops": float(flops), "bytes_accessed": float(bytes_accessed)}
            return True

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def entry(self, name: str) -> Optional[Dict[str, float]]:
        with self._lock:
            e = self._entries.get(name)
            return dict(e) if e is not None else None

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def roofline_frac(self, name: str, dt_s: float,
                      peaks: Optional[Dict[str, float]]) -> float:
        """The binding roof's fraction one dispatch of ``name`` reached
        over ``dt_s`` seconds: max(FLOP/s over peak, bytes/s over peak);
        0.0 when uncharged, without peaks, or over a window of no time."""
        if peaks is None or dt_s <= 0.0:
            return 0.0
        e = self.entry(name)
        if e is None:
            return 0.0
        fracs = []
        if peaks.get("flops"):
            fracs.append(e["flops"] / dt_s / peaks["flops"])
        if peaks.get("bytes_ps"):
            fracs.append(e["bytes_accessed"] / dt_s / peaks["bytes_ps"])
        return max(fracs) if fracs else 0.0


def _window_delta(ring: GaugeRing) -> float:
    """last - first of a ring of cumulative samples: the window's
    increment of a monotone counter."""
    vals = ring.values()
    if len(vals) < 2:
        return 0.0
    return vals[-1] - vals[0]


class Vitals:
    """Sliding-window engine vitals over ``window`` iterations, published
    as ``serve.vitals.*``. One writer (the engine loop); the rings are
    safe for concurrent readers."""

    def __init__(self, window: int = 32, peaks: Optional[Dict[str, float]] = None):
        assert window >= 2, window
        self.window = window
        self.peaks = peaks
        self.ledger = CostLedger()
        # levels, windowed directly
        self._occupancy = GaugeRing(window)
        self._stage_lag = GaugeRing(window)
        self._gap = GaugeRing(window)
        # cumulative counts, windowed as ring deltas
        self._spec_drafted = GaugeRing(window)
        self._spec_accepted = GaugeRing(window)
        self._prefix_hits = GaugeRing(window)
        self._prefix_misses = GaugeRing(window)
        self._deadline_misses = GaugeRing(window)
        self._terminations = GaugeRing(window)
        self._last_now: Optional[float] = None
        self._last_jit: Optional[str] = None
        self._last_dt = 0.0
        self.iterations = 0

    def observe_iteration(self, *, now: float, occupancy: float, stage_queued: float,
                          spec_drafted: float, spec_accepted: float,
                          prefix_hits: float, prefix_misses: float,
                          deadline_misses: float, terminations: float,
                          jit_name: Optional[str] = None) -> None:
        """Push one iteration's samples; the count arguments are lifetime
        values."""
        if self._last_now is not None:
            self._last_dt = max(0.0, now - self._last_now)
            self._gap.push(self._last_dt)
        self._last_now = now
        self._last_jit = jit_name
        self._occupancy.push(occupancy)
        self._stage_lag.push(stage_queued)
        self._spec_drafted.push(spec_drafted)
        self._spec_accepted.push(spec_accepted)
        self._prefix_hits.push(prefix_hits)
        self._prefix_misses.push(prefix_misses)
        self._deadline_misses.push(deadline_misses)
        self._terminations.push(terminations)
        self.iterations += 1

    def snapshot(self) -> Dict[str, float]:
        """The windowed vitals, every key present every time (the
        controller never branches on a key's existence)."""
        drafted = _window_delta(self._spec_drafted)
        accepted = _window_delta(self._spec_accepted)
        hits = _window_delta(self._prefix_hits)
        misses = _window_delta(self._prefix_misses)
        dl = _window_delta(self._deadline_misses)
        terms = _window_delta(self._terminations)
        roofline = 0.0
        if self._last_jit is not None:
            roofline = self.ledger.roofline_frac(self._last_jit, self._last_dt, self.peaks)
        return {
            "iterations": float(self.iterations),
            "spec_accept_rate": accepted / drafted if drafted > 0 else 0.0,
            "spec_drafted": drafted,
            "prefix_hit_frac": hits / (hits + misses) if hits + misses > 0 else 0.0,
            "decode_gap_s": self._gap.window()["max"],
            "stage_lag": self._stage_lag.window()["mean"],
            "deadline_miss_rate": dl / terms if terms > 0 else 0.0,
            "occupancy": self._occupancy.window()["mean"],
            "roofline_frac": roofline,
        }

    def publish(self, gauges) -> Dict[str, float]:
        """Write the snapshot as the ``serve.vitals.*`` gauges (``gauges``:
        the engine's label-bound view) and return it."""
        snap = self.snapshot()
        for key in ("spec_accept_rate", "prefix_hit_frac", "decode_gap_s", "stage_lag",
                    "deadline_miss_rate", "occupancy", "roofline_frac"):
            gauges.set(f"serve.vitals.{key}", snap[key])
        return snap
