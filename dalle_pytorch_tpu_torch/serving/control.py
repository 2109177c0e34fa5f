"""Deterministic adaptive control over the engine's vitals (counterpart
of ``dalle_pytorch_tpu/serving/control.py``).

The knobs the controller moves, and the channel each moves through:

==================  ====================================================
knob                channel
==================  ====================================================
``spec_k``          the verify row's width (the ``length`` descriptor),
                    within the ceiling ``config.spec_k`` the engine sized
                    its block and shift rings for; exact acceptance keeps
                    the tokens plain decode's at any width
``token budget``    the engine's ``TokenBudget`` is replaced by one of
                    another budget at the same chunk width: the grants
                    move, the chunk shapes do not
``watermark``       the occupancy past which admissions are clamped
                    (host arithmetic)
``prefix share``    a target of index pages, reached through the index's
                    own LRU eviction of unreferenced pages
==================  ====================================================

The controller is a pure function of its inputs: the same sequence of
vitals windows gives the same sequence of decisions (no clock, no
randomness), so the ``serve.control.decision`` events replay. The
``control_stall`` fault makes an evaluation raise ``ControlStall``; the
engine then resets every knob to its static default, counted, and decode
goes on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.faults import FaultRegistry


@dataclass(frozen=True)
class ControlConfig:
    """Thresholds of the decision ladder; every comparison strict, every
    knob with a down and an up threshold (explicit hysteresis)."""

    # cadence, in worked engine iterations
    interval: int = 8
    # spec_k: the windowed accept rate against the ceiling
    spec_accept_low: float = 0.45   # below: one step narrower
    spec_accept_high: float = 0.85  # at or above: one step wider
    spec_min_drafts: int = 4        # drafts in the window before adapting
    # token budget: the windowed largest gap between iterations
    gap_high_s: float = 0.25        # above: one chunk tighter
    gap_low_frac: float = 0.5       # below gap_high_s * this: one chunk looser
    budget_min_frac: float = 0.5    # floor, a fraction of the default
    # watermark: the windowed deadline-miss rate
    miss_rate_high: float = 0.25    # above: clamp the watermark
    miss_rate_low_frac: float = 0.5  # below miss_rate_high * this: restore
    watermark_clamp: float = 0.5
    # prefix share: the windowed mean occupancy
    occupancy_shed: float = 0.9     # above: shed index pages to the minimum
    occupancy_restore_frac: float = 0.5  # below occupancy_shed * this: stop
    prefix_pages_min: int = 0
    # decisions kept in the log (the oldest dropped)
    max_log: int = 4096


@dataclass(frozen=True)
class Decision:
    """One evaluation: the vitals it read, the knobs it chose, and why."""

    iteration: int
    vitals: Dict[str, float]
    knobs: Dict[str, Optional[float]]
    changed: bool
    stalled: bool = False
    reasons: Tuple[str, ...] = ()


class ControlStall(RuntimeError):
    """An evaluation failed (the ``control_stall`` fault, or a fault of
    the ladder); the engine degrades to the static defaults."""


class Controller:
    """Vitals -> knobs with explicit state. The constructor pins the
    static defaults; ``evaluate`` walks the ladder; ``reset`` restores the
    defaults. The engine applies the knobs: this class never touches it.
    ``faults``: the registry of the ``control_stall`` site."""

    def __init__(self, config: ControlConfig, *, spec_k_ceiling: Optional[int] = None,
                 budget_default: Optional[int] = None, chunk: int = 1,
                 watermark_default: float = 0.85, prefix_enabled: bool = False,
                 faults: Optional[FaultRegistry] = None):
        assert config.interval >= 1, config.interval
        self.config = config
        self.spec_k_ceiling = spec_k_ceiling
        self.budget_default = budget_default
        self.chunk = max(1, int(chunk))
        self.watermark_default = float(watermark_default)
        self.prefix_enabled = prefix_enabled
        self.faults = faults if faults is not None else FaultRegistry()
        self.log: List[Decision] = []
        self._knobs = self.defaults()

    def defaults(self) -> Dict[str, Optional[float]]:
        """The static knob values: the controller-off state and the stall
        target (a prefix target of None keeps the configured arena)."""
        return {
            "spec_k": None if self.spec_k_ceiling is None else float(self.spec_k_ceiling),
            "budget": None if self.budget_default is None else float(self.budget_default),
            "watermark": self.watermark_default,
            "prefix_pages_target": None,
        }

    @property
    def knobs(self) -> Dict[str, Optional[float]]:
        return dict(self._knobs)

    def reset(self) -> None:
        self._knobs = self.defaults()

    def record_stall(self, iteration: int, vitals: Dict[str, float]) -> Decision:
        """Log the degrade-to-defaults decision of a stall (after
        ``reset``)."""
        d = Decision(iteration=iteration, vitals=dict(vitals), knobs=self.knobs,
                     changed=True, stalled=True, reasons=("control_stall",))
        self._append(d)
        return d

    def evaluate(self, iteration: int, vitals: Dict[str, float]) -> Decision:
        """Walk the ladder over one vitals snapshot; ``ControlStall`` when
        the fault site fires."""
        if self.faults.take("control_stall"):
            raise ControlStall("control_stall fault armed")
        cfg = self.config
        k = dict(self._knobs)
        reasons: List[str] = []

        # 1) the verify width follows the windowed accept rate
        if k["spec_k"] is not None and vitals.get("spec_drafted", 0.0) >= cfg.spec_min_drafts:
            rate = vitals.get("spec_accept_rate", 0.0)
            cur = int(k["spec_k"])
            if rate < cfg.spec_accept_low and cur > 1:
                k["spec_k"] = float(cur - 1)
                reasons.append("spec_down")
            elif rate >= cfg.spec_accept_high and cur < self.spec_k_ceiling:
                k["spec_k"] = float(cur + 1)
                reasons.append("spec_up")

        # 2) the token budget bounds prefill's share by the decode gap
        if k["budget"] is not None:
            gap = vitals.get("decode_gap_s", 0.0)
            cur_b = int(k["budget"])
            floor = max(self.chunk, int(self.budget_default * cfg.budget_min_frac))
            if gap > cfg.gap_high_s and cur_b > floor:
                k["budget"] = float(max(floor, cur_b - self.chunk))
                reasons.append("budget_down")
            elif gap <= cfg.gap_high_s * cfg.gap_low_frac and cur_b < self.budget_default:
                k["budget"] = float(min(self.budget_default, cur_b + self.chunk))
                reasons.append("budget_up")

        # 3) the watermark clamps admissions earlier while deadlines miss
        miss = vitals.get("deadline_miss_rate", 0.0)
        if miss > cfg.miss_rate_high:
            if k["watermark"] > cfg.watermark_clamp:
                k["watermark"] = cfg.watermark_clamp
                reasons.append("watermark_clamp")
        elif miss <= cfg.miss_rate_high * cfg.miss_rate_low_frac:
            if k["watermark"] != self.watermark_default:
                k["watermark"] = self.watermark_default
                reasons.append("watermark_restore")

        # 4) the prefix arena sheds pages under sustained occupancy
        if self.prefix_enabled:
            occ = vitals.get("occupancy", 0.0)
            if occ > cfg.occupancy_shed:
                if k["prefix_pages_target"] != float(cfg.prefix_pages_min):
                    k["prefix_pages_target"] = float(cfg.prefix_pages_min)
                    reasons.append("prefix_shed")
            elif occ <= cfg.occupancy_shed * cfg.occupancy_restore_frac:
                if k["prefix_pages_target"] is not None:
                    k["prefix_pages_target"] = None
                    reasons.append("prefix_restore")

        changed = k != self._knobs
        self._knobs = k
        d = Decision(iteration=iteration, vitals=dict(vitals), knobs=dict(k),
                     changed=changed, reasons=tuple(reasons))
        self._append(d)
        return d

    def _append(self, d: Decision) -> None:
        self.log.append(d)
        if len(self.log) > self.config.max_log:
            del self.log[: len(self.log) - self.config.max_log]
