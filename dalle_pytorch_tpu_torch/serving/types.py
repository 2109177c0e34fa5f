"""Serving request/response vocabulary (counterpart of
``dalle_pytorch_tpu/serving/types.py``).

Every submitted request ends in exactly ONE ``RequestResult`` whose
``outcome`` is an ``Outcome``: overload and failure are values, not
exceptions. The clock is injectable so deadlines are deterministic in
tests: the engine calls ``tick()`` once per iteration and ``advance()``
when a stall is injected.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np


class Outcome(str, Enum):
    """Terminal state of a submitted request (the outcomes this port's
    engine can produce)."""

    COMPLETED = "completed"
    REJECTED = "rejected"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    CANCELLED = "cancelled"
    # evicted under page pressure more than EngineConfig.max_preemptions
    # times
    PREEMPT_CAP = "preempt_cap"
    # every prefill attempt failed (EngineConfig.prefill_attempts)
    PREFILL_FAILED = "prefill_failed"
    # typed-degraded completions from the post-decode pipeline
    # (serving/postdecode.py): the token work succeeded but a stage was
    # shed by retry exhaustion, backlog or occupancy past the stage
    # watermark; the tokens (and for UNRANKED the image) are complete
    COMPLETED_TOKENS_ONLY = "completed_tokens_only"  # image never decoded
    COMPLETED_UNRANKED = "completed_unranked"        # image, no CLIP score


class RejectReason(str, Enum):
    DEMAND_EXCEEDS_POOL = "demand_exceeds_pool"  # can never fit, even idle
    QUEUE_FULL = "queue_full"                    # bounded admission queue
    # a router's fleet has no live replica: its queue is flushed with this
    # reason rather than left waiting
    NO_REPLICA = "no_replica"


@dataclass(frozen=True)
class Request:
    """One generation request. ``prompt`` is the RAW text-token row
    ((text_seq_len,) int, 0-padded); the engine remaps it and prepends
    <bos>. ``deadline`` is absolute on the engine's clock. ``priority``:
    higher runs first and is evicted last. ``seed`` keys the request's
    private sampling stream: the token at internal position p depends only
    on (seed, p), which is what makes a preempted request's replay
    reproduce its tokens bit-identically."""

    request_id: str
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float] = None
    priority: int = 0
    seed: int = 0


@dataclass
class RequestResult:
    request_id: str
    outcome: Outcome
    # generated image-token ids: complete for COMPLETED, the read-back
    # prefix for deadline/cancel/preempt-cap terminations, None if never
    # prefilled
    tokens: Optional[np.ndarray] = None
    reject_reason: Optional[RejectReason] = None
    preempt_count: int = 0
    # prefill attempts that failed; the request ends PREFILL_FAILED when
    # they reach EngineConfig.prefill_attempts
    prefill_attempts: int = 0
    # set when watermark degradation clamped the request's budget: the
    # response carries the clamp instead of silently generating less
    clamped_max_new_tokens: Optional[int] = None
    queue_latency_s: Optional[float] = None
    # submit -> the first image token read back; a preempted request
    # keeps its first production's (the replay regenerates the token)
    ttft_s: Optional[float] = None
    total_latency_s: Optional[float] = None
    # backoff hint on a load-typed rejection (QUEUE_FULL, NO_REPLICA): how
    # long to wait before retrying, from the occupancy or the earliest
    # pending respawn; None otherwise (DEMAND_EXCEEDS_POOL never fits)
    retry_after_s: Optional[float] = None
    # post-decode pipeline results: the decoded image (H, W, C float32,
    # the VAE's normalized space; ``models.vae.denormalize`` for display)
    # on COMPLETED and COMPLETED_UNRANKED (and on a mid-stage cancel or
    # deadline once the VAE had run), and the CLIP rerank score on
    # reranked COMPLETED requests. Both None without stages.
    image: Optional[np.ndarray] = None
    rerank_score: Optional[float] = None
    detail: str = ""


class Clock:
    """Engine time source: ``now()`` is monotonic, ``tick()`` is called
    once per engine iteration, ``advance(dt)`` jumps time forward (the
    ``decode_stall`` fault)."""

    def now(self) -> float:
        return time.monotonic()

    def tick(self) -> None:
        pass

    def advance(self, dt: float) -> None:
        # real time cannot jump: a stall on the real clock is a sleep
        time.sleep(dt)


@dataclass
class FakeClock(Clock):
    """Deterministic virtual clock: every iteration costs ``step_dt``;
    ``advance`` jumps at once."""

    t: float = 0.0
    step_dt: float = 0.0

    def now(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.step_dt

    def advance(self, dt: float) -> None:
        self.t += dt
