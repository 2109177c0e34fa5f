"""Post-decode request stages: VAE decode, then CLIP rerank, inside the
engine (counterpart of ``dalle_pytorch_tpu/serving/postdecode.py``).

A request whose image tokens have completed does not leave the engine
yet; it moves through typed stages::

    tokens complete -> VAE_DECODE -> [CLIP_RERANK] -> DONE

- **Subordinate to decode.** Stage work is metered by a per-iteration
  stage budget, a ``TokenBudget`` with ``chunk=1`` and a budget in
  images: per engine iteration at most ``budget`` staged images are
  dispatched, in at most one fixed-width batch per stage. Rerank goes
  before VAE (the furthest-along work frees the pipeline fastest); within
  a stage requests go in ``(-priority, seq)`` order.
- **Fixed-width batches.** A partial batch is padded by repeating its
  tail row, so every dispatch has the same shape.
- **Retry.** A dispatch that takes longer than ``timeout_s`` of real
  time fails; the batch's requests are retried after
  ``RetryPolicy.delay`` on the engine's clock.
- **Typed degradation, never unbounded queueing.** Retry exhaustion, a
  full stage backlog, or occupancy past the watermark completes the
  request degraded instead of stalling it: ``COMPLETED_TOKENS_ONLY`` (no
  image yet) or ``COMPLETED_UNRANKED`` (image, no score).
- **Cancel and deadline** reach staged requests too; the typed outcome
  carries the partial results (tokens, and the image once VAE has run).

Each batched dispatch is one telemetry span, ``serve.stage.vae_decode``
or ``serve.stage.clip_rerank`` (its ``_s`` histogram is the stage's
latency), and a completion observes ``serve.stage.request_to_image_s``.
The ``serve.stage.*`` tallies go to the registries ``counters`` and
``histograms`` (the engine's views of the process-wide ones);
``dispatches`` and ``seconds`` count each stage's batched dispatches and
sum their time.

Stage boundaries and resume. ``on_stage(request_id, stage, payload)`` is
called at each completed boundary: ``STAGE_TOKENS`` with
``{"tokens": [ids]}`` when a request enters the pipeline, ``STAGE_VAE``
with ``{"image": ndarray}`` when its image is decoded. A router binds it
to its journal and to its failover state. ``stream_preview(request_id,
stage, value)`` receives the image and then the score as they land.
``enqueue(..., image=, announce=False)`` is the resume path: a request
journaled past VAE enters at CLIP_RERANK with its image, and its
boundaries, already durable, are not announced again.

Faults (``utils.faults``, on the registry ``faults``): ``vae_decode_fail``
and ``rerank_fail`` fail one dispatch of their stage, ``stage_timeout``
one dispatch of either; the batch then takes the retry and degrade path
above (a timeout also counts under ``serve.stage.timeouts``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.image import resize_bilinear
from ..utils.faults import FaultRegistry
from ..utils.metrics import Counters, Histograms
from ..utils.telemetry import TELEMETRY
from .scheduler import Entry, TokenBudget
from .types import Outcome

STAGE_TOKENS = "tokens"
STAGE_VAE = "vae_decode"
STAGE_RERANK = "clip_rerank"


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: retry ``attempt`` (0-based) waits
    ``min(max_delay, base_delay * 2**attempt)``; ``attempts`` counts
    tries in all."""

    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0

    def delay(self, attempt: int) -> float:
        return min(self.max_delay, self.base_delay * (2 ** attempt))


@dataclass(frozen=True)
class StageConfig:
    """Operator knobs of the pipeline. The watermark 1.0 never triggers
    (occupancy is at most 1.0); the backlog cap always bounds queueing."""

    batch: int = 2                  # fixed batch width per stage dispatch
    budget: Optional[int] = None    # images per iteration; None -> batch
    queue_limit: int = 64           # staged backlog cap -> degrade at entry
    high_watermark: float = 1.0     # occupancy past this -> degrade at entry
    retry: RetryPolicy = RetryPolicy(attempts=3, base_delay=0.25, max_delay=2.0)
    timeout_s: float = 30.0         # real-elapsed bound per dispatch
    rerank: bool = True             # run CLIP_RERANK when a CLIP is given

    def __post_init__(self):
        if self.batch < 1 or (self.budget is not None and self.budget < 1):
            raise ValueError(f"batch and budget must be >= 1: {self.batch}, {self.budget}")
        if self.queue_limit < 1 or self.retry.attempts < 1:
            raise ValueError("queue_limit and retry.attempts must be >= 1")


@dataclass(frozen=True)
class StageSpec:
    """The models the stages run: a ``DiscreteVAE`` (required) and an
    optional ``CLIP``, both holding their weights on one device.
    ``clip=None`` or ``config.rerank=False`` skips rerank: requests
    complete with an unscored image."""

    vae: torch.nn.Module
    clip: Optional[torch.nn.Module] = None
    config: StageConfig = StageConfig()


@dataclass
class _Staged:
    """One request parked in the pipeline; it holds no KV pages (the slot
    and its pages were released when its tokens completed)."""

    entry: Entry
    tokens: np.ndarray              # completed image tokens (int32)
    stage: str                      # STAGE_VAE | STAGE_RERANK
    image: Optional[np.ndarray] = None
    attempts: int = 0               # failures at the current stage
    ready_at: float = 0.0           # clock time the next attempt may run


@dataclass
class PostDecodePipeline:
    """Host-side stage queue and batched dispatch, owned by an ``Engine``
    and driven from ``Engine.step()``. ``finish(entry, outcome, tokens,
    image=, rerank_score=, detail=)`` is the sink every staged request
    ends in; ``occupancy()`` the pressure signal of the watermark;
    ``counters`` and ``histograms`` the registries (or views) the
    ``serve.stage.*`` series go to (default: registries of its own);
    ``faults`` the registry of the stage fault sites; ``on_stage`` and
    ``stream_preview`` the boundary hooks (the module docstring)."""

    spec: StageSpec
    clock: object
    finish: Callable
    occupancy: Optional[Callable[[], float]] = None
    counters: Counters = field(default_factory=Counters)
    histograms: Histograms = field(default_factory=Histograms)
    dispatches: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)
    faults: FaultRegistry = field(default_factory=FaultRegistry)
    on_stage: Optional[Callable[[str, str, dict], None]] = None
    stream_preview: Optional[Callable[[str, str, object], None]] = None

    def __post_init__(self):
        self.cfg = self.spec.config
        self.rerank = bool(self.cfg.rerank and self.spec.clip is not None)
        self.device = next(self.spec.vae.parameters()).device
        self._budget = TokenBudget(
            budget=self.cfg.budget if self.cfg.budget is not None else self.cfg.batch,
            chunk=1,
        )
        self._staged: List[_Staged] = []

    def __len__(self) -> int:
        return len(self._staged)

    def __bool__(self) -> bool:
        return bool(self._staged)

    # ------------------------------------------------------------- entry

    def enqueue(self, entry: Entry, tokens: np.ndarray, image: Optional[np.ndarray] = None,
                announce: bool = True) -> None:
        """Park a tokens-complete request at VAE_DECODE, or with ``image``
        (a resumed request whose VAE had run) at CLIP_RERANK;
        ``announce=False`` keeps ``on_stage`` quiet (a resumed request's
        boundaries are already durable)."""
        now = self.clock.now()
        tokens = np.asarray(tokens, np.int32)
        self.counters.inc("serve.stage.enqueued")
        if announce and self.on_stage is not None:
            self.on_stage(entry.request_id, STAGE_TOKENS, {"tokens": [int(t) for t in tokens]})
        st = _Staged(entry=entry, tokens=tokens,
                     stage=STAGE_VAE if image is None else STAGE_RERANK,
                     image=image, ready_at=now)
        occ = self.occupancy() if self.occupancy is not None else 0.0
        if len(self._staged) >= self.cfg.queue_limit:
            self._degrade(st, "stage_backlog")
        elif occ > self.cfg.high_watermark:
            self._degrade(st, "stage_watermark")
        elif st.stage == STAGE_RERANK and not self.rerank:
            self._complete(st, None, now)  # resumed past VAE, nothing left
        else:
            self._staged.append(st)

    # ------------------------------------------------------------ sweeps

    def sweep(self, cancelled_ids, now: float) -> List[str]:
        """End staged requests that were cancelled or whose deadline
        passed, with the partial results they hold. Returns the ids of
        the cancelled ones."""
        hit = []
        for st in list(self._staged):
            rid = st.entry.request_id
            deadline = st.entry.request.deadline
            if rid in cancelled_ids:
                self._staged.remove(st)
                self.finish(st.entry, Outcome.CANCELLED, st.tokens,
                            image=st.image, detail=f"cancelled in {st.stage}")
                hit.append(rid)
            elif deadline is not None and now > deadline:
                self._staged.remove(st)
                self.finish(st.entry, Outcome.DEADLINE_EXCEEDED, st.tokens,
                            image=st.image, detail=f"deadline in {st.stage}")
        return hit

    # ---------------------------------------------------------- dispatch

    def step(self) -> bool:
        """One iteration of stage work under the stage budget: rerank
        first, then VAE."""
        if not self._staged:
            return False
        now = self.clock.now()
        order = sorted(self._staged,
                       key=lambda s: (-s.entry.request.priority, s.entry.seq))
        ready = {stage: [s for s in order if s.stage == stage and s.ready_at <= now]
                 for stage in (STAGE_RERANK, STAGE_VAE)}
        n_rerank = len(ready[STAGE_RERANK])
        take = self._budget.plan_iteration(0, [1] * (n_rerank + len(ready[STAGE_VAE])))
        grants = (sum(take[:n_rerank]), sum(take[n_rerank:]))
        worked = False
        for stage, grant in zip((STAGE_RERANK, STAGE_VAE), grants):
            if grant:
                batch = ready[stage][:min(grant, self.cfg.batch)]
                self._dispatch(stage, batch, now)
                worked = True
        return worked

    def _dispatch(self, stage: str, batch: List[_Staged], now: float) -> None:
        site = "vae_decode_fail" if stage == STAGE_VAE else "rerank_fail"
        if self.faults.take(site):
            self.counters.inc(f"serve.fault_{site}")
            self._retry_or_degrade(batch, now, site)
            return
        if self.faults.take("stage_timeout"):
            self.counters.inc("serve.fault_stage_timeout")
            self.counters.inc("serve.stage.timeouts")
            self._retry_or_degrade(batch, now, "stage_timeout")
            return
        t0 = time.monotonic()
        with TELEMETRY.span(f"serve.stage.{stage}", n=len(batch)):
            if stage == STAGE_VAE:
                out = self.decode_images(self._pad(np.stack([s.tokens for s in batch])))
            else:
                texts = np.stack([self._clip_text(s.entry.request) for s in batch])
                out = self.rerank_scores(self._pad(texts),
                                         self._pad(np.stack([s.image for s in batch])))
        elapsed = time.monotonic() - t0
        self.seconds[stage] = self.seconds.get(stage, 0.0) + elapsed
        self.dispatches[stage] = self.dispatches.get(stage, 0) + 1
        if elapsed > self.cfg.timeout_s:
            self.counters.inc("serve.stage.timeouts")
            self._retry_or_degrade(batch, now, "stage_timeout")
            return
        for i, st in enumerate(batch):
            st.attempts = 0
            rid = st.entry.request_id
            if stage == STAGE_VAE:
                st.image = out[i]
                self.counters.inc("serve.stage.vae_images")
                if self.on_stage is not None:
                    self.on_stage(rid, STAGE_VAE, {"image": st.image})
                if self.stream_preview is not None:
                    self.stream_preview(rid, STAGE_VAE, st.image)
                if self.rerank:
                    st.stage, st.ready_at = STAGE_RERANK, now
                    continue
                score = None
            else:
                self.counters.inc("serve.stage.reranked")
                score = float(out[i])
                if self.stream_preview is not None:
                    self.stream_preview(rid, STAGE_RERANK, score)
            self._staged.remove(st)
            self._complete(st, score, now)

    def _complete(self, st: _Staged, score: Optional[float], now: float) -> None:
        self.histograms.observe("serve.stage.request_to_image_s",
                                max(0.0, now - st.entry.submit_time))
        self.finish(st.entry, Outcome.COMPLETED, st.tokens, image=st.image,
                    rerank_score=score)

    @torch.no_grad()
    def decode_images(self, tokens: np.ndarray) -> np.ndarray:
        """Token ids (S, n) -> pixels (S, H, W, C) float32 on the host."""
        seq = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.spec.vae.decode(seq).float().cpu().numpy()

    @torch.no_grad()
    def rerank_scores(self, texts: np.ndarray, images: np.ndarray) -> np.ndarray:
        """CLIP similarity (S,) of (S, L) text ids and (S, H, W, C) pixels,
        resized to CLIP's resolution first, with the key mask text != 0."""
        clip = self.spec.clip
        text = torch.as_tensor(texts, dtype=torch.long, device=self.device)
        imgs = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        size = clip.visual_image_size
        imgs = resize_bilinear(imgs, size, size)
        return clip(text, imgs, text_mask=text != 0).float().cpu().numpy()

    # ----------------------------------------------------------- helpers

    def _pad(self, rows: np.ndarray) -> np.ndarray:
        """Pad a partial batch to the fixed width by repeating the tail."""
        short = self.cfg.batch - rows.shape[0]
        if short <= 0:
            return rows
        return np.concatenate([rows, np.repeat(rows[-1:], short, axis=0)], axis=0)

    def _clip_text(self, request) -> np.ndarray:
        """The rerank text is the request's own prompt row, truncated or
        zero-padded to CLIP's text length."""
        L = self.spec.clip.text_seq_len
        row = np.zeros((L,), np.int32)
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        n = min(L, prompt.shape[0])
        row[:n] = prompt[:n]
        return row

    def _retry_or_degrade(self, batch: List[_Staged], now: float, why: str) -> None:
        for st in batch:
            st.attempts += 1
            if st.attempts >= self.cfg.retry.attempts:
                self._staged.remove(st)
                self._degrade(st, why)
            else:
                self.counters.inc("serve.stage.retries")
                st.ready_at = now + self.cfg.retry.delay(st.attempts - 1)

    def _degrade(self, st: _Staged, detail: str) -> None:
        self.counters.inc("serve.stage.degraded")
        if st.image is None:
            self.finish(st.entry, Outcome.COMPLETED_TOKENS_ONLY, st.tokens,
                        detail=detail)
        else:
            self.finish(st.entry, Outcome.COMPLETED_UNRANKED, st.tokens,
                        image=st.image, detail=detail)
