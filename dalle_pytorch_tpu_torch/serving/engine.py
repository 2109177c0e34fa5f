"""Continuous-batching serving engine, fused ragged iteration (counterpart
of ``dalle_pytorch_tpu/serving/engine.py`` with
``EngineConfig(fused_iteration=True, prefill_chunk=c)``; here the fused
iteration is the only mode).

Request lifecycle: submit -> [rejected] | queued -> admitted (slot and
prompt pages claimed) -> prefilling (one chunk per iteration under the
``TokenBudget``) -> decoding (one token per iteration) -> completed |
deadline_exceeded | cancelled | preempt_cap, with preempted -> queued
again on the way. With ``stages`` (``postdecode.StageSpec``)
a request whose tokens complete releases its slot and pages and moves
through the post-decode stages (VAE decode, then CLIP rerank) before it
ends COMPLETED with an image and a score, or typed-degraded
(``Outcome.COMPLETED_TOKENS_ONLY`` / ``COMPLETED_UNRANKED``).

The engine owns ONE batched paged decode cache of ``max_batch`` slots.
Each iteration is a single ragged block through ``DALLE.fused_step``:
every cache row gets a (start, length, final) descriptor padded to the
chunk width, prefilling rows write their chunk directly into their row of
the batched cache (chunks are gathered on the device from a prompts
buffer), decoding rows ride the same block, and every layer's attention
runs the ragged paged-attention kernel over all rows at once.

One-step lookahead (``decode_lookahead``): iteration N+1 is dispatched
before iteration N's samples are read back; a decode row's input token is
the previous iteration's still-on-device sample. Completion is
count-based, so the host needs no token values to schedule; cancellation
and deadlines take effect at readback (a sample in flight for a
terminated request is dropped).

Sampling contract: the token at internal position p of a request is a
pure function of (seed, p) and the logits (``models.sampling.sample``),
so a request's tokens do not depend on the batch around it.

Page pressure (``page_budget`` below every slot's full sequence).
Admission is optimistic: a request is admitted when the worst-case pages
of the budget it would receive fit the free pages at that moment, and
pages are claimed lazily, so decode growth can still find the pool
empty. Growth then preempts (``_alloc_or_preempt``): the running slot of
lowest effective priority, youngest admission first, releases its pages
and zeroes its cache row; its request is requeued with its tokens
discarded and aged by ``preempt_priority_boost``, and its replay
reproduces them bit-identically by the sampling contract. Past
``max_preemptions`` evictions it ends ``Outcome.PREEMPT_CAP``. Watermark
degradation: a request admitted while the pool's occupancy is above
``high_watermark`` has its budget clamped to ``degraded_max_new_tokens``
(reported as ``RequestResult.clamped_max_new_tokens``).

KV storage (``kv_quant``): "none" keeps K/V pages in the model's dtype,
"int8" stores int8 pages with per-(token, head) float32 scale pages,
about half the bytes per slot (``kv_bytes_per_slot``); every layer's
"full" attention then runs the ragged kernel's int8 instance.

The model may have any of the ported attention types; non-"full" layers
decode through the gathered cache view (``ops/attention.py``).

Not ported yet: the split prefill/decode path, speculative decoding, the
prefix cache, the journal, vitals and the controller, fault injection,
prefill retries and telemetry (``EngineConfig`` has no field for them,
so asking for one is a ``TypeError``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dalle import DALLE, top_k_filter
from ..models.sampling import init_decode_cache, sample
from ..ops import kv_policy
from .postdecode import PostDecodePipeline, StageSpec
from .scheduler import Entry, PagePool, Scheduler, TokenBudget, pages_for
from .types import Clock, Outcome, RejectReason, Request, RequestResult


@dataclass(frozen=True)
class EngineConfig:
    """Operator knobs of the fused ragged iteration."""

    max_batch: int = 4
    # logical page budget; None = full physical capacity (B * pages/slot)
    page_budget: Optional[int] = None
    queue_limit: int = 64
    filter_thres: float = 0.9
    temperature: float = 1.0
    # prompt tokens per chunk = the fused block width (>= 2)
    prefill_chunk: int = 16
    # tokens per iteration shared by decode and prefill chunks;
    # None = max_batch + prefill_chunk
    token_budget: Optional[int] = None
    decode_lookahead: bool = True
    # KV page rows; None = kv_policy.DEFAULT_PAGE_SIZE
    page_size: Optional[int] = None
    # KV page storage (kv_policy.QUANTS); None = "none"
    kv_quant: Optional[str] = None
    # pool occupancy above which newly admitted requests are clamped to
    # degraded_max_new_tokens (None: no clamp)
    high_watermark: float = 0.85
    degraded_max_new_tokens: Optional[int] = None
    # evictions a request survives; one more ends it PREEMPT_CAP
    max_preemptions: int = 3
    # effective-priority gain per eviction (preemption aging)
    preempt_priority_boost: int = 1


_PREFILL = "prefill"
_DECODE = "decode"


class _Slot:
    """A running request bound to one cache row. Phase ``prefill``:
    ``filled`` prompt positions written so far. Phase ``decode``: ``tok``
    is the last sampled token (not yet cached) at position ``pos``;
    ``tok_on_device`` means it is still only in the in-flight samples."""

    def __init__(self, entry: Entry, index: int, admit_seq: int):
        self.entry = entry
        self.index = index
        self.admit_seq = admit_seq
        self.phase = _PREFILL
        self.filled = 0
        self.pos = 0
        self.tok = -1
        self.tok_on_device = False


class Engine:
    """See the module docstring. Host-side state machine + one device cache."""

    def __init__(self, dalle: DALLE, config: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None, device="cuda",
                 stages: Optional[StageSpec] = None):
        if config.prefill_chunk < 2:
            raise ValueError(
                f"the fused iteration needs prefill_chunk >= 2 (the block "
                f"width), got {config.prefill_chunk}"
            )
        self.kv_quant = kv_policy.resolve_quant(config.kv_quant)
        self.device = torch.device(device)
        if dalle.device.type != self.device.type:
            raise ValueError(
                f"the model lives on {dalle.device}, the engine was asked "
                f"for {self.device}"
            )
        self.dalle = dalle
        self.config = config
        self.clock = clock or Clock()

        B = config.max_batch
        self.page = kv_policy.page_size(config.page_size)
        self.T = dalle.text_len_internal
        self.n_pages_slot = pages_for(self.T + dalle.image_seq_len, self.page)
        full = B * self.n_pages_slot
        self.pool = PagePool(full if config.page_budget is None else config.page_budget)
        self.sched = Scheduler(config.queue_limit, config.preempt_priority_boost)
        self.budget = TokenBudget(
            budget=(config.token_budget if config.token_budget is not None
                    else B + config.prefill_chunk),
            chunk=config.prefill_chunk,
        )
        self.cache = init_decode_cache(dalle, B, "paged", kv_quant=self.kv_quant,
                                       page_size=self.page)
        # bytes of K/V storage (content and scale pools) per slot row, from
        # the pool tensors themselves (the sink page excluded)
        self.kv_bytes_per_slot = sum(
            self.n_pages_slot * pool[0].numel() * pool.element_size()
            for kv in self.cache.kv for pool in kv.pools()
        )
        self._W = config.prefill_chunk
        self._prompts = torch.zeros((B, self.T), dtype=torch.int32,
                                    device=self.device)
        self._zero_tok = torch.zeros((B,), dtype=torch.int32,
                                     device=self.device)
        # top-k count from the FULL vocab, applied to image-only logits
        self.k_img = max(int((1 - config.filter_thres) * dalle.total_tokens), 1)

        self.slots: List[Optional[_Slot]] = [None] * B
        self.results: Dict[str, RequestResult] = {}
        self._live: set = set()
        self._cancel_requested: set = set()
        self._seq = 0
        self._admit_seq = 0
        # in-flight iteration awaiting readback: (device samples,
        # [(slot, kind)]); read back one iteration late with lookahead
        self._pending: Optional[Tuple[torch.Tensor, list]] = None
        self.dispatches = 0
        self.iterations = 0
        # post-decode stages: completed token work enters the pipeline
        # (holding no slot or pages) and stays live until a stage outcome
        self.postdecode: Optional[PostDecodePipeline] = None
        if stages is not None:
            self.postdecode = PostDecodePipeline(
                stages, self.clock, self._finish,
                occupancy=lambda: self.pool.occupancy,
            )

    # ------------------------------------------------------------ public

    def submit(self, request: Request) -> Optional[RequestResult]:
        """Queue a request; returns the result at once on a typed reject,
        else None (the result lands in ``self.results``)."""
        if not (0 < request.max_new_tokens <= self.dalle.image_seq_len):
            raise ValueError(
                f"max_new_tokens must be in [1, {self.dalle.image_seq_len}], "
                f"got {request.max_new_tokens}"
            )
        if request.request_id in self.results or request.request_id in self._live:
            raise ValueError(f"duplicate request_id {request.request_id!r}")
        entry = Entry(request=request, submit_time=self.clock.now(),
                      seq=self._seq)
        self._seq += 1
        if self._worst_case_pages(request.max_new_tokens) > self.pool.total:
            return self._reject(entry, RejectReason.DEMAND_EXCEEDS_POOL)
        if not self.sched.submit(entry):
            return self._reject(entry, RejectReason.QUEUE_FULL)
        self._live.add(request.request_id)
        return None

    def cancel(self, request_id: str) -> None:
        """Request cancellation; takes effect at the next iteration."""
        self._cancel_requested.add(request_id)

    def step(self) -> bool:
        """One iteration: terminations -> admission -> one fused dispatch
        (plus the previous one's readback) -> budgeted stage work. False
        when fully idle."""
        self._sweep_terminations()
        self._admit()
        worked = self._fused_iteration()
        if self.postdecode is not None:
            worked = self.postdecode.step() or worked
        if worked:
            self.iterations += 1
        self.clock.tick()
        return (worked or bool(self.sched) or any(self.slots)
                or bool(self.postdecode))

    def run(self, max_steps: Optional[int] = None) -> Dict[str, RequestResult]:
        """Drive until idle; ``max_steps`` is a safety valve that raises."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine made no terminal progress in {max_steps} steps"
                )
        return self.results

    # ------------------------------------------------------ terminations

    def _sweep_terminations(self) -> None:
        now = self.clock.now()
        for rid in list(self._cancel_requested):
            entry = self.sched.remove(rid)
            if entry is not None:
                self._cancel_requested.discard(rid)
                self._finish(entry, Outcome.CANCELLED, tokens=None)
        for slot in list(self.slots):
            if slot and slot.entry.request_id in self._cancel_requested:
                self._cancel_requested.discard(slot.entry.request_id)
                self._release_slot(slot)
                self._finish(slot.entry, Outcome.CANCELLED,
                             tokens=self._partial_tokens(slot))
        if self.postdecode is not None:
            for rid in self.postdecode.sweep(self._cancel_requested, now):
                self._cancel_requested.discard(rid)
        self._cancel_requested &= self._live
        for entry in self.sched.expired(now):
            self._finish(entry, Outcome.DEADLINE_EXCEEDED, tokens=None)
        for slot in list(self.slots):
            d = slot.entry.request.deadline if slot else None
            if slot and d is not None and now > d:
                self._release_slot(slot)
                self._finish(slot.entry, Outcome.DEADLINE_EXCEEDED,
                             tokens=self._partial_tokens(slot))

    @staticmethod
    def _partial_tokens(slot: _Slot) -> Optional[np.ndarray]:
        if slot.phase == _PREFILL:
            return None
        return np.asarray(slot.entry.generated, np.int32)

    # --------------------------------------------------------- admission

    def _admit(self) -> None:
        while True:
            free = [i for i, s in enumerate(self.slots) if s is None]
            entry = self.sched.peek()
            if not free or entry is None:
                return
            # strict head-of-line on the worst-case page demand of the
            # budget the request would actually receive
            eff_max_new, clamped = self._clamped_budget(entry.request.max_new_tokens)
            if self._worst_case_pages(eff_max_new) > self.pool.free:
                return
            entry = self.sched.pop()
            entry.effective_max_new, entry.clamped = eff_max_new, clamped
            ok = self.pool.alloc(entry.request_id, pages_for(self.T, self.page))
            assert ok, "admission checked worst-case > prompt pages"
            idx = free[0]
            entry.admit_time = self.clock.now()
            prompt = torch.as_tensor(np.asarray(entry.request.prompt),
                                     dtype=torch.int32)[None]
            self._prompts[idx] = self._to_device(
                self.dalle.remap_text(prompt)[0].numpy()
            )
            self.slots[idx] = _Slot(entry, idx, self._admit_seq)
            self._admit_seq += 1

    def _clamped_budget(self, want: int) -> Tuple[int, bool]:
        """(effective max_new_tokens, clamped?) under watermark
        degradation: clamped while the pool's occupancy is above
        ``high_watermark``."""
        cfg = self.config
        if (cfg.degraded_max_new_tokens is not None
                and self.pool.occupancy > cfg.high_watermark
                and want > cfg.degraded_max_new_tokens):
            return cfg.degraded_max_new_tokens, True
        return want, False

    def _worst_case_pages(self, max_new: int) -> int:
        # positions written: the prompt plus every generated token but
        # the last (a sampled token is cached when the next step consumes it)
        return pages_for(self.T + max_new - 1, self.page)

    # --------------------------------------------------- fused iteration

    def _next_chunk(self, filled: int) -> int:
        return min(self.config.prefill_chunk, self.T - filled)

    def _plan_fused_prefills(self, decode_tokens: int) -> List[Tuple[_Slot, int]]:
        pre = [
            s for s in self.slots
            if s and s.phase == _PREFILL and s.filled < self.T
        ]
        pre.sort(key=lambda s: (-self.sched.effective_priority(s.entry), s.admit_seq))
        grants = self.budget.plan_iteration(
            decode_tokens, [self._next_chunk(s.filled) for s in pre]
        )
        return [(s, self._next_chunk(s.filled))
                for s, take in zip(pre, grants) if take]

    def _fused_iteration(self) -> bool:
        pending = self._pending
        in_flight = set() if pending is None else {id(s) for s, _ in pending[1]}
        # a slot whose in-flight sample completes it is not dispatched again
        dispatchable = [
            s for s in self.slots
            if s and s.phase == _DECODE
            and len(s.entry.generated) + (id(s) in in_flight)
            < s.entry.effective_max_new
        ]
        # page growth, highest effective priority first: pages covering
        # [0, pos], preempting when the pool runs short
        for s in sorted(dispatchable, key=lambda s: -self.sched.effective_priority(s.entry)):
            if self.slots[s.index] is not s:
                continue  # preempted by an earlier slot's growth
            deficit = s.pos // self.page + 1 - self.pool.held(s.entry.request_id)
            if deficit > 0:
                self._alloc_or_preempt(s, deficit)
        dispatchable = [s for s in dispatchable if self.slots[s.index] is s]
        chunks = self._plan_fused_prefills(len(dispatchable))

        worked = False
        new_pending = None
        if dispatchable or chunks:
            worked = True
            new_pending = self._dispatch_fused(dispatchable, chunks, pending)
        if self.config.decode_lookahead:
            prev, self._pending = pending, new_pending
        else:
            prev, self._pending = new_pending, None
        if prev is not None:
            worked = True
            self._fused_readback(prev)
        return worked

    def _dispatch_fused(self, dispatchable: List[_Slot],
                        chunks: List[Tuple[_Slot, int]], pending):
        """Assemble descriptors on the host, copy them in one transfer, and
        run the iteration. Rows: 0 start, 1 length, 2 final, 3 seed,
        4 draw position, 5 host token, 6 host-token flag."""
        B = self.config.max_batch
        desc = np.zeros((7, B), np.int64)
        entries = []
        for s in dispatchable:
            desc[:5, s.index] = (s.pos, 1, 0, s.entry.request.seed, s.pos + 1)
            if pending is None or not s.tok_on_device:
                desc[5:, s.index] = (s.tok, 1)
            entries.append((s, _DECODE))
        for s, c in chunks:
            desc[:2, s.index] = (s.filled, c)
            if s.filled + c >= self.T:
                desc[2:5, s.index] = (1, s.entry.request.seed, self.T)
                entries.append((s, _PREFILL))
        d = self._to_device(desc)
        start, length = d[0].to(torch.int32), d[1].to(torch.int32)
        final = d[2].bool()
        prev_tok = pending[0] if pending is not None else self._zero_tok
        tok = torch.where(d[6].bool(), d[5].to(torch.int32), prev_tok)
        samples = self._iteration(tok, start, length, final, d[3], d[4],
                                  any_final=bool(desc[2].any()))
        self.dispatches += 1

        for s in self.slots:
            if s is not None and s.phase == _DECODE:
                s.tok_on_device = False
        for s in dispatchable:
            s.pos += 1
            s.tok_on_device = True
        for s, c in chunks:
            s.filled += c
            if s.filled >= self.T:
                # the row's cache is complete and its first image token is
                # in the in-flight samples: it decodes from next iteration
                s.phase, s.pos, s.tok_on_device = _DECODE, self.T, True
        return samples, entries

    def _iteration(self, tok, start, length, final, seeds, draw_pos,
                   any_final: bool) -> torch.Tensor:
        """One whole iteration on the device: per-row token blocks (decode
        rows take ``tok``, prefill rows gather their chunk from the prompts
        buffer), ``DALLE.fused_step``, image-only top-k, and the
        (seed, position) draw. Returns (B,) int32 samples."""
        T, W = self.T, self._W
        j = torch.arange(W, device=self.device)[None]
        chunk = self._prompts.gather(1, (start.long()[:, None] + j).clamp(max=T - 1))
        dec_tok = F.pad(tok[:, None], (0, W - 1))
        tokens = torch.where((start >= T)[:, None], dec_tok, chunk)
        logits = self.dalle.fused_step(tokens, start, length, final,
                                       self.cache, rowwise_head=any_final)
        filtered = top_k_filter(logits, k=self.k_img) / self.config.temperature
        return sample(filtered, seeds, draw_pos)

    def _fused_readback(self, prev) -> None:
        """Record one iteration's tokens (dropping rows terminated or
        preempted since dispatch) and complete slots that reached their
        budget. The first token's time is kept across preemption: the
        client saw the first production, the replay regenerates it."""
        samples, entries = prev
        samples = samples.cpu().numpy()
        for s, kind in entries:
            if self.slots[s.index] is not s:
                continue
            s.tok = int(samples[s.index])
            if kind == _DECODE:
                s.entry.generated.append(s.tok)
            else:
                s.entry.generated = [s.tok]
                if s.entry.ttft_s is None:
                    s.entry.ttft_s = self.clock.now() - s.entry.submit_time
            if len(s.entry.generated) >= s.entry.effective_max_new:
                self._complete(s)

    # -------------------------------------------------------- preemption

    def _alloc_or_preempt(self, slot: _Slot, n: int) -> None:
        """Allocate ``n`` pages for ``slot``, preempting victims until they
        fit or the slot itself was the victim."""
        while not self.pool.alloc(slot.entry.request_id, n):
            victim = self._pick_victim()
            self._preempt(victim)
            if victim is slot:
                return

    def _pick_victim(self) -> _Slot:
        """Lowest effective priority first; within one, the youngest
        admission (least work lost, shortest replay). Prefilling slots are
        victims like any other."""
        return min(
            (s for s in self.slots if s),
            key=lambda s: (self.sched.effective_priority(s.entry), -s.admit_seq),
        )

    def _preempt(self, slot: _Slot) -> None:
        """Release the slot (pages back, cache row zeroed, scale pools
        included) and requeue its request from scratch, or end it
        PREEMPT_CAP past ``max_preemptions``. A sample of it still in
        flight is dropped at readback."""
        self._release_slot(slot)
        entry = slot.entry
        entry.preempt_count += 1
        if entry.preempt_count > self.config.max_preemptions:
            self._finish(entry, Outcome.PREEMPT_CAP,
                         tokens=np.asarray(entry.generated, np.int32),
                         detail=f"evicted {entry.preempt_count} times "
                                f"(cap {self.config.max_preemptions})")
            return
        entry.generated = []
        entry.admit_time = None
        self.sched.requeue(entry)

    # ---------------------------------------------------------- plumbing

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without synchronising the host:
        through pinned memory with a non-blocking copy on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _release_slot(self, slot: _Slot) -> None:
        """Return the slot's pages and reset its cache row to pristine."""
        self.pool.free_all(slot.entry.request_id)
        self.cache.reset_row_(slot.index)
        self.slots[slot.index] = None

    def _complete(self, slot: _Slot) -> None:
        self._release_slot(slot)
        tokens = np.asarray(slot.entry.generated, np.int32)
        if self.postdecode is not None:
            self.postdecode.enqueue(slot.entry, tokens)
        else:
            self._finish(slot.entry, Outcome.COMPLETED, tokens=tokens)

    def _reject(self, entry: Entry, reason: RejectReason) -> RequestResult:
        result = RequestResult(
            request_id=entry.request_id, outcome=Outcome.REJECTED,
            reject_reason=reason, total_latency_s=0.0,
        )
        self.results[entry.request_id] = result
        return result

    def _finish(self, entry: Entry, outcome: Outcome,
                tokens: Optional[np.ndarray], image=None,
                rerank_score: Optional[float] = None, detail: str = "") -> None:
        now = self.clock.now()
        self._live.discard(entry.request_id)
        self.results[entry.request_id] = RequestResult(
            request_id=entry.request_id,
            outcome=outcome,
            tokens=tokens,
            preempt_count=entry.preempt_count,
            clamped_max_new_tokens=entry.effective_max_new if entry.clamped else None,
            queue_latency_s=(
                None if entry.admit_time is None
                else entry.admit_time - entry.submit_time
            ),
            ttft_s=entry.ttft_s,
            total_latency_s=now - entry.submit_time,
            image=image,
            rerank_score=rerank_score,
            detail=detail,
        )
