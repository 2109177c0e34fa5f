"""Continuous-batching serving engine (counterpart of
``dalle_pytorch_tpu/serving/engine.py``): the split path (the default,
as in the reference) and the fused ragged iteration
(``EngineConfig(fused_iteration=True, prefill_chunk=c)``).

Request lifecycle: submit -> [rejected] | queued -> admitted (slot and
prompt pages claimed) -> prefilling -> decoding (one token per
iteration) -> completed | deadline_exceeded | cancelled | preempt_cap |
prefill_failed, with preempted -> queued again on the way. With
``stages`` (``postdecode.StageSpec``) a request whose tokens complete
releases its slot and pages and moves through the post-decode stages
(VAE decode, then CLIP rerank) before it ends COMPLETED with an image and
a score, or typed-degraded (``Outcome.COMPLETED_TOKENS_ONLY`` /
``COMPLETED_UNRANKED``).

The engine owns ONE batched paged decode cache of ``max_batch`` slots.

Split path (``fused_iteration=False``). Each admitted request prefills
alone into a private batch-1 cache, which then lands in its slot's row
of the batched cache (``models.sampling.insert_decode_cache``); every
iteration steps all slots with one ``DALLE.decode_step`` at per-row
positions. Monolithic prefill (``prefill_chunk=None``, the default) runs
the whole prompt through ``DALLE.prefill_step`` at admission; chunked
prefill claims the slot and the prompt pages at admission and runs the
prompt in chunks (``DALLE.prefill_chunk``) between decode steps, under
the ``TokenBudget`` (decode tokens first, the rest to prefills
head-of-line), so deadlines, cancellation and preemption land between
chunks. A would-be 1-token tail chunk is merged into its predecessor (a
batch-1 width-1 chunk would run its projections as M=1 products). A
step's order: terminations -> admission -> the decode step (plus the
previous one's readback) -> the budgeted chunks -> stage work.

Fused path (``fused_iteration=True``). Each iteration is a single ragged
block through ``DALLE.fused_step``: every cache row gets a (start,
length, final) descriptor padded to the chunk width, prefilling rows
write their chunk directly into their row of the batched cache (chunks
are gathered on the device from a prompts buffer), decoding rows ride
the same block, and every layer's attention runs the ragged kernel over
all rows at once.

Either way every "full" layer's attention runs the ragged paged-attention
kernel: a chunk of c columns in one row, the monolithic prompt block, the
vector decode step of ``max_batch`` rows of one column, or the fused
block.

One-step lookahead (``decode_lookahead``): step N+1 is dispatched before
step N's samples are read back; a decode row's input token is the
previous step's still-on-device sample. Completion is count-based, so
the host needs no token values to schedule; cancellation and deadlines
take effect at readback (a sample in flight for a terminated request is
dropped).

Sampling contract: the token at internal position p of a request is a
pure function of (seed, p) and the logits (``models.sampling.sample``):
a prefill's first token is drawn at position T, a decode token at
pos + 1, on both paths. So a request's tokens do not depend on the batch
around it, and split and fused runs of it can agree.

Page pressure (``page_budget`` below every slot's full sequence).
Admission is optimistic: a request is admitted when the worst-case pages
of the budget it would receive fit the free pages at that moment, and
pages are claimed lazily, so decode growth can still find the pool
empty. Growth then preempts (``_alloc_or_preempt``): the running slot of
lowest effective priority, youngest admission first, releases its pages
and its cache row; its request is requeued with its tokens discarded and
aged by ``preempt_priority_boost``, and its replay reproduces them
bit-identically by the sampling contract. Past ``max_preemptions``
evictions it ends ``Outcome.PREEMPT_CAP``. Watermark degradation: a
request admitted while the pool's occupancy is above ``high_watermark``
has its budget clamped to ``degraded_max_new_tokens`` (reported as
``RequestResult.clamped_max_new_tokens``).

Prefill retries and faults. A failed prefill attempt (the
``prefill_fail`` fault: per monolithic pass, per granted chunk; a chunked
retry resumes from the last completed chunk) is retried until the
request has failed ``prefill_attempts`` times; then it ends
``Outcome.PREFILL_FAILED`` with its slot and pages freed. The fault
sites of ``utils.faults`` (``prefill_fail``, ``page_exhaust``,
``decode_stall``, ``request_cancel``) are armed on a ``FaultRegistry``
passed as ``faults``.

KV storage (``kv_quant``): "none" keeps K/V pages in the model's dtype,
"int8" stores int8 pages with per-(token, head) float32 scale pages,
about half the bytes per slot (``kv_bytes_per_slot``); every layer's
"full" attention then runs the ragged kernel's int8 instance.

The model may have any of the ported attention types; non-"full" layers
decode through the gathered cache view (``ops/attention.py``).

Not ported yet: speculative decoding, the prefix cache, the journal,
vitals and the controller, and telemetry (``EngineConfig`` has no field
for them, so asking for one is a ``TypeError``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dalle import DALLE, top_k_filter
from ..models.sampling import init_decode_cache, insert_decode_cache, sample
from ..ops import kv_policy
from ..utils.faults import FaultRegistry
from .postdecode import PostDecodePipeline, StageSpec
from .scheduler import Entry, PagePool, Scheduler, TokenBudget, pages_for
from .types import Clock, Outcome, RejectReason, Request, RequestResult


@dataclass(frozen=True)
class EngineConfig:
    """Operator knobs. The defaults are the reference's: the split path
    with monolithic prefill, the whole physical pool."""

    max_batch: int = 4
    # logical page budget; None = full physical capacity (B * pages/slot)
    page_budget: Optional[int] = None
    queue_limit: int = 64
    filter_thres: float = 0.9
    temperature: float = 1.0
    # pool occupancy above which newly admitted requests are clamped to
    # degraded_max_new_tokens (None: no clamp)
    high_watermark: float = 0.85
    degraded_max_new_tokens: Optional[int] = None
    # evictions a request survives; one more ends it PREEMPT_CAP
    max_preemptions: int = 3
    # effective-priority gain per eviction (preemption aging)
    preempt_priority_boost: int = 1
    # failed prefill attempts that end a request PREFILL_FAILED
    prefill_attempts: int = 2
    # seconds the clock advances at a decode_stall fault
    stall_penalty_s: float = 1.0
    # prompt tokens per chunk (>= 2; the fused block width); None =
    # monolithic prefill (split path only)
    prefill_chunk: Optional[int] = None
    # tokens per iteration shared by decode and prefill chunks (chunked
    # prefill only); None = max_batch + prefill_chunk
    token_budget: Optional[int] = None
    decode_lookahead: bool = True
    # one fused ragged dispatch per iteration (needs prefill_chunk)
    # instead of batch-1 prefills and the vector decode step
    fused_iteration: bool = False
    # KV page rows; None = kv_policy.DEFAULT_PAGE_SIZE
    page_size: Optional[int] = None
    # KV page storage (kv_policy.QUANTS); None = "none"
    kv_quant: Optional[str] = None


_PREFILL = "prefill"
_DECODE = "decode"


class _Slot:
    """A running request bound to one cache row. Phase ``prefill``:
    ``filled`` prompt positions written so far (split path: into the
    private batch-1 ``cache1``, from ``internal``, the (1, T) remapped
    prompt on the device; fused path: into the slot's row). Phase
    ``decode``: ``tok`` is the last sampled token (not yet cached) at
    position ``pos``; ``tok_on_device`` means it is still only in the
    in-flight samples."""

    def __init__(self, entry: Entry, index: int, admit_seq: int):
        self.entry = entry
        self.index = index
        self.admit_seq = admit_seq
        self.phase = _PREFILL
        self.filled = 0
        self.cache1 = None
        self.internal = None
        self.pos = 0
        self.tok = -1
        self.tok_on_device = False


class Engine:
    """See the module docstring. Host-side state machine + one device
    cache. ``faults``: the fault registry whose armed sites the engine
    fires (None: no faults)."""

    def __init__(self, dalle: DALLE, config: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None, device="cuda",
                 stages: Optional[StageSpec] = None,
                 faults: Optional[FaultRegistry] = None):
        if config.prefill_chunk is not None and config.prefill_chunk < 2:
            raise ValueError(
                f"prefill_chunk must be >= 2 (a batch-1 width-1 chunk runs its "
                f"projections as M=1 products; the fused block is that wide), "
                f"got {config.prefill_chunk}"
            )
        self.fused = config.fused_iteration
        if self.fused and config.prefill_chunk is None:
            raise ValueError("fused_iteration requires chunked prefill (prefill_chunk): "
                             "the fused block width is the chunk width")
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
        self.faults = faults if faults is not None else FaultRegistry()

        B = config.max_batch
        self.page = kv_policy.page_size(config.page_size)
        self.T = dalle.text_len_internal
        self.n_pages_slot = pages_for(self.T + dalle.image_seq_len, self.page)
        full = B * self.n_pages_slot
        self.pool = PagePool(full if config.page_budget is None else config.page_budget)
        self.sched = Scheduler(config.queue_limit, config.preempt_priority_boost)
        self.budget: Optional[TokenBudget] = None
        if config.prefill_chunk is not None:
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
        if self.fused:
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
        # in-flight step awaiting readback: (device samples,
        # [(slot, kind)]); read back one step late with lookahead
        self._pending: Optional[Tuple[torch.Tensor, list]] = None
        # model calls (fused iterations; split: prefills, chunks and
        # decode steps), the split path's prefills and chunks among them,
        # and iterations that did work
        self.dispatches = 0
        self.prefill_dispatches = 0
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
        """One iteration: terminations -> admission -> device work (fused:
        one dispatch; split: the decode step, then the budgeted prefill
        chunks), each with the previous step's readback -> budgeted stage
        work. False when fully idle."""
        self._sweep_terminations()
        self._admit()
        if self.fused:
            worked = self._fused_iteration()
        else:
            worked = self._decode_once()
            worked = self._advance_prefills() or worked
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
        running = [s for s in self.slots if s]
        if running and self.faults.take("request_cancel"):
            victim = max(running, key=lambda s: s.admit_seq)
            self._cancel_requested.add(victim.entry.request_id)
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
            if self.config.prefill_chunk is not None:
                self._claim_prefill_slot(entry, free[0])
            else:
                self._prefill_monolithic(entry, free[0])

    def _claim_prefill_slot(self, entry: Entry, idx: int) -> None:
        """Chunked admission: the request claims its slot and prompt pages
        now; its chunks run over the following iterations (fused: into
        its row of the batched cache, from the prompts buffer; split: into
        a private batch-1 cache)."""
        entry.admit_time = self.clock.now()
        slot = _Slot(entry, idx, self._admit_seq)
        self._admit_seq += 1
        internal = self._to_device(self._internal_tokens(entry))
        if self.fused:
            self._prompts[idx] = internal
        else:
            slot.cache1 = self._fresh_prefill_cache()
            slot.internal = internal[None]
        self.slots[idx] = slot

    def _prefill_monolithic(self, entry: Entry, idx: int) -> None:
        """Split admission without chunks: the whole prompt in one batch-1
        ``prefill_step``, the first image token drawn from its logits, the
        cache landed in the slot's row. A failed attempt gives the prompt
        pages back and requeues the request (at the head of the queue, so
        the admission loop retries it at once) until its attempts run
        out."""
        if self.faults.take("prefill_fail"):
            self.pool.free_all(entry.request_id)
            if not self._prefill_failed(entry):
                self.sched.requeue(entry)
            return
        cache1 = self._fresh_prefill_cache()
        internal = self._to_device(self._internal_tokens(entry))[None]
        img = self.dalle.prefill_step(internal, cache1, image_only=True)
        self.dispatches += 1
        self.prefill_dispatches += 1
        tok0 = self._first_token(img, entry)
        insert_decode_cache(self.cache, cache1, idx)
        entry.admit_time = self.clock.now()
        slot = _Slot(entry, idx, self._admit_seq)
        self._admit_seq += 1
        self.slots[idx] = slot
        self._start_decode(slot, tok0)

    def _internal_tokens(self, entry: Entry) -> np.ndarray:
        """The request's (T,) remapped prompt, <bos> first."""
        prompt = torch.as_tensor(np.asarray(entry.request.prompt), dtype=torch.int32)[None]
        return self.dalle.remap_text(prompt)[0].numpy()

    def _fresh_prefill_cache(self):
        """A pristine batch-1 paged cache for one split prefill."""
        return init_decode_cache(self.dalle, 1, "paged", kv_quant=self.kv_quant,
                                 page_size=self.page)

    def _first_token(self, img: torch.Tensor, entry: Entry) -> int:
        """A split prefill's first image token, drawn from its (1, V_img)
        logits at position T with the request's seed (read back: the
        host decides the slot's first decode input)."""
        d = self._to_device(np.array([[entry.request.seed], [self.T]], np.int64))
        return int(self._draw(img, d[0], d[1])[0])

    def _prefill_failed(self, entry: Entry, filled: Optional[int] = None) -> bool:
        """Count a failed prefill attempt; once the request has failed
        ``prefill_attempts`` times it ends PREFILL_FAILED (the caller
        frees its pages and slot). True when it ended."""
        entry.prefill_attempts += 1
        if entry.prefill_attempts < self.config.prefill_attempts:
            return False
        where = "" if filled is None else f" ({filled}/{self.T} tokens prefilled)"
        self._finish(entry, Outcome.PREFILL_FAILED, tokens=None,
                     detail=f"prefill failed after {entry.prefill_attempts} attempts{where}")
        return True

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

    # ------------------------------------------------------- split path

    def _next_chunk(self, filled: int) -> int:
        """The split path's next chunk width: the configured size, with a
        would-be 1-token tail merged into this chunk."""
        c = min(self.config.prefill_chunk, self.T - filled)
        if self.T - filled - c == 1:
            c += 1
        return c

    def _advance_prefills(self) -> bool:
        """This iteration's budgeted prefill chunks of the split path:
        in-progress prefills head-of-line by effective priority, each
        granted tokens by ``TokenBudget.plan`` after decode's share, its
        chunks run one after another into its batch-1 cache. A failed
        chunk ends the slot's turn; its retry resumes from that chunk."""
        pre = [s for s in self.slots if s and s.phase == _PREFILL]
        if not pre:
            return False
        pre.sort(key=lambda s: (-self.sched.effective_priority(s.entry), s.admit_seq))
        n_decode = sum(1 for s in self.slots if s and s.phase == _DECODE)
        grants = self.budget.plan(n_decode, [self.T - s.filled for s in pre])
        worked = False
        for slot, grant in zip(pre, grants):
            while grant > 0 and self.slots[slot.index] is slot:
                c = self._next_chunk(slot.filled)
                if self.faults.take("prefill_fail"):
                    if self._prefill_failed(slot.entry, slot.filled):
                        self._release_slot(slot)
                    break
                worked = True
                start = slot.filled
                chunk = slot.internal[:, start:start + c]
                self.dispatches += 1
                self.prefill_dispatches += 1
                slot.filled += c
                grant -= c
                if slot.filled < self.T:
                    self.dalle.prefill_chunk(chunk, start, slot.cache1, return_logits=False)
                    continue
                img = self.dalle.prefill_chunk(chunk, start, slot.cache1, image_only=True)
                self._finish_prefill(slot, self._first_token(img, slot.entry))
                break
        return worked

    def _finish_prefill(self, slot: _Slot, tok0: int) -> None:
        """The final chunk drew the first image token: land the batch-1
        cache in the slot's row and start decoding."""
        insert_decode_cache(self.cache, slot.cache1, slot.index)
        slot.cache1 = slot.internal = None
        self._start_decode(slot, tok0)

    def _start_decode(self, slot: _Slot, tok0: int) -> None:
        """A split prefill is complete: its first token, read back, is the
        slot's first decode input."""
        slot.phase, slot.pos, slot.tok, slot.tok_on_device = _DECODE, self.T, tok0, False
        slot.entry.generated = [tok0]
        self._record_first_token(slot.entry)
        if len(slot.entry.generated) >= slot.entry.effective_max_new:
            self._complete(slot)

    def _decode_once(self) -> bool:
        """The split path's decode step over every dispatchable slot, plus
        the previous step's readback."""
        self._maybe_stall()
        dispatchable = self._grow_pages()
        new_pending = None
        if dispatchable:
            new_pending = self._dispatch_decode(dispatchable, self._pending)
        return self._swap_pending(new_pending) or new_pending is not None

    def _dispatch_decode(self, dispatchable: List[_Slot], pending):
        """One ``DALLE.decode_step`` at per-row positions over every row,
        descriptors assembled on the host and copied in one transfer.
        Rows: 0 position, 1 seed, 2 host token, 3 host-token flag. Input
        tokens come from the in-flight samples where the slot's token is
        still there; host-decided tokens (a fresh prefill's first token,
        a synchronous readback) are scattered over them. A row without a
        dispatched slot (free, prefilling, or its last token in flight)
        writes garbage at position 0 of its own row, which its next
        insert overwrites or its release resets."""
        desc = np.zeros((4, self.config.max_batch), np.int64)
        for s in dispatchable:
            desc[:2, s.index] = (s.pos, s.entry.request.seed)
            if pending is None or not s.tok_on_device:
                desc[2:, s.index] = (s.tok, 1)
        d = self._to_device(desc)
        prev_tok = pending[0] if pending is not None else self._zero_tok
        tok = torch.where(d[3].bool(), d[2].to(torch.int32), prev_tok)
        logits = self.dalle.decode_step(tok, d[0].to(torch.int32), self.cache,
                                        image_only=True)
        samples = self._draw(logits, d[1], d[0] + 1)
        self.dispatches += 1
        self._advance_decoded(dispatchable)
        return samples, [(s, _DECODE) for s in dispatchable]

    # --------------------------------------------------- fused iteration

    def _next_chunk_fused(self, filled: int) -> int:
        """The fused path's next chunk: no tail merge (every row of the
        block is computed at the block's width)."""
        return min(self.config.prefill_chunk, self.T - filled)

    def _plan_fused_prefills(self, decode_tokens: int) -> List[Tuple[_Slot, int]]:
        """One fused iteration's chunk grants (``plan_iteration``). A failed
        chunk is not dispatched; its retry resumes from it next
        iteration."""
        pre = [
            s for s in self.slots
            if s and s.phase == _PREFILL and s.filled < self.T
        ]
        pre.sort(key=lambda s: (-self.sched.effective_priority(s.entry), s.admit_seq))
        grants = self.budget.plan_iteration(
            decode_tokens, [self._next_chunk_fused(s.filled) for s in pre]
        )
        chunks = []
        for s, take in zip(pre, grants):
            if not take:
                continue
            if self.faults.take("prefill_fail"):
                if self._prefill_failed(s.entry, s.filled):
                    self._release_slot(s)
                continue
            chunks.append((s, self._next_chunk_fused(s.filled)))
        return chunks

    def _fused_iteration(self) -> bool:
        self._maybe_stall()
        dispatchable = self._grow_pages()
        chunks = self._plan_fused_prefills(len(dispatchable))
        new_pending = None
        if dispatchable or chunks:
            new_pending = self._dispatch_fused(dispatchable, chunks, self._pending)
        return self._swap_pending(new_pending) or new_pending is not None

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
        self._advance_decoded(dispatchable)
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
        T, W = self.T, self.config.prefill_chunk
        j = torch.arange(W, device=self.device)[None]
        chunk = self._prompts.gather(1, (start.long()[:, None] + j).clamp(max=T - 1))
        dec_tok = F.pad(tok[:, None], (0, W - 1))
        tokens = torch.where((start >= T)[:, None], dec_tok, chunk)
        logits = self.dalle.fused_step(tokens, start, length, final,
                                       self.cache, rowwise_head=any_final)
        return self._draw(logits, seeds, draw_pos)

    # ---------------------------------------------- shared decode plumbing

    def _draw(self, logits, seeds, positions) -> torch.Tensor:
        """Image-only top-k (the full vocab's k), temperature, and the
        (seed, position) draw: (b,) int32."""
        filtered = top_k_filter(logits, k=self.k_img) / self.config.temperature
        return sample(filtered, seeds, positions)

    def _maybe_stall(self) -> None:
        """The ``decode_stall`` fault: the clock jumps by the penalty."""
        if self.faults.take("decode_stall"):
            self.clock.advance(self.config.stall_penalty_s)

    def _grow_pages(self) -> List[_Slot]:
        """The decoding slots to dispatch this step, with their pages
        grown. A slot whose in-flight sample completes its budget is not
        dispatched again. Growth goes highest effective priority first:
        pages covering [0, pos], preempting when the pool runs short."""
        in_flight = set() if self._pending is None else {id(s) for s, _ in self._pending[1]}
        dispatchable = [
            s for s in self.slots
            if s and s.phase == _DECODE
            and len(s.entry.generated) + (id(s) in in_flight)
            < s.entry.effective_max_new
        ]
        for s in sorted(dispatchable, key=lambda s: -self.sched.effective_priority(s.entry)):
            if self.slots[s.index] is not s:
                continue  # preempted by an earlier slot's growth
            deficit = s.pos // self.page + 1 - self.pool.held(s.entry.request_id)
            if deficit > 0:
                self._alloc_or_preempt(s, deficit)
        return [s for s in dispatchable if self.slots[s.index] is s]

    def _advance_decoded(self, dispatchable: List[_Slot]) -> None:
        """After a dispatch: only the dispatched slots' tokens are in the
        newest in-flight samples."""
        for s in self.slots:
            if s is not None and s.phase == _DECODE:
                s.tok_on_device = False
        for s in dispatchable:
            s.pos += 1
            s.tok_on_device = True

    def _swap_pending(self, new_pending) -> bool:
        """The lookahead seam: with lookahead the previous step is read
        back after this one was dispatched, without it this one at once.
        True when a step was read back."""
        if self.config.decode_lookahead:
            prev, self._pending = self._pending, new_pending
        else:
            prev, self._pending = new_pending, None
        if prev is None:
            return False
        self._readback(prev)
        return True

    def _readback(self, prev) -> None:
        """Record one step's tokens (dropping rows terminated or preempted
        since dispatch) and complete slots that reached their budget. A
        fused final chunk's sample is its request's first token."""
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
                self._record_first_token(s.entry)
            if len(s.entry.generated) >= s.entry.effective_max_new:
                self._complete(s)

    def _record_first_token(self, entry: Entry) -> None:
        """The first token's time is kept across preemption: the client saw
        the first production, the replay regenerates it."""
        if entry.ttft_s is None:
            entry.ttft_s = self.clock.now() - entry.submit_time

    # -------------------------------------------------------- preemption

    def _alloc_or_preempt(self, slot: _Slot, n: int) -> bool:
        """Allocate ``n`` pages for ``slot``, preempting victims until they
        fit (or, under the ``page_exhaust`` fault, once regardless).
        False when the slot itself was the victim."""
        while True:
            blocked = self.faults.take("page_exhaust")
            if not blocked and self.pool.alloc(slot.entry.request_id, n):
                return True
            victim = self._pick_victim()
            self._preempt(victim)
            if victim is slot:
                return False

    def _pick_victim(self) -> _Slot:
        """Lowest effective priority first; within one, the youngest
        admission (least work lost, shortest replay). Prefilling slots are
        victims like any other."""
        return min(
            (s for s in self.slots if s),
            key=lambda s: (self.sched.effective_priority(s.entry), -s.admit_seq),
        )

    def _preempt(self, slot: _Slot) -> None:
        """Release the slot and requeue its request from scratch, or end it
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
        """Return the slot's pages and reset its cache row to pristine
        (scale pools included). A split-path prefilling slot never wrote
        its row (its chunks live in the batch-1 cache, dropped here)."""
        self.pool.free_all(slot.entry.request_id)
        self.slots[slot.index] = None
        if slot.phase == _PREFILL and not self.fused:
            slot.cache1 = slot.internal = None
            return
        self.cache.reset_row_(slot.index)

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
            prefill_attempts=entry.prefill_attempts,
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
