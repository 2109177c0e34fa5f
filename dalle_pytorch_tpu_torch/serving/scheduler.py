"""Admission, page accounting and the priority queue (counterpart of
``dalle_pytorch_tpu/serving/scheduler.py``). Host-only bookkeeping.

``PagePool`` is the logical page budget over the per-slot physical pools
(and the prefix cache's arena, whose pages the index holds).
Admission charges a request's WORST-CASE demand against free pages; pages
are allocated lazily (prompt pages at admission, one more when decode
crosses a page boundary), so admitted requests can still exhaust a budget
below full capacity as they grow: the engine then preempts one and
requeues it here. Admission is strict head-of-line.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .types import Request


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages covering ``n_positions`` written cache rows (ceil; 0 -> 0)."""
    assert page_size > 0, page_size
    return -(-max(0, n_positions) // page_size)


@dataclass(frozen=True)
class TokenBudget:
    """Per-iteration token budget shared between decode tokens and prefill
    chunks. Decode is charged first (one token per active slot); the rest
    goes to in-progress prefills head-of-line in scheduling order: on the
    fused path one chunk per prefilling row per iteration
    (``plan_iteration``), on the split path as many chunks as fit
    (``plan``). The head prefill is always granted (forward progress);
    granting stops at the first chunk that does not fit. ``budget=None``
    grants every prefill."""

    budget: Optional[int]
    chunk: int

    def __post_init__(self):
        assert self.chunk >= 1, self.chunk
        assert self.budget is None or self.budget >= 1, self.budget

    def plan(self, n_decode: int, prefill_remaining: Sequence[int]) -> List[int]:
        """Token grants of the split path, one per in-progress prefill
        (``prefill_remaining``: its unprocessed prompt tokens, in
        scheduling order). Grants are whole chunks but for a smaller
        final tail; the head prefill always gets at least one chunk, and
        granting stops at the first chunk that does not fit. The engine
        may widen a granted last chunk by one token (its 1-token-tail
        merge): the budget bounds the scheduling, it is not a meter."""
        grants = [0] * len(prefill_remaining)
        if not prefill_remaining:
            return grants
        if self.budget is None:
            return list(prefill_remaining)
        left = self.budget - n_decode
        granted_any = False
        for i, rem in enumerate(prefill_remaining):
            while rem > 0:
                c = min(self.chunk, rem)
                if left < c and granted_any:
                    return grants
                grants[i] += c
                rem -= c
                left -= c
                granted_any = True
        return grants

    def plan_iteration(self, decode_tokens: int,
                       next_chunks: Sequence[int]) -> List[bool]:
        """Which in-progress prefills run their next chunk this iteration.
        ``next_chunks``: width of each prefill's next chunk, in
        scheduling order. ``decode_tokens`` is decode's charge: one token
        per decoding row, or in a speculative iteration each row's whole
        verify width (the tokens the dispatch computes; progress is
        counted in accepted tokens). The post-decode pipeline meters its
        stages with it too, over width-1 items (one per staged image)."""
        take = [False] * len(next_chunks)
        if not next_chunks:
            return take
        if self.budget is None:
            return [True] * len(next_chunks)
        left = self.budget - decode_tokens
        for i, c in enumerate(next_chunks):
            if i > 0 and left < c:
                break
            take[i] = True
            left -= c
        return take


class PagePool:
    """Logical page budget with per-request ownership; ``alloc`` is
    all-or-nothing, ``free_all`` returns everything a request holds."""

    def __init__(self, total_pages: int):
        assert total_pages > 0, total_pages
        self.total = int(total_pages)
        self._held: Dict[str, int] = {}

    @property
    def used(self) -> int:
        return sum(self._held.values())

    @property
    def free(self) -> int:
        return self.total - self.used

    @property
    def occupancy(self) -> float:
        return self.used / self.total

    def held(self, request_id: str) -> int:
        return self._held.get(request_id, 0)

    def holders(self) -> set:
        """The ids holding pages (the engine's invariant check)."""
        return set(self._held)

    def alloc(self, request_id: str, n: int) -> bool:
        assert n >= 0, n
        if n > self.free:
            return False
        self._held[request_id] = self._held.get(request_id, 0) + n
        return True

    def release(self, holder: str, n: int) -> None:
        """Return ``n`` of a holder's pages (the prefix index gives its
        pages back one eviction at a time)."""
        held = self._held.get(holder, 0)
        assert 0 <= n <= held, (holder, n, held)
        if held == n:
            self._held.pop(holder, None)
        else:
            self._held[holder] = held - n

    def free_all(self, request_id: str) -> int:
        return self._held.pop(request_id, 0)


@dataclass
class Entry:
    """A request plus its scheduling state, from submit to terminal outcome."""

    request: Request
    submit_time: float
    seq: int                      # submission order; FIFO tiebreak
    preempt_count: int = 0
    prefill_attempts: int = 0     # failed prefill attempts
    # set at admission: the budget this residency generates, clamped by
    # watermark degradation
    effective_max_new: int = 0
    clamped: bool = False
    admit_time: Optional[float] = None
    ttft_s: Optional[float] = None
    generated: List[int] = field(default_factory=list)
    # whether this queue residency counts against the queue bound (True
    # for fresh submissions, False for preemption requeues)
    counted: bool = True
    # the (T,) internal prompt row (host ints), computed at the first
    # admission: the prefix chain's key and the publish source
    internal_tokens: Optional[object] = None
    # prefix-cache hit class of the admission that produced the first
    # token ("full" | "partial"; None: cold)
    hit_class: Optional[str] = None

    @property
    def request_id(self) -> str:
        return self.request.request_id


class Scheduler:
    """Bounded priority queue with preemption aging: highest effective
    priority first, FIFO within one. The effective priority is the
    request's own plus ``preempt_count * preempt_priority_boost``, so every
    eviction ages a request upward and a stream of higher-priority
    arrivals cannot evict it forever (``EngineConfig.max_preemptions`` is
    the backstop)."""

    def __init__(self, queue_limit: int, preempt_priority_boost: int = 1):
        assert queue_limit >= 0
        self.queue_limit = queue_limit
        self.preempt_priority_boost = preempt_priority_boost
        self._heap: List[tuple] = []
        self._size = 0  # entries counted against queue_limit

    def __len__(self) -> int:
        return len(self._heap)

    def effective_priority(self, entry: Entry) -> int:
        return entry.request.priority + entry.preempt_count * self.preempt_priority_boost

    def _push(self, entry: Entry) -> None:
        heapq.heappush(self._heap, (-self.effective_priority(entry), entry.seq, entry))

    def submit(self, entry: Entry) -> bool:
        """Queue a new submission; False when the queue is full."""
        if self._size >= self.queue_limit:
            return False
        entry.counted = True
        self._size += 1
        self._push(entry)
        return True

    def requeue(self, entry: Entry) -> None:
        """Re-queue a preempted request, outside the queue bound: it won
        admission once, and an internal eviction must not turn into a
        client-visible reject."""
        entry.counted = False
        self._push(entry)

    def ids(self) -> set:
        """The queued request ids."""
        return {e.request_id for (_, _, e) in self._heap}

    def entries(self) -> List[Entry]:
        """The queued entries in submission order (the engine's
        ``live_requests`` export)."""
        return sorted((e for (_, _, e) in self._heap), key=lambda e: e.seq)

    def peek(self) -> Optional[Entry]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Entry:
        entry = heapq.heappop(self._heap)[2]
        self._size -= entry.counted
        return entry

    def remove(self, request_id: str) -> Optional[Entry]:
        """Pull a queued entry out by id (cancellation / deadline sweep)."""
        for i, (_, _, entry) in enumerate(self._heap):
            if entry.request_id == request_id:
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                self._size -= entry.counted
                return entry
        return None

    def expired(self, now: float) -> List[Entry]:
        """Remove and return every queued entry whose deadline has passed."""
        out = [
            e for (_, _, e) in self._heap
            if e.request.deadline is not None and now > e.request.deadline
        ]
        for e in out:
            self.remove(e.request_id)
        return out
