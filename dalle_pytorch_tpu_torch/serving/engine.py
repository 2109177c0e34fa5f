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
``decode_stall``, ``request_cancel``, ``prefix_hash_collide``,
``prefix_publish_fail``, ``spec_verify_abort``) are armed on a
``FaultRegistry`` passed as ``faults``.

KV storage (``kv_quant``): "none" keeps K/V pages in the model's dtype,
"int8" stores int8 pages with per-(token, head) float32 scale pages,
about half the bytes per slot (``kv_bytes_per_slot``); every layer's
"full" attention then runs the ragged kernel's int8 instance.

Prefix cache (``prefix_cache``, ``serving/prefix_cache.py``): completed
requests publish their prompt pages into ARENA rows appended to the
batched pools, indexed by the hash chain of the tokens they cover. A
probe at admission maps verified hit pages into the slot's page table
read-only (refcounted) and restores the shift-ring seam. A FULL hit runs
no prefill: its first token is drawn from the cached terminal logits
with the request's own (seed, T) draw, and a partial terminal page is
copied into the slot's own page before its first decode write lands in
it (copy-on-write). A PARTIAL hit resumes chunked prefill at the miss
boundary (fused: the shared pages mapped; split: copied into the private
batch-1 cache); monolithic prefill falls back to cold. Unreferenced index
pages are reclaimed (leaf-first LRU) before any request is preempted,
and a publish that finds no room fails open. The index's pages are
charged to the budget under ``PREFIX_HOLDER``.

Speculative decode (``spec_decode``, fused path only): each decoding
slot drafts up to ``spec_k`` tokens with width-1 steps through the first
``spec_draft_depth`` layers (None: every layer, the exact drafter), and
the iteration's fused block verifies them as one row of width
1 + drafts. A draft is accepted while it equals the token the target
draws at its position with the same (seed, position) draw, so the tokens
are plain decode's. Rejected positions are rewound by descriptors: the
next block is anchored at the accepted frontier and overwrites them, and
the shift rings are ``spec_k`` rows wider (``spec_model``) so the reads
below a lagging anchor stay held. The drafts write the cache in place
(JAX drafts on a functional copy): their K/V writes land only at
positions the verify block rewrites before it reads them, or past the
frontier, and their ring pushes keep every older row, so the verify
block sees the cache the previous iteration committed. The iteration is
synchronous: the accepted counts are read back before the next
descriptors are built. The ``spec_verify_abort`` fault degrades one
iteration to verify width 1.

The model may have any of the ported attention types; non-"full" layers
decode through the gathered cache view (``ops/attention.py``).

Metrics and telemetry (``utils/metrics.py``, ``utils/telemetry.py``):
``counters``, ``gauges`` and ``histograms`` are views of the process-wide
registries with ``metric_labels`` bound (engines without labels add into
one series): the lifecycle tallies (``serve.submitted``, ``admitted``,
``completed``, one a typed outcome, ``dispatches``, ``decode_steps``,
``prefill_chunks``, the fault sites'), the histograms
``serve.queue_wait_s``, ``serve.ttft_s`` (with ``_cold_s``,
``_partial_hit_s`` and ``_full_hit_s`` under the prefix cache),
``serve.request_latency_s`` and ``serve.spec_accepted_per_step``, and the
gauges every iteration publishes (occupancy, running, prefilling, queued,
staged, the KV footprint, prefix and speculation rates). With telemetry
on, each request is a ``serve.request`` span from submit to its typed
outcome, with ``serve.prefill``, ``serve.prefill_chunk`` and
``serve.slot_insert`` spans under it, one ``serve.decode_step`` (split)
or ``serve.iteration`` (fused; ``serve.spec_verify`` inside it when
speculative) a dispatch, and the events ``serve.admit``,
``serve.first_token``, ``serve.evict``, ``serve.prefill_retry``,
``serve.prefix_hit`` and ``serve.decode_stall``. Spans open and close on
the host and add no device sync. One sync is the engine's own, as in
JAX: the split path waits for each non-final prefill chunk before its
span closes, which bounds the work queued behind the next decode
readback and makes ``serve.prefill_chunk_s`` a chunk's latency.

Request export and resume (the router's surface): ``stats()``;
``live_requests()``, every request still owed an outcome (queued, then
running, then staged); ``submit_staged(request, tokens, image=None)``, a
request whose token work is done entering the post-decode pipeline (at
VAE decode, or with its image at the rerank), as a journal replay or a
failover resumes it; ``fleet_occupancy``, a router's aggregate occupancy,
which then drives the watermark clamp, the stages' watermark and the
backoff hint of a ``queue_full`` reject.

Prefix snapshots: ``save_prefix_snapshot(dir)`` writes the index and its
arena pages (``index.json``, ``arrays.npz``, the committed manifest last,
built aside and swapped in), ``load_prefix_snapshot(dir)`` restores them
into an empty index after a layered verification; any failure rejects
the whole snapshot, counted (``serve.snapshot.rejected``), and the
engine stays cold.

Vitals and control (``vitals``, ``controller``; ``utils/vitals.py``,
``serving/control.py``): after each worked iteration the engine pushes
its numbers into the vitals windows (``serve.vitals.*``) and every
``control.interval`` iterations the controller moves the effective
knobs: the speculative verify width (at most ``spec_k``), the token
budget, the clamp watermark and the prefix arena's share, each logged as
a ``serve.control.decision`` event. The ``control_stall`` fault resets
the knobs to the configuration's.

Refused: ``cost_ledger=True`` (``NotImplementedError``). The JAX engine
charges each dispatch with XLA's ``cost_analysis()``; torch has no such
report, so the vitals' roofline gauge reads 0.
"""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dalle import DALLE, top_k_filter
from ..models.sampling import DecodeCache, init_decode_cache, insert_decode_cache, sample
from ..ops import kv_policy, paged_kv
from ..utils import vitals as vitals_mod
from ..utils.faults import FaultRegistry
from ..utils.metrics import counters, gauges, histograms
from ..utils.resilience import retry_after_hint, verify_dir_manifest, write_dir_manifest
from ..utils.telemetry import TELEMETRY
from .control import ControlConfig, Controller
from .postdecode import PostDecodePipeline, StageSpec
from .prefix_cache import PrefixCache, chain_blocks, snapshot_records, verify_snapshot_records
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
    # speculative decode through the fused iteration (needs
    # fused_iteration): spec_k drafted tokens a slot and iteration,
    # verified as one row of width spec_k + 1
    spec_decode: bool = False
    spec_k: int = 3
    # layers the drafter runs (None: all, the exact drafter)
    spec_draft_depth: Optional[int] = None
    # the cross-request prefix cache and its arena capacity in pages,
    # rounded up to whole storage rows (None: four prompts' worth)
    prefix_cache: bool = False
    prefix_cache_pages: Optional[int] = None
    # sliding-window vitals published as serve.vitals.* (utils/vitals.py),
    # over vitals_window worked iterations
    vitals: bool = False
    vitals_window: int = 32
    # refused: the JAX engine's per-dispatch XLA cost charge
    cost_ledger: bool = False
    # the adaptive controller (serving/control.py; implies vitals) and its
    # thresholds (None: ControlConfig())
    controller: bool = False
    control: Optional[ControlConfig] = None


_PREFILL = "prefill"
_DECODE = "decode"

# PagePool holder of the prefix index's pages (charged like any resident
# page; the index is its own eviction tier)
PREFIX_HOLDER = "__prefix__"


class _AdmitHit:
    """One admission's usable probe result: the verified chain nodes the
    slot consumes (references ACQUIRED: every path that does not admit
    must release them), whether they cover the whole prompt, and how
    many pages the slot maps shared (its demand shrinks by exactly
    these; a split partial hit copies, so it shares none)."""

    def __init__(self, nodes, full: bool = False, shared: int = 0):
        self.nodes = nodes
        self.full = full
        self.shared = shared

    @property
    def n_pages(self) -> int:
        return len(self.nodes)

    @property
    def kind(self) -> Optional[str]:
        if not self.nodes:
            return None
        return "full" if self.full else "partial"

    @property
    def coverage(self) -> int:
        return self.nodes[-1].coverage if self.nodes else 0


_NO_HIT = _AdmitHit(nodes=())

SNAPSHOT_INDEX = "index.json"
SNAPSHOT_ARRAYS = "arrays.npz"


def _snap_pack(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as host uint8 bytes (its last axis times the item size)
    and its dtype name: npz has no bfloat16, and bytes round-trip every
    dtype exactly."""
    t = t.detach().contiguous().cpu()
    return t.view(torch.uint8).numpy(), str(t.dtype).replace("torch.", "")


def _snap_unpack(packed: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    raw = torch.from_numpy(np.ascontiguousarray(packed))
    return raw.view(getattr(torch, dtype_name)).to(device)


def _node_content_digest(arrays: Dict[str, np.ndarray], i: int, n_leaves: int,
                         n_ring: int, rec: dict) -> str:
    """sha256 over node ``i``'s persisted bytes: its page in every pool
    leaf (scale pools included), its ring seams, its terminal logits.
    The chain digest covers the node's tokens; this covers what is
    stored, so bytes changed behind a rewritten manifest fail on load."""
    hasher = hashlib.sha256()
    for j in range(n_leaves):
        hasher.update(np.ascontiguousarray(arrays[f"pages_l{j}"][i]))
    if rec.get("has_ring"):
        for k in range(n_ring):
            hasher.update(np.ascontiguousarray(arrays[f"ring{i}_{k}"]))
    if rec.get("has_logits"):
        hasher.update(np.ascontiguousarray(arrays[f"logits{i}"]))
    return hasher.hexdigest()


def spec_model(dalle: DALLE, spec_k: int) -> DALLE:
    """The speculative engine's model: the same module (parameters
    shared) with ``shift_pad = spec_k``, so the decode caches built for
    it carry ``spec_k`` extra shift-ring rows, the rollback slack
    (``ops/layers.py:PreShiftToken``)."""
    if not dalle.shift_tokens:
        return dalle
    clone = copy.copy(dalle)
    clone.shift_pad = spec_k
    return clone


def fused_width(config: EngineConfig) -> int:
    """The fused block's width: the prefill chunk, or with speculation
    wide enough for a verify row (spec_k drafts and the input token)."""
    if config.spec_decode:
        return max(config.prefill_chunk, config.spec_k + 1)
    return config.prefill_chunk


def arena_rows_for(prefix_cache_pages: Optional[int], prompt_pages: int,
                   n_pages_slot: int) -> int:
    """Whole storage rows backing a requested arena capacity (None: four
    prompts' worth)."""
    want = prefix_cache_pages if prefix_cache_pages is not None else 4 * prompt_pages
    return -(-max(1, want) // n_pages_slot)


def _rings(cache: DecodeCache) -> list:
    return (cache.attn_rings or []) + (cache.ff_rings or [])


def _ring_snapshot(cache: DecodeCache, row: int) -> Optional[List[torch.Tensor]]:
    """The shift-ring seam of one cache row: a copy of every ring's
    history (attention rings, then feed-forward rings); None without
    token shift. Rows of one model's caches at any batch width restore
    into each other."""
    rings = _rings(cache)
    return [r.hist[row].clone() for r in rings] if rings else None


def _map_prefix_(cache: DecodeCache, row: int, ids: Optional[torch.Tensor], offset: int,
                 ring: Optional[List[torch.Tensor]]) -> None:
    """A prefix hit's table and state, in place: the row's first
    ``len(ids)`` table entries name the shared pages (``ids`` None: no
    table change, a private cache being seeded), every write index is
    ``offset`` and the rings take the seam captured at ``offset``."""
    for kv in cache.kv:
        if ids is not None and len(ids):
            kv.table[row, :len(ids)] = ids
        kv.index[row] = offset
    for r, hist in zip(_rings(cache), ring or [], strict=bool(ring)):
        r.hist[row] = hist
        r.index[row] = offset


def _copy_pages_(dst: DecodeCache, src: DecodeCache, src_ids, dst_ids, valid) -> None:
    """Copy pages ``src_ids`` of ``src``'s pools onto ``dst_ids`` of
    ``dst``'s (every layer, content and scale pools alike), rows past
    ``valid`` zeroed (``paged_kv.copy_pages_across_``)."""
    for d_kv, s_kv in zip(dst.kv, src.kv, strict=True):
        for d_pool, s_pool in zip(d_kv.pools(), s_kv.pools(), strict=True):
            paged_kv.copy_pages_across_(d_pool, s_pool, src_ids, dst_ids, valid)


class _PrefillFault(RuntimeError):
    """A ``prefill_fail`` fault fired in a monolithic prefill."""


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
        # prefix cache: the index nodes the slot maps read-only (their
        # references held until release), ring seams captured at page
        # boundaries during its prefill (by position), its terminal
        # logits, and the boundary below which nothing is captured
        # (already indexed)
        self.shared_nodes: list = []
        self.boundary_rings: dict = {}
        self.final_logits = None
        self.snap_from = 0
        # the open chunked-prefill span (telemetry on)
        self.prefill_span = None


class Engine:
    """See the module docstring. Host-side state machine + one device
    cache. ``faults``: the fault registry whose armed sites the engine
    fires (None: no faults). ``metric_labels``: the labels bound to
    every series the engine writes (None: the unlabelled series).
    ``fleet_occupancy``: a callable giving the occupancy the watermarks
    compare (a router's fleet aggregate; None: this engine's pool)."""

    def __init__(self, dalle: DALLE, config: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None, device="cuda",
                 stages: Optional[StageSpec] = None,
                 faults: Optional[FaultRegistry] = None,
                 metric_labels: Optional[dict] = None,
                 fleet_occupancy=None):
        if config.cost_ledger:
            raise NotImplementedError(
                "cost_ledger charges each dispatch with XLA's cost_analysis(), which "
                "torch has no counterpart of; utils/vitals.CostLedger awaits a charge "
                "from the port's own count"
            )
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
        self.spec = config.spec_decode
        if self.spec:
            if not self.fused:
                raise ValueError("spec_decode runs through the fused iteration (a verify "
                                 "row is a row of its block); enable fused_iteration")
            if config.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {config.spec_k}")
            if config.spec_draft_depth is not None and not (
                1 <= config.spec_draft_depth <= dalle.depth
            ):
                raise ValueError(f"spec_draft_depth must be in [1, {dalle.depth}] or None "
                                 f"(every layer), got {config.spec_draft_depth}")
            dalle = spec_model(dalle, config.spec_k)
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
        self._fleet_occupancy = fleet_occupancy

        self.counters = counters.child(metric_labels)
        self.gauges = gauges.child(metric_labels)
        self.histograms = histograms.child(metric_labels)
        # the open serve.request span of each live request (telemetry on)
        self._req_spans: Dict[str, Optional[int]] = {}

        B = config.max_batch
        self.page = kv_policy.page_size(config.page_size)
        self.T = dalle.text_len_internal
        self.n_pages_slot = pages_for(self.T + dalle.image_seq_len, self.page)
        # the prefix cache's arena: whole storage rows after the slot rows
        self._arena_rows = 0
        if config.prefix_cache:
            self._arena_rows = arena_rows_for(config.prefix_cache_pages,
                                              pages_for(self.T, self.page), self.n_pages_slot)
        full = (B + self._arena_rows) * self.n_pages_slot
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
                                       page_size=self.page, arena_rows=self._arena_rows)
        # bytes of K/V storage (content and scale pools) per slot row, from
        # the pool tensors themselves (the sink page excluded)
        self.kv_bytes_per_slot = sum(
            self.n_pages_slot * pool[0].numel() * pool.element_size()
            for kv in self.cache.kv for pool in kv.pools()
        )
        self._total_pool_pages = (B + self._arena_rows) * self.n_pages_slot
        # the prefix index over the arena's global page ids, its chain
        # root salted with the pools' storage format
        self.prefix: Optional[PrefixCache] = None
        if config.prefix_cache:
            n_p = self.n_pages_slot
            self.prefix = PrefixCache(range(B * n_p, (B + self._arena_rows) * n_p), self.page,
                                      format_tag=self._kv_format_tag(), faults=self.faults)
        if self.fused:
            self._W = fused_width(config)
            self._prompts = torch.zeros((B, self.T), dtype=torch.int32,
                                        device=self.device)
        self._zero_tok = torch.zeros((B,), dtype=torch.int32,
                                     device=self.device)
        # top-k count from the FULL vocab, applied to image-only logits
        self.k_img = max(int((1 - config.filter_thres) * dalle.total_tokens), 1)

        self.slots: List[Optional[_Slot]] = [None] * B
        self.results: Dict[str, RequestResult] = {}
        self._outcome_counts: Dict[Outcome, int] = {o: 0 for o in Outcome}
        self._live: set = set()
        self._cancel_requested: set = set()
        self._seq = 0
        self._admit_seq = 0
        self._submitted = 0
        # in-flight step awaiting readback: (device samples,
        # [(slot, kind)]); read back one step late with lookahead
        self._pending: Optional[Tuple[torch.Tensor, list]] = None
        # model calls (fused iterations; split: prefills, chunks and
        # decode steps) and full prefix hits' first-token draws, the split
        # path's prefills and chunks among them, the draws among them (no
        # model call), iterations that did work, and the speculative
        # drafter's width-1 steps (not dispatches) with its lifetime
        # drafted and accepted tokens
        self.dispatches = 0
        self.prefill_dispatches = 0
        self.cached_draws = 0
        self.iterations = 0
        self.draft_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        # post-decode stages: completed token work enters the pipeline
        # (holding no slot or pages) and stays live until a stage outcome
        self.postdecode: Optional[PostDecodePipeline] = None
        if stages is not None:
            self.postdecode = PostDecodePipeline(
                stages, self.clock, self._finish, occupancy=self._occupancy,
                counters=self.counters, histograms=self.histograms, faults=self.faults,
            )
        # the effective knobs: the configuration's until a controller
        # moves them (the verify width within spec_k, the ceiling the
        # block width and the shift rings were sized for)
        self._eff_spec_k = config.spec_k
        self._eff_watermark = config.high_watermark
        self.vitals: Optional[vitals_mod.Vitals] = None
        self.controller: Optional[Controller] = None
        self._control_interval = 0
        if config.vitals or config.controller:
            self.vitals = vitals_mod.Vitals(window=config.vitals_window)
        if config.controller:
            cc = config.control if config.control is not None else ControlConfig()
            self._control_interval = cc.interval
            self.controller = Controller(
                cc, spec_k_ceiling=config.spec_k if self.spec else None,
                budget_default=self.budget.budget if self.budget is not None else None,
                chunk=self.budget.chunk if self.budget is not None else 1,
                watermark_default=config.high_watermark,
                prefix_enabled=self.prefix is not None, faults=self.faults,
            )
        self._publish_kv_gauges()

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
        self._submitted += 1
        self.counters.inc("serve.submitted")
        entry = Entry(request=request, submit_time=self.clock.now(),
                      seq=self._seq)
        self._seq += 1
        self._req_spans[request.request_id] = TELEMETRY.begin(
            "serve.request", request_id=request.request_id,
            priority=request.priority, max_new_tokens=request.max_new_tokens)
        if self._worst_case_pages(request.max_new_tokens) > self.pool.total:
            return self._reject(entry, RejectReason.DEMAND_EXCEEDS_POOL)
        if not self.sched.submit(entry):
            return self._reject(entry, RejectReason.QUEUE_FULL)
        self._live.add(request.request_id)
        return None

    def submit_staged(self, request: Request, tokens, image=None) -> Optional[RequestResult]:
        """Admit a request whose token work is done straight into the
        post-decode pipeline: ``tokens`` its image tokens, ``image`` (when
        its VAE had run) its decoded image, so it resumes at VAE decode or
        at the rerank. The journal's replay and the router's failover
        resume through this; the boundaries are not announced again.
        ``submit``'s contract (None, the result landing in ``results``)."""
        if self.postdecode is None:
            raise ValueError("engine built without stages=StageSpec(...)")
        if request.request_id in self.results or request.request_id in self._live:
            raise ValueError(f"duplicate request_id {request.request_id!r}")
        self._submitted += 1
        self.counters.inc("serve.submitted")
        entry = Entry(request=request, submit_time=self.clock.now(), seq=self._seq)
        self._seq += 1
        entry.generated = [int(t) for t in np.asarray(tokens).reshape(-1)]
        self._req_spans[request.request_id] = TELEMETRY.begin(
            "serve.request", request_id=request.request_id,
            priority=request.priority, max_new_tokens=request.max_new_tokens)
        self._live.add(request.request_id)
        self.postdecode.enqueue(entry, np.asarray(tokens, np.int32), image=image,
                                announce=False)
        return None

    def can_admit_staged(self, request: Request) -> bool:
        """Whether a tokens-complete request can be dispatched here (the
        router's gate for staged work): the engine runs the stages;
        pipeline pressure degrades typed at entry."""
        return self.postdecode is not None

    def cancel(self, request_id: str) -> None:
        """Request cancellation; takes effect at the next iteration."""
        self._cancel_requested.add(request_id)

    def stats(self) -> dict:
        return {
            "submitted": self._submitted,
            "running": sum(bool(s) and s.phase == _DECODE for s in self.slots),
            "prefilling": sum(bool(s) and s.phase == _PREFILL for s in self.slots),
            "queued": len(self.sched),
            "staged": 0 if self.postdecode is None else len(self.postdecode),
            "pool_total": self.pool.total,
            "pool_used": self.pool.used,
            "pool_occupancy": self.pool.occupancy,
            "outcomes": {o.value: n for o, n in self._outcome_counts.items()},
        }

    def live_requests(self) -> List[Request]:
        """Every request still owed a terminal outcome: queued (in
        submission order), then running (in admission order), then
        staged. Replaying them on a fresh engine reproduces their tokens
        (the sampling contract)."""
        queued = [e.request for e in self.sched.entries()]
        running = [s.entry.request
                   for s in sorted((s for s in self.slots if s), key=lambda s: s.admit_seq)]
        staged = ([] if self.postdecode is None
                  else [st.entry.request for st in self.postdecode._staged])
        return queued + running + staged

    def can_admit(self, request: Request) -> bool:
        """Whether ``submit(request)`` now would be admitted at the next
        iteration: a free slot, nothing queued, and the worst-case pages of
        the budget it would receive within the free pages plus the index
        pages admission may reclaim (a hit could only lower the demand)."""
        if not any(s is None for s in self.slots) or len(self.sched):
            return False
        eff_max_new, _ = self._clamped_budget(request.max_new_tokens)
        avail = self.pool.free
        if self.prefix is not None:
            avail += self.prefix.reclaimable_pages()
        return self._worst_case_pages(eff_max_new) <= avail

    def step(self) -> bool:
        """One iteration: terminations -> admission -> device work (fused:
        one dispatch, speculative with its drafts; split: the decode step,
        then the budgeted prefill chunks), each with the previous step's
        readback -> budgeted stage work. False when fully idle."""
        self._sweep_terminations()
        self._admit()
        if self.fused:
            worked = self._spec_iteration() if self.spec else self._fused_iteration()
        else:
            worked = self._decode_once()
            worked = self._advance_prefills() or worked
        if self.postdecode is not None:
            worked = self.postdecode.step() or worked
        if worked:
            self.iterations += 1
        self.clock.tick()
        if self.vitals is not None and worked:
            self._observe_vitals()
            if self.controller is not None and self.iterations % self._control_interval == 0:
                self._run_controller()
        self._publish_gauges()
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
            self.counters.inc("serve.fault_request_cancel")
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
            # budget the request would actually receive, less the pages a
            # prefix hit maps shared; unreferenced index pages are
            # reclaimed before the request is left waiting
            eff_max_new, clamped = self._clamped_budget(entry.request.max_new_tokens)
            hit = self._probe_admission(entry)
            demand = self._worst_case_pages(eff_max_new) - hit.shared
            if demand > self.pool.free and not self._reclaim_index_pages(
                demand - self.pool.free
            ):
                if hit.nodes:
                    self.prefix.release(hit.nodes)
                return
            entry = self.sched.pop()
            entry.effective_max_new, entry.clamped = eff_max_new, clamped
            if clamped:
                self.counters.inc("serve.clamped")
            ok = self.pool.alloc(entry.request_id, pages_for(self.T, self.page) - hit.shared)
            assert ok, "admission checked worst-case > prompt pages"
            if hit.full:
                self._claim_full_hit_slot(entry, free[0], hit)
            elif self.config.prefill_chunk is not None:
                self._claim_prefill_slot(entry, free[0], hit)
            else:
                self._prefill_monolithic(entry, free[0])

    def _claim_prefill_slot(self, entry: Entry, idx: int, hit: _AdmitHit = _NO_HIT) -> None:
        """Chunked admission: the request claims its slot and prompt pages
        now; its chunks run over the following iterations (fused: into
        its row of the batched cache, from the prompts buffer; split: into
        a private batch-1 cache). A partial prefix hit starts the chunks at
        the miss boundary: fused, its pages mapped into the row's table
        read-only; split, copied into the private cache (references then
        dropped); either way with the boundary's ring seam restored."""
        req_span = self._note_admit(entry, idx)
        slot = _Slot(entry, idx, self._admit_seq)
        self._admit_seq += 1
        internal = self._to_device(self._internal_tokens(entry))
        nodes, s = hit.nodes, hit.coverage
        if self.fused:
            self._prompts[idx] = internal
            if nodes:
                ids = self._to_device(np.array([n.page_id for n in nodes], np.int32))
                _map_prefix_(self.cache, idx, ids, s, nodes[-1].ring)
                slot.shared_nodes = list(nodes)
        else:
            slot.cache1 = self._fresh_prefill_cache()
            slot.internal = internal[None]
            if nodes:
                _map_prefix_(slot.cache1, 0, None, s, nodes[-1].ring)
                _copy_pages_(slot.cache1, self.cache, [n.page_id for n in nodes],
                             list(range(len(nodes))), [self.page] * len(nodes))
                self.prefix.release(nodes)
        slot.filled = slot.snap_from = s
        slot.prefill_span = TELEMETRY.begin(
            "serve.prefill", request_id=entry.request_id, parent=req_span,
            attempt=entry.prefill_attempts, chunked=True, resumed_at=s)
        self.slots[idx] = slot
        self.counters.inc("serve.admitted")
        self._note_prefix_outcome(entry, hit, idx)

    def _claim_full_hit_slot(self, entry: Entry, idx: int, hit: _AdmitHit) -> None:
        """A full prefix hit: no prefill. The cached prompt pages are mapped
        into the row's table read-only, the terminal ring seam restored,
        and the first image token drawn from the cached terminal logits
        with the request's own (seed, T) draw, which is the cold run's
        token. A partial terminal page is copied into the row's own page
        first (copy-on-write): the first decode write lands inside it."""
        self._note_admit(entry, idx)
        nodes = hit.nodes
        terminal = nodes[-1]
        cow = terminal.valid < self.page
        shared = nodes[:-1] if cow else list(nodes)
        ids = self._to_device(np.array([n.page_id for n in shared], np.int32))
        _map_prefix_(self.cache, idx, ids, self.T, terminal.ring)
        if cow:
            _copy_pages_(self.cache, self.cache, [terminal.page_id],
                         [idx * self.n_pages_slot + len(nodes) - 1], [terminal.valid])
            self.prefix.release([terminal])
            self.counters.inc("serve.prefix.cow_copies")
        slot = _Slot(entry, idx, self._admit_seq)
        self._admit_seq += 1
        slot.shared_nodes = list(shared)
        slot.snap_from = self.T
        self.dispatches += 1
        self.counters.inc("serve.dispatches")
        self.cached_draws += 1
        tok0 = self._first_token(terminal.logits, entry)
        self.slots[idx] = slot
        self.counters.inc("serve.admitted")
        self._note_prefix_outcome(entry, hit, idx, cow=cow)
        self._start_decode(slot, tok0)

    def _prefill_monolithic(self, entry: Entry, idx: int) -> None:
        """Split admission without chunks: the whole prompt in one batch-1
        ``prefill_step``, the first image token drawn from its logits, the
        cache landed in the slot's row. A failed attempt gives the prompt
        pages back and requeues the request (at the head of the queue, so
        the admission loop retries it at once) until its attempts run
        out."""
        req_span = self._req_spans.get(entry.request_id)
        try:
            with TELEMETRY.span("serve.prefill", request_id=entry.request_id,
                                parent=req_span, attempt=entry.prefill_attempts):
                if self.faults.take("prefill_fail"):
                    raise _PrefillFault(entry.request_id)
                cache1 = self._fresh_prefill_cache()
                internal = self._to_device(self._internal_tokens(entry))[None]
                img = self.dalle.prefill_step(internal, cache1, image_only=True)
                self.dispatches += 1
                self.counters.inc("serve.dispatches")
                self.prefill_dispatches += 1
                tok0 = self._first_token(img, entry)
        except _PrefillFault:
            self.pool.free_all(entry.request_id)
            if self._prefill_retry(entry):
                self._prefill_failed(entry)
            else:
                self.sched.requeue(entry)
            return
        slot = _Slot(entry, idx, self._admit_seq)
        self._admit_seq += 1
        if self.prefix is not None:
            # monolithic prefill sees only the terminal boundary
            slot.boundary_rings[self.T] = _ring_snapshot(cache1, 0)
            slot.final_logits = img
        with TELEMETRY.span("serve.slot_insert", request_id=entry.request_id,
                            parent=req_span, slot=idx):
            insert_decode_cache(self.cache, cache1, idx)
        self._note_admit(entry, idx)
        self.slots[idx] = slot
        self.counters.inc("serve.admitted")
        self._note_prefix_outcome(entry, _NO_HIT, idx)
        self._start_decode(slot, tok0)

    def _note_admit(self, entry: Entry, idx: int) -> Optional[int]:
        """An admission's time, its queue wait (from the first submit: a
        replay keeps it) and its ``serve.admit`` event; returns the
        request's span."""
        now = self.clock.now()
        entry.admit_time = now
        req_span = self._req_spans.get(entry.request_id)
        self.histograms.observe("serve.queue_wait_s", now - entry.submit_time)
        TELEMETRY.event("serve.admit", request_id=entry.request_id, parent=req_span,
                        slot=idx, queue_wait_s=now - entry.submit_time,
                        clamped=entry.clamped)
        return req_span

    def _internal_tokens(self, entry: Entry) -> np.ndarray:
        """The request's (T,) remapped prompt, <bos> first; computed once
        and kept on the entry (the prefix chain's key)."""
        if entry.internal_tokens is None:
            prompt = torch.as_tensor(np.asarray(entry.request.prompt), dtype=torch.int32)[None]
            entry.internal_tokens = self.dalle.remap_text(prompt)[0].numpy()
        return entry.internal_tokens

    def _fresh_prefill_cache(self):
        """A pristine batch-1 paged cache for one split prefill."""
        return init_decode_cache(self.dalle, 1, "paged", kv_quant=self.kv_quant,
                                 page_size=self.page)

    def _first_token(self, img: torch.Tensor, entry: Entry) -> int:
        """A prefill's first image token, drawn from its (1, V_img)
        logits at position T with the request's seed (read back: the
        host decides the slot's first decode input)."""
        d = self._to_device(np.array([[entry.request.seed], [self.T]], np.int64))
        return int(self._draw(img, d[0], d[1])[0])

    def _prefill_retry(self, entry: Entry, filled: Optional[int] = None) -> bool:
        """Count a failed prefill attempt (``filled``: the chunk it failed
        at, chunked prefill); True once the request has failed
        ``prefill_attempts`` times, when the caller frees its pages and
        slot and ends it (``_prefill_failed``)."""
        self.counters.inc("serve.fault_prefill_fail")
        entry.prefill_attempts += 1
        self.counters.inc("serve.prefill_retries")
        where = {} if filled is None else {"chunk_start": filled}
        TELEMETRY.event("serve.prefill_retry", request_id=entry.request_id,
                        parent=self._req_spans.get(entry.request_id),
                        attempt=entry.prefill_attempts, **where)
        return entry.prefill_attempts >= self.config.prefill_attempts

    def _prefill_failed(self, entry: Entry, filled: Optional[int] = None) -> None:
        where = "" if filled is None else f" ({filled}/{self.T} tokens prefilled)"
        self._finish(entry, Outcome.PREFILL_FAILED, tokens=None,
                     detail=f"prefill failed after {entry.prefill_attempts} attempts{where}")

    def _occupancy(self) -> float:
        """The occupancy the watermarks compare: the fleet's when a router
        injected it, else this engine's pool."""
        if self._fleet_occupancy is not None:
            return self._fleet_occupancy()
        return self.pool.occupancy

    def _clamped_budget(self, want: int) -> Tuple[int, bool]:
        """(effective max_new_tokens, clamped?) under watermark
        degradation: clamped while the occupancy is above the effective
        watermark (``high_watermark`` unless the controller moved it)."""
        cfg = self.config
        if (cfg.degraded_max_new_tokens is not None
                and self._occupancy() > self._eff_watermark
                and want > cfg.degraded_max_new_tokens):
            return cfg.degraded_max_new_tokens, True
        return want, False

    def _worst_case_pages(self, max_new: int) -> int:
        # positions written: the prompt plus every generated token but
        # the last (a sampled token is cached when the next step consumes it)
        return pages_for(self.T + max_new - 1, self.page)

    # ------------------------------------------------------ prefix cache

    def _kv_format_tag(self) -> bytes:
        """The pools' storage format (quantization, page size, pool
        dtypes), the prefix chain's root salt; empty for unquantized
        pages."""
        if self.kv_quant == "none":
            return b""
        dts = sorted({str(pool.dtype).replace("torch.", "")
                      for kv in self.cache.kv for pool in kv.pools()})
        return f"kv:{self.kv_quant}:page{self.page}:{','.join(dts)}".encode()

    def _probe_admission(self, entry: Entry) -> _AdmitHit:
        """The usable prefix of the prompt's chain, its references
        acquired: a full hit needs the terminal logits and seam; a partial
        hit needs chunked prefill and a resumable boundary inside the
        prompt (the split path also refuses a 1-token tail, which would
        run as a width-1 chunk)."""
        if self.prefix is None:
            return _NO_HIT
        toks = self._internal_tokens(entry)
        col0 = self.prefix.stats.collisions
        nodes = self.prefix.probe(toks, self.clock.now(), count=False)
        if self.prefix.stats.collisions > col0:
            self.counters.inc("serve.fault_prefix_hash_collide")
        full = (bool(nodes) and nodes[-1].coverage == self.T
                and nodes[-1].logits is not None and nodes[-1].ring is not None)
        if not full:
            if self.config.prefill_chunk is None:
                nodes = []
            while nodes and (not nodes[-1].resumable or nodes[-1].coverage >= self.T
                             or (not self.fused and self.T - nodes[-1].coverage == 1)):
                nodes.pop()
        if not nodes:
            return _NO_HIT
        shared = len(nodes) if (full or self.fused) else 0
        if full and nodes[-1].valid < self.page:
            shared -= 1  # the partial terminal page is copied, not shared
        self.prefix.acquire(nodes, self.clock.now())
        return _AdmitHit(nodes=nodes, full=full, shared=shared)

    def _note_prefix_outcome(self, entry: Entry, hit: _AdmitHit, idx: int,
                             cow: bool = False) -> None:
        """One hit or miss per admission (a replay counts again); the hit
        class of the admission that produces the first token."""
        if self.prefix is None:
            return
        if hit.n_pages:
            self.prefix.stats.hits += 1
            self.counters.inc("serve.prefix.hits")
            self.counters.inc("serve.prefix.pages_hit", hit.n_pages)
            TELEMETRY.event("serve.prefix_hit", request_id=entry.request_id,
                            parent=self._req_spans.get(entry.request_id), slot=idx,
                            pages=hit.n_pages, kind=hit.kind, coverage=hit.coverage, cow=cow)
        else:
            self.prefix.stats.misses += 1
            self.counters.inc("serve.prefix.misses")
        if entry.ttft_s is None:
            entry.hit_class = hit.kind

    def _reclaim_index_pages(self, n: int) -> bool:
        """The index's eviction tier: drop unreferenced LRU leaves until
        ``n`` pages are free. False, evicting nothing, when it cannot
        free that many (a partial reclaim would wipe the cached set
        without admitting anyone)."""
        if self.prefix is None or self.prefix.reclaimable_pages() < n:
            return False
        freed = 0
        while freed < n and self.prefix.evict_one() is not None:
            self.pool.release(PREFIX_HOLDER, 1)
            self.counters.inc("serve.prefix.evictions")
            freed += 1
        return freed >= n

    def _maybe_snapshot(self, slot: _Slot, cache: DecodeCache, row: int) -> None:
        """Capture the ring seam when a prefill lands on a page boundary
        (or the prompt's end) past the indexed prefix: the payload that
        makes the published node resumable."""
        if self.prefix is None:
            return
        s = slot.filled
        if s > slot.snap_from and (s == self.T or s % self.page == 0):
            slot.boundary_rings[s] = _ring_snapshot(cache, row)

    def _publish(self, slot: _Slot) -> None:
        """Publish a completing request's prompt pages into the index.
        Pages already on the chain count as deduplicated (and gain any
        seam or logits this run saw); new pages are copied into arena
        pages in one copy and committed with their seams. Fail-open: an
        exhausted arena or budget, or the ``prefix_publish_fail`` fault,
        leaves the pages private and the request completes."""
        if self.faults.take("prefix_publish_fail"):
            self.counters.inc("serve.fault_prefix_publish_fail")
            self._publish_skip()
            return
        toks = self._internal_tokens(slot.entry)
        blocks = chain_blocks(toks, self.page)
        now = self.clock.now()
        existing = self.prefix.match(toks)
        dedup = max(0, len(existing) - len(slot.shared_nodes))
        if dedup:
            self.prefix.stats.deduped += dedup
            self.counters.inc("serve.prefix.pages_deduped", dedup)
        for node in existing:
            self.prefix.upgrade(node, ring=slot.boundary_rings.get(node.coverage),
                                logits=slot.final_logits if node.coverage == self.T else None)
        if len(existing) == len(blocks):
            return
        # pin the chain (and each new node) against the reclaim an
        # allocation below may run: a reclaimed parent would orphan
        protected = list(existing)
        self.prefix.acquire(protected, now)
        src, dst, valids = [], [], []
        try:
            parent = existing[-1] if existing else None
            for k in range(len(existing), len(blocks)):
                block = blocks[k]
                cov = k * self.page + len(block)
                ring = slot.boundary_rings.get(cov)
                logits = slot.final_logits if cov == self.T else None
                if cov == self.T and ring is None and logits is None:
                    # a terminal node that could serve no hit
                    break
                page_id = self.prefix.alloc_page()
                if page_id is None and self._reclaim_index_pages(1):
                    page_id = self.prefix.alloc_page()
                if page_id is None:
                    self._publish_skip()
                    break
                if not self.pool.alloc(PREFIX_HOLDER, 1) and not (
                    self._reclaim_index_pages(1) and self.pool.alloc(PREFIX_HOLDER, 1)
                ):
                    self.prefix.return_page(page_id)
                    self._publish_skip()
                    break
                node = self.prefix.insert(parent, block, start=k * self.page,
                                          page_id=page_id, now=now, ring=ring, logits=logits)
                self.prefix.acquire([node], now)
                protected.append(node)
                parent = node
                src.append(slot.index * self.n_pages_slot + k)
                dst.append(page_id)
                valids.append(len(block))
        finally:
            self.prefix.release(protected)
        if dst:
            _copy_pages_(self.cache, self.cache, src, dst, valids)
            self.counters.inc("serve.prefix.published", len(dst))

    def _publish_skip(self) -> None:
        self.prefix.stats.publish_skips += 1
        self.counters.inc("serve.prefix.publish_skips")

    # ------------------------------------------------ prefix snapshots

    def _pool_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, flat pool) of every K/V pool leaf of the batched cache:
        layer l's ``kv.{l}.k_pages`` and ``v_pages`` (the model's dtype, or
        int8), then with int8 pages its ``k_scale_pages`` and
        ``v_scale_pages`` (float32, one scale a token and head). A page of
        global id g is row g of each flat pool. The JAX package's leaves
        are named by its flax tree paths, so a snapshot it wrote is
        refused here as a foreign format (cache leaf paths differ)."""
        out = []
        for l, kv in enumerate(self.cache.kv):
            for name in ("k", "v", "k_scale", "v_scale"):
                pool = getattr(kv, name)
                if pool is not None:
                    out.append((f"kv.{l}.{name}_pages", pool))
        return out

    def _ring_paths(self) -> List[str]:
        """Names of the ring seam's tensors, in ``_ring_snapshot``'s order."""
        c = self.cache
        return ([f"attn_ring.{i}" for i in range(len(c.attn_rings or []))]
                + [f"ff_ring.{i}" for i in range(len(c.ff_rings or []))])

    def save_prefix_snapshot(self, dirpath: str) -> int:
        """Persist the prefix index and its arena pages to ``dirpath``:
        ``index.json`` (``snapshot_records``, each with its content
        digest, and the format: page size, T, the KV format tag, leaf
        names, dtypes) and ``arrays.npz`` (each node's page of every pool
        leaf, ring seams and terminal logits, as bytes), then the
        committed manifest (``write_dir_manifest``) last. The snapshot is
        built in ``dirpath + ".tmp"`` and swapped in, so a crash leaves
        the previous one intact. Returns the nodes written. Off the hot
        path: one device read per leaf."""
        assert self.prefix is not None, "save_prefix_snapshot needs prefix_cache"
        final = Path(dirpath)
        root = Path(str(final) + ".tmp")
        if root.exists():
            shutil.rmtree(root)
        root.mkdir(parents=True, exist_ok=True)
        records = snapshot_records(self.prefix)
        nodes = {n.digest.hex(): n for n in self.prefix.nodes()}
        leaves = self._pool_leaves()
        ids = torch.tensor([rec["page_id"] for rec in records], dtype=torch.long)
        arrays: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for j, (_, pool) in enumerate(leaves):
            key = f"pages_l{j}"
            arrays[key], dtypes[key] = _snap_pack(pool[ids.to(pool.device)])
        ring_paths = self._ring_paths()
        for i, rec in enumerate(records):
            node = nodes[rec["digest"]]
            if node.ring is not None:
                assert len(node.ring) == len(ring_paths), "ring seam of another model"
                for k, hist in enumerate(node.ring):
                    key = f"ring{i}_{k}"
                    arrays[key], dtypes[key] = _snap_pack(hist)
            if node.logits is not None:
                arrays[f"logits{i}"], dtypes[f"logits{i}"] = _snap_pack(node.logits)
        for i, rec in enumerate(records):
            rec["content_sha256"] = _node_content_digest(arrays, i, len(leaves),
                                                         len(ring_paths), rec)
        index = {
            "format": 1,
            "page_size": self.page,
            "T": self.T,
            "n_pages_slot": self.n_pages_slot,
            "kv_format": self._kv_format_tag().decode(),
            "leaf_paths": [name for name, _ in leaves],
            "ring_paths": ring_paths,
            "dtypes": dtypes,
            "nodes": records,
        }
        np.savez(root / SNAPSHOT_ARRAYS, **arrays)
        (root / SNAPSHOT_INDEX).write_text(json.dumps(index, sort_keys=True))
        write_dir_manifest(str(root), extra={"meta": {"kind": "prefix_snapshot",
                                                      "nodes": len(records)}})
        old = Path(str(final) + ".old")
        if old.exists():
            shutil.rmtree(old)
        if final.exists():
            final.rename(old)
        root.rename(final)
        if old.exists():
            shutil.rmtree(old)
        self.counters.inc("serve.snapshot.saved")
        return len(records)

    def _reject_snapshot(self, reason: str) -> bool:
        self.counters.inc("serve.snapshot.rejected")
        TELEMETRY.event("serve.snapshot_reject", reason=reason[:200])
        return False

    def load_prefix_snapshot(self, dirpath: str) -> bool:
        """Restore a snapshot into this engine's empty index (the warm
        restart). Verification, in order: the committed manifest; the
        format, page size, T, KV format tag, leaf names and every leaf's
        dtype against this engine's cache; every record's chain digest
        recomputed (``verify_snapshot_records``; the ``snapshot_corrupt``
        fault changes a token of the first block first); every payload
        present with its length; every node's content digest; room in the
        arena and the budget. Any failure rejects the whole snapshot
        (``serve.snapshot.rejected``, a ``serve.snapshot_reject`` event)
        and leaves the index cold. True when restored."""
        assert self.prefix is not None, "load_prefix_snapshot needs prefix_cache"
        assert len(self.prefix) == 0, "a snapshot restores into an empty index"
        ok, reason = verify_dir_manifest(dirpath)
        if not ok:
            return self._reject_snapshot(f"manifest: {reason}")
        root = Path(dirpath)
        try:
            index = json.loads((root / SNAPSHOT_INDEX).read_text())
            with np.load(root / SNAPSHOT_ARRAYS) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError) as e:
            return self._reject_snapshot(f"unreadable: {e}")
        if index.get("format") != 1:
            return self._reject_snapshot(f"unknown format {index.get('format')!r}")
        records = list(index.get("nodes", []))
        if records and self.faults.take("snapshot_corrupt"):
            self.counters.inc("serve.fault_snapshot_corrupt")
            records[0] = dict(records[0], tokens=[int(t) + 1 for t in records[0]["tokens"]])
        leaves = self._pool_leaves()
        dtypes = index.get("dtypes", {})
        ring_paths = index.get("ring_paths", [])
        if index.get("page_size") != self.page or index.get("T") != self.T:
            return self._reject_snapshot(
                f"shape mismatch: snapshot (page={index.get('page_size')}, T={index.get('T')}) "
                f"vs engine (page={self.page}, T={self.T})")
        tag = self._kv_format_tag().decode()
        if index.get("kv_format", "") != tag:
            return self._reject_snapshot(
                f"kv format mismatch: snapshot {index.get('kv_format', '')!r} vs engine {tag!r}")
        if index.get("leaf_paths") != [name for name, _ in leaves]:
            return self._reject_snapshot("cache leaf paths differ")
        if ring_paths != self._ring_paths():
            return self._reject_snapshot("ring seam paths differ")
        for j, (name, pool) in enumerate(leaves):
            have = str(pool.dtype).replace("torch.", "")
            if dtypes.get(f"pages_l{j}") != have:
                return self._reject_snapshot(
                    f"cache dtype mismatch at {name}: snapshot {dtypes.get(f'pages_l{j}')} "
                    f"vs engine {have}")
        ok, reason = verify_snapshot_records(records, self.page, format_tag=self._kv_format_tag())
        if not ok:
            return self._reject_snapshot(reason)
        for j, (_, pool) in enumerate(leaves):
            stack = arrays.get(f"pages_l{j}")
            want = (len(records),) + tuple(pool.shape[1:-1]) + (pool.shape[-1] * pool.element_size(),)
            if stack is None or stack.shape != want:
                return self._reject_snapshot(f"page array pages_l{j} missing or wrong length")
        for i, rec in enumerate(records):
            if rec["has_ring"] and any(f"ring{i}_{k}" not in arrays or f"ring{i}_{k}" not in dtypes
                                       for k in range(len(ring_paths))):
                return self._reject_snapshot(f"record {i}: ring payload missing from arrays")
            if rec["has_logits"] and (f"logits{i}" not in arrays or f"logits{i}" not in dtypes):
                return self._reject_snapshot(f"record {i}: logits payload missing from arrays")
        for i, rec in enumerate(records):
            if rec.get("content_sha256") != _node_content_digest(arrays, i, len(leaves),
                                                                 len(ring_paths), rec):
                return self._reject_snapshot(
                    f"record {i}: page content digest mismatch (tampered or missing payload bytes)")
        if len(records) > self.prefix.free_arena_pages:
            return self._reject_snapshot(
                f"{len(records)} nodes exceed the {self.prefix.free_arena_pages}-page arena")
        if not self.pool.alloc(PREFIX_HOLDER, len(records)):
            return self._reject_snapshot(f"{len(records)} pages exceed the free page budget")
        now = self.clock.now()
        by_digest: Dict[str, object] = {}
        gids: List[int] = []
        for i, rec in enumerate(records):
            page_id = self.prefix.alloc_page()
            assert page_id is not None, "free_arena_pages said it fits"
            parent = None if rec["parent"] is None else by_digest[rec["parent"]]
            ring = None
            if rec["has_ring"]:
                ring = [_snap_unpack(arrays[f"ring{i}_{k}"], dtypes[f"ring{i}_{k}"], self.device)
                        for k in range(len(ring_paths))]
            logits = None
            if rec["has_logits"]:
                logits = _snap_unpack(arrays[f"logits{i}"], dtypes[f"logits{i}"], self.device)
            node = self.prefix.insert(parent, np.asarray(rec["tokens"], np.int64),
                                      start=int(rec["start"]), page_id=page_id, now=now,
                                      ring=ring, logits=logits)
            by_digest[rec["digest"]] = node
            gids.append(page_id)
        if gids:
            ids = torch.tensor(gids, dtype=torch.long, device=self.device)
            for j, (_, pool) in enumerate(leaves):
                pool[ids] = _snap_unpack(arrays[f"pages_l{j}"], dtypes[f"pages_l{j}"],
                                         self.device)
        self.counters.inc("serve.snapshot.restored")
        return True

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
                    if self._prefill_retry(slot.entry, slot.filled):
                        self._release_slot(slot)
                        self._prefill_failed(slot.entry, slot.filled)
                    break
                worked = True
                self.counters.inc("serve.prefill_chunks")
                start = slot.filled
                chunk = slot.internal[:, start:start + c]
                grant -= c
                final = start + c >= self.T
                with TELEMETRY.span("serve.prefill_chunk", request_id=slot.entry.request_id,
                                    parent=slot.prefill_span, start=start, tokens=c):
                    self.dispatches += 1
                    self.counters.inc("serve.dispatches")
                    self.prefill_dispatches += 1
                    img = self.dalle.prefill_chunk(chunk, start, slot.cache1,
                                                   return_logits=False, image_only=final)
                    if final:
                        tok0 = self._first_token(img, slot.entry)
                    elif self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                slot.filled += c
                self._maybe_snapshot(slot, slot.cache1, 0)
                if not final:
                    continue
                if self.prefix is not None:
                    slot.final_logits = img
                self._finish_prefill(slot, tok0)
                break
        return worked

    def _finish_prefill(self, slot: _Slot, tok0: int) -> None:
        """The final chunk drew the first image token: land the batch-1
        cache in the slot's row and start decoding."""
        TELEMETRY.end(slot.prefill_span, outcome="completed")
        slot.prefill_span = None
        with TELEMETRY.span("serve.slot_insert", request_id=slot.entry.request_id,
                            parent=self._req_spans.get(slot.entry.request_id), slot=slot.index):
            insert_decode_cache(self.cache, slot.cache1, slot.index)
        slot.cache1 = slot.internal = None
        self._start_decode(slot, tok0)

    def _start_decode(self, slot: _Slot, tok0: int) -> None:
        """A split prefill (or a full prefix hit) is complete: its first
        token, read back, is the slot's first decode input."""
        slot.phase, slot.pos, slot.tok, slot.tok_on_device = _DECODE, self.T, tok0, False
        slot.entry.generated = [tok0]
        self._record_first_token(slot.entry)
        if len(slot.entry.generated) >= slot.entry.effective_max_new:
            self._complete(slot)

    def _decode_once(self) -> bool:
        """The split path's decode step over every dispatchable slot, plus
        the previous step's readback."""
        self._maybe_stall()
        dispatchable = self._grow_pages(self._decodable())
        if not dispatchable:
            return self._swap_pending(None)
        # one span a dispatched step, over its dispatch and the previous
        # step's readback
        with TELEMETRY.span("serve.decode_step", n_active=len(dispatchable),
                            lookahead=self.config.decode_lookahead):
            self.counters.inc("serve.decode_steps")
            self._swap_pending(self._dispatch_decode(dispatchable, self._pending))
        return True

    def _dispatch_decode(self, dispatchable: List[_Slot], pending):
        """One ``DALLE.decode_step`` at per-row positions over every row,
        descriptors assembled on the host and copied in one transfer.
        Rows: 0 position, 1 seed, 2 host token, 3 host-token flag. Input
        tokens come from the in-flight samples where the slot's token is
        still there; host-decided tokens (a fresh prefill's first token,
        a synchronous readback) are scattered over them. A row without a
        dispatched slot writes garbage: a free or prefilling row at
        position 0 of its own pages, which its next insert overwrites or
        its release resets; a decoding row whose last token is in flight
        at its own frontier, past every page it maps shared (never at
        position 0, which may lie in a shared prefix page)."""
        desc = np.zeros((4, self.config.max_batch), np.int64)
        for s in self.slots:
            if s is not None and s.phase == _DECODE:
                desc[0, s.index] = s.pos
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
        self.counters.inc("serve.dispatches")
        self._advance_decoded(dispatchable)
        return samples, [(s, _DECODE) for s in dispatchable]

    # --------------------------------------------------- fused iteration

    def _next_chunk_fused(self, filled: int) -> int:
        """The fused path's next chunk: no tail merge (every row of the
        block is computed at the block's width)."""
        return min(self.config.prefill_chunk, self.T - filled)

    def _plan_fused_prefills(self, decode_tokens: int) -> List[Tuple[_Slot, int]]:
        """One fused iteration's chunk grants (``plan_iteration``), after
        decode's charge (one token a decoding row; a speculative row's
        whole verify width). A failed chunk is not dispatched; its retry
        resumes from it next iteration."""
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
                if self._prefill_retry(s.entry, s.filled):
                    self._release_slot(s)
                    self._prefill_failed(s.entry, s.filled)
                continue
            chunks.append((s, self._next_chunk_fused(s.filled)))
        return chunks

    def _fused_iteration(self) -> bool:
        self._maybe_stall()
        dispatchable = self._grow_pages(self._decodable())
        chunks = self._plan_fused_prefills(len(dispatchable))
        if not (dispatchable or chunks):
            return self._swap_pending(None)
        with TELEMETRY.span("serve.iteration", n_decode=len(dispatchable),
                            n_prefill=len(chunks), lookahead=self.config.decode_lookahead):
            self._swap_pending(self._dispatch_fused(dispatchable, chunks, self._pending))
        return True

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
            self.counters.inc("serve.prefill_chunks")
            desc[:2, s.index] = (s.filled, c)
            if s.filled + c >= self.T:
                desc[2:5, s.index] = (1, s.entry.request.seed, self.T)
                entries.append((s, _PREFILL))
        d = self._to_device(desc)
        start, length = d[0].to(torch.int32), d[1].to(torch.int32)
        final = d[2].bool()
        prev_tok = pending[0] if pending is not None else self._zero_tok
        tok = torch.where(d[6].bool(), d[5].to(torch.int32), prev_tok)
        samples, logits = self._iteration(tok, start, length, final, d[3], d[4],
                                          any_final=bool(desc[2].any()))
        if dispatchable:
            self.counters.inc("serve.decode_steps")
        self.dispatches += 1
        self.counters.inc("serve.dispatches")
        self._advance_decoded(dispatchable)
        self._advance_chunks(chunks, logits)
        for s, c in chunks:
            if s.filled >= self.T:
                # its first image token is in the in-flight samples
                s.tok_on_device = True
        return samples, entries

    def _advance_chunks(self, chunks: List[Tuple[_Slot, int]], logits) -> None:
        """After a fused dispatch: advance each chunk's fill frontier,
        capture page-boundary ring seams, and move rows whose final chunk
        ran to decode (their cache is complete; the first token's value
        arrives at readback), keeping their terminal logits for the
        prefix cache."""
        for s, c in chunks:
            s.filled += c
            self._maybe_snapshot(s, self.cache, s.index)
            if s.filled >= self.T:
                if self.prefix is not None:
                    s.final_logits = logits[s.index:s.index + 1].clone()
                TELEMETRY.end(s.prefill_span, outcome="completed")
                s.prefill_span = None
                s.phase, s.pos, s.tok_on_device = _DECODE, self.T, False

    def _iteration(self, tok, start, length, final, seeds, draw_pos,
                   any_final: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One whole iteration on the device: per-row token blocks (decode
        rows take ``tok``, prefill rows gather their chunk from the prompts
        buffer), ``DALLE.fused_step``, image-only top-k, and the
        (seed, position) draw. Returns the (B,) int32 samples and the
        (B, V_img) logits they were drawn from."""
        tokens = self._block_tokens(start, F.pad(tok[:, None], (0, self._W - 1)))
        logits = self.dalle.fused_step(tokens, start, length, final,
                                       self.cache, rowwise_head=any_final)
        return self._draw(logits, seeds, draw_pos), logits

    def _block_tokens(self, start, dec_tok) -> torch.Tensor:
        """The (B, W) token block: decode (and verify) rows take
        ``dec_tok``, prefill rows their chunk from the prompts buffer."""
        T = self.T
        j = torch.arange(self._W, device=self.device)[None]
        chunk = self._prompts.gather(1, (start.long()[:, None] + j).clamp(max=T - 1))
        return torch.where((start >= T)[:, None], dec_tok, chunk)

    # --------------------------------------------------- speculative decode

    def _spec_iteration(self) -> bool:
        """One speculative iteration: the fused iteration's descriptors,
        with every decoding row a verify row of width
        1 + min(k, remaining - 1), k the effective ``spec_k`` (the
        controller's, at most the configured ceiling; capped so the last
        position written never passes plain decode's), its pages grown to cover the
        whole row, and the token budget charged the verify widths. The
        ``spec_verify_abort`` fault (consulted only when a row decodes)
        runs the iteration at width 1. Synchronous: the accepted counts
        are read back before the next descriptors are built."""
        self._maybe_stall()
        dispatchable = [
            s for s in self.slots
            if s and s.phase == _DECODE
            and len(s.entry.generated) < s.entry.effective_max_new
        ]
        spec_on = True
        if dispatchable and self.faults.take("spec_verify_abort"):
            spec_on = False
            self.counters.inc("serve.fault_spec_verify_abort")
            self.counters.inc("serve.spec.fallbacks")
        widths: Dict[int, int] = {}
        for s in dispatchable:
            remaining = s.entry.effective_max_new - len(s.entry.generated)
            widths[id(s)] = min(self._eff_spec_k + 1, remaining) if spec_on else 1
        dispatchable = self._grow_pages(dispatchable, widths)
        chunks = self._plan_fused_prefills(sum(widths[id(s)] for s in dispatchable))
        if not dispatchable and not chunks:
            return False
        with TELEMETRY.span("serve.iteration", n_decode=len(dispatchable),
                            n_prefill=len(chunks), lookahead=False, spec=spec_on):
            with TELEMETRY.span("serve.spec_verify", n_verify=len(dispatchable),
                                drafted=sum(widths[id(s)] - 1 for s in dispatchable)):
                self._spec_readback(*self._dispatch_spec(dispatchable, widths, chunks))
        return True

    def _dispatch_spec(self, verifies: List[_Slot], widths: Dict[int, int],
                       chunks: List[Tuple[_Slot, int]]):
        """Draft, then verify in one fused dispatch. Rows: 0 start, 1
        length, 2 final, 3 seed, 4 input token. Drafts are drawn from the
        drafter's logits with the (seed, position) draw of the position
        they fill, which the verify column predicting it uses too. Returns
        the host copy of [verify samples (B, K) | drafts (B, K - 1) |
        final-chunk samples (B, 1)], the entries, and K."""
        B, T = self.config.max_batch, self.T
        desc = np.zeros((5, B), np.int64)
        entries = []
        for s in verifies:
            k = widths[id(s)]
            desc[:, s.index] = (s.pos, k, 0, s.entry.request.seed, s.tok)
            entries.append((s, _DECODE, k))
        for s, c in chunks:
            self.counters.inc("serve.prefill_chunks")
            final = s.filled + c >= T
            desc[:4, s.index] = (s.filled, c, final, s.entry.request.seed)
            if final:
                entries.append((s, _PREFILL, c))
        if verifies:
            self.counters.inc("serve.decode_steps")
        K = max((widths[id(s)] for s in verifies), default=1)
        d = self._to_device(desc)
        start, length = d[0].to(torch.int32), d[1].to(torch.int32)
        final, seeds, tok = d[2].bool(), d[3], d[4].to(torch.int32)
        drafts = self._draft(tok, start, seeds, K - 1)
        dec = F.pad(torch.stack([tok] + drafts, dim=1), (0, self._W - K))
        any_final = bool(desc[2].any())
        cols, last = self.dalle.fused_step(self._block_tokens(start, dec), start, length,
                                           final, self.cache, rowwise_head=any_final,
                                           verify_cols=K)
        j = torch.arange(K, device=self.device)
        samples = self._draw(cols.flatten(0, 1), seeds.repeat_interleave(K),
                             (start.long()[:, None] + j + 1).flatten()).view(B, K)
        first = self._draw(last, seeds, torch.full_like(seeds, T))
        out = torch.cat([samples] + [t[:, None] for t in drafts] + [first[:, None]], dim=1)
        self.dispatches += 1
        self.counters.inc("serve.dispatches")
        self._advance_chunks(chunks, last)
        return out.cpu().numpy(), entries, K

    def _draft(self, tok, start, seeds, steps: int) -> List[torch.Tensor]:
        """``steps`` width-1 draft steps of every verify row (a row at an
        image position) through the first ``spec_draft_depth`` layers,
        each drawing the next token with its position's draw. Writes K/V
        at positions start .. start + steps - 1 and advances the rings in
        place (the module docstring: the verify block rewrites the
        positions it reads)."""
        drafts: List[torch.Tensor] = []
        if steps <= 0:
            return drafts
        d_len = (start >= self.T).to(torch.int32)
        no_final = torch.zeros_like(d_len, dtype=torch.bool)
        cur = tok
        for i in range(steps):
            logits = self.dalle.fused_step(cur[:, None], start + i, d_len, no_final,
                                           self.cache, rowwise_head=False,
                                           depth_limit=self.config.spec_draft_depth)
            cur = self._draw(logits, seeds, start.long() + i + 1)
            drafts.append(cur)
        self.draft_steps += steps
        return drafts

    def _spec_readback(self, out: np.ndarray, entries, K: int) -> None:
        """Commit each verify row's accepted prefix: drafts taken while
        they equal the target's samples, then the target's next sample
        (1 to width tokens, plain decode's tokens); the host position moves
        to the accepted frontier, where the next block is anchored. Final
        chunks' first tokens land; the drafted and accepted tallies."""
        samples, drafts, first = out[:, :K], out[:, K:2 * K - 1], out[:, 2 * K - 1]
        for s, kind, k in entries:
            if self.slots[s.index] is not s:
                continue
            if kind == _PREFILL:
                s.tok = int(first[s.index])
                s.entry.generated = [s.tok]
                self._record_first_token(s.entry)
            else:
                m = 0
                while m < k - 1 and drafts[s.index, m] == samples[s.index, m]:
                    m += 1
                toks = [int(t) for t in samples[s.index, :m + 1]]
                s.entry.generated.extend(toks)
                s.tok = toks[-1]
                s.pos += m + 1
                self._spec_drafted += k - 1
                self._spec_accepted += m
                self.counters.inc("serve.spec.drafted", k - 1)
                self.counters.inc("serve.spec.accepted", m)
                self.counters.inc("serve.spec.rejected", k - 1 - m)
                self.histograms.observe("serve.spec_accepted_per_step", float(m + 1))
            if len(s.entry.generated) >= s.entry.effective_max_new:
                self._complete(s)

    # ---------------------------------------------- shared decode plumbing

    def _draw(self, logits, seeds, positions) -> torch.Tensor:
        """Image-only top-k (the full vocab's k), temperature, and the
        (seed, position) draw: (b,) int32."""
        filtered = top_k_filter(logits, k=self.k_img) / self.config.temperature
        return sample(filtered, seeds, positions)

    def _maybe_stall(self) -> None:
        """The ``decode_stall`` fault: the clock jumps by the penalty."""
        if self.faults.take("decode_stall"):
            self.counters.inc("serve.fault_decode_stall")
            TELEMETRY.event("serve.decode_stall", penalty_s=self.config.stall_penalty_s)
            self.clock.advance(self.config.stall_penalty_s)

    def _decodable(self) -> List[_Slot]:
        """The decoding slots to dispatch this step: a slot whose
        in-flight sample completes its budget is not dispatched again."""
        in_flight = set() if self._pending is None else {id(s) for s, _ in self._pending[1]}
        return [
            s for s in self.slots
            if s and s.phase == _DECODE
            and len(s.entry.generated) + (id(s) in in_flight)
            < s.entry.effective_max_new
        ]

    def _grow_pages(self, slots: List[_Slot],
                    widths: Optional[Dict[int, int]] = None) -> List[_Slot]:
        """Grow the pages of the decoding ``slots``, highest effective
        priority first, to cover the positions their block writes
        ([0, pos + width - 1]; width 1, or a verify row's from
        ``widths``) less the prefix pages the slot maps shared (charged
        to the index), preempting when the pool runs short. Returns the
        slots still running."""
        for s in sorted(slots, key=lambda s: -self.sched.effective_priority(s.entry)):
            if self.slots[s.index] is not s:
                continue  # preempted by an earlier slot's growth
            width = 1 if widths is None else widths[id(s)]
            needed = (s.pos + width - 1) // self.page + 1 - len(s.shared_nodes)
            deficit = needed - self.pool.held(s.entry.request_id)
            if deficit > 0:
                self._alloc_or_preempt(s, deficit)
        return [s for s in slots if self.slots[s.index] is s]

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
        the first production, the replay regenerates it. Observed into
        ``serve.ttft_s`` and, under the prefix cache, the histogram of the
        admission's hit class."""
        if entry.ttft_s is not None:
            return
        entry.ttft_s = self.clock.now() - entry.submit_time
        self.histograms.observe("serve.ttft_s", entry.ttft_s)
        if self.prefix is not None:
            kind = {"full": "full_hit", "partial": "partial_hit"}.get(entry.hit_class, "cold")
            self.histograms.observe(f"serve.ttft_{kind}_s", entry.ttft_s)
        TELEMETRY.event("serve.first_token", request_id=entry.request_id,
                        parent=self._req_spans.get(entry.request_id), ttft_s=entry.ttft_s)

    # -------------------------------------------------------- preemption

    def _alloc_or_preempt(self, slot: _Slot, n: int) -> bool:
        """Allocate ``n`` pages for ``slot``, evicting until they fit:
        unreferenced prefix-index pages first, then running requests (or,
        under the ``page_exhaust`` fault, a request once regardless).
        False when the slot itself was the victim."""
        while True:
            blocked = self.faults.take("page_exhaust")
            if blocked:
                self.counters.inc("serve.fault_page_exhaust")
            if not blocked and self.pool.alloc(slot.entry.request_id, n):
                return True
            if not blocked and self._reclaim_index_pages(1):
                continue
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
        self.counters.inc("serve.preempted")
        TELEMETRY.event("serve.evict", request_id=entry.request_id,
                        parent=self._req_spans.get(entry.request_id),
                        preempt_count=entry.preempt_count,
                        tokens_discarded=len(entry.generated))
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
        """Drop the slot's prefix references (refcounts only: the shared
        pages live in arena rows, which no reset names), return its pages
        and reset its cache row to pristine (scale pools included; the
        table back to identity). A split-path prefilling slot never wrote
        its row (its chunks live in the batch-1 cache, dropped here)."""
        if slot.shared_nodes:
            self.prefix.release(slot.shared_nodes)
            slot.shared_nodes = []
        self.pool.free_all(slot.entry.request_id)
        assert 0 <= slot.index < self.config.max_batch, (
            f"slot reset named row {slot.index} outside the slot rows "
            f"[0, {self.config.max_batch}): arena rows are owned by the prefix "
            "index and never reset here"
        )
        self.slots[slot.index] = None
        if slot.phase == _PREFILL:
            TELEMETRY.end(slot.prefill_span, outcome="aborted", filled=slot.filled)
            slot.prefill_span = None
            if not self.fused:
                slot.cache1 = slot.internal = None
                return
        self.cache.reset_row_(slot.index)

    def _complete(self, slot: _Slot) -> None:
        if self.prefix is not None:
            # before the release, whose reset zeroes the pages copied
            self._publish(slot)
        self._release_slot(slot)
        tokens = np.asarray(slot.entry.generated, np.int32)
        if self.postdecode is not None:
            self.postdecode.enqueue(slot.entry, tokens)
        else:
            self._finish(slot.entry, Outcome.COMPLETED, tokens=tokens)

    def _reject(self, entry: Entry, reason: RejectReason) -> RequestResult:
        self.counters.inc("serve.rejected")
        self.counters.inc(f"serve.rejected.{reason.value}")
        TELEMETRY.end(self._req_spans.pop(entry.request_id, None),
                      outcome=Outcome.REJECTED.value, reject_reason=reason.value)
        self.histograms.observe("serve.request_latency_s", 0.0)
        # a load-typed reject carries a backoff hint scaled by the
        # occupancy; a demand that can never fit gets none
        hint = retry_after_hint(self._occupancy()) if reason is RejectReason.QUEUE_FULL else None
        result = RequestResult(
            request_id=entry.request_id, outcome=Outcome.REJECTED,
            reject_reason=reason, total_latency_s=0.0, retry_after_s=hint,
        )
        self.results[entry.request_id] = result
        self._outcome_counts[Outcome.REJECTED] += 1
        return result

    def _finish(self, entry: Entry, outcome: Outcome,
                tokens: Optional[np.ndarray], image=None,
                rerank_score: Optional[float] = None, detail: str = "") -> None:
        now = self.clock.now()
        self._live.discard(entry.request_id)
        self.counters.inc(f"serve.{outcome.value}")
        # the lifecycle span ends in the typed outcome
        TELEMETRY.end(self._req_spans.pop(entry.request_id, None), outcome=outcome.value,
                      n_tokens=0 if tokens is None else int(len(tokens)),
                      preempt_count=entry.preempt_count, detail=detail)
        self.histograms.observe("serve.request_latency_s", now - entry.submit_time)
        if outcome is Outcome.COMPLETED:
            self.histograms.observe("serve.completed_latency_s", now - entry.submit_time)
        self._outcome_counts[outcome] += 1
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

    def _publish_kv_gauges(self) -> None:
        self.gauges.set("serve.kv_quant.bytes_per_slot", float(self.kv_bytes_per_slot))
        self.gauges.set("serve.kv_quant.pages", float(self._total_pool_pages))

    def _publish_gauges(self) -> None:
        """The engine's levels after an iteration."""
        self._publish_kv_gauges()
        if self.vitals is not None:
            self.vitals.publish(self.gauges)
        self.gauges.set("serve.pool_occupancy", self.pool.occupancy)
        self.gauges.set("serve.running", sum(bool(s) and s.phase == _DECODE for s in self.slots))
        self.gauges.set("serve.prefilling",
                        sum(bool(s) and s.phase == _PREFILL for s in self.slots))
        self.gauges.set("serve.queued", len(self.sched))
        if self.postdecode is not None:
            self.gauges.set("serve.stage.queued", len(self.postdecode))
        if self.spec:
            self.gauges.set("serve.spec_accept_frac",
                            self._spec_accepted / self._spec_drafted if self._spec_drafted
                            else 0.0)
        if self.prefix is not None:
            probes = self.prefix.stats.hits + self.prefix.stats.misses
            self.gauges.set("serve.prefix_hit_frac",
                            self.prefix.stats.hits / probes if probes else 0.0)
            self.gauges.set("serve.prefix_pages", float(len(self.prefix)))

    # ------------------------------------------------ vitals and control

    def _observe_vitals(self) -> None:
        """One worked iteration's numbers into the vitals windows."""
        prefix = self.prefix.stats if self.prefix is not None else None
        self.vitals.observe_iteration(
            now=self.clock.now(),
            occupancy=self._occupancy(),
            stage_queued=0.0 if self.postdecode is None else len(self.postdecode),
            spec_drafted=self._spec_drafted,
            spec_accepted=self._spec_accepted,
            prefix_hits=0 if prefix is None else prefix.hits,
            prefix_misses=0 if prefix is None else prefix.misses,
            deadline_misses=self._outcome_counts[Outcome.DEADLINE_EXCEEDED],
            terminations=sum(self._outcome_counts.values()),
        )

    def _run_controller(self) -> None:
        """One evaluation between iterations: the vitals window in, the
        effective knobs out, the decision a ``serve.control.decision``
        event. A raising controller (the ``control_stall`` fault) resets
        every knob to its default, typed and counted."""
        snap = self.vitals.snapshot()
        self.counters.inc("serve.control.decisions")
        try:
            decision = self.controller.evaluate(self.iterations, snap)
        except Exception:
            self.counters.inc("serve.fault_control_stall")
            self.counters.inc("serve.control.stalls")
            self.controller.reset()
            decision = self.controller.record_stall(self.iterations, snap)
        if decision.changed:
            self.counters.inc("serve.control.adjustments")
        self._apply_knobs(decision)
        TELEMETRY.event("serve.control.decision", iteration=decision.iteration,
                        changed=decision.changed, stalled=decision.stalled,
                        reasons=list(decision.reasons), vitals=dict(decision.vitals),
                        knobs=dict(decision.knobs))

    def _apply_knobs(self, decision) -> None:
        """Apply a decision's knobs (the channels of ``serving/control.py``)
        and publish the effective levels as ``serve.control.*``."""
        k = decision.knobs
        if self.spec and k.get("spec_k") is not None:
            self._eff_spec_k = min(max(1, int(k["spec_k"])), self.config.spec_k)
        self._eff_watermark = float(k["watermark"])
        if self.budget is not None and k.get("budget") is not None:
            b = max(1, int(k["budget"]))
            if b != self.budget.budget:
                self.budget = TokenBudget(budget=b, chunk=self.budget.chunk)
        tgt = k.get("prefix_pages_target")
        if tgt is not None and self.prefix is not None:
            excess = len(self.prefix) - max(0, int(tgt))
            if excess > 0:
                self._reclaim_index_pages(min(excess, self.prefix.reclaimable_pages()))
        self.gauges.set("serve.control.spec_k", float(self._eff_spec_k))
        self.gauges.set("serve.control.budget",
                        float(self.budget.budget)
                        if self.budget is not None and self.budget.budget is not None else -1.0)
        self.gauges.set("serve.control.watermark", self._eff_watermark)
        self.gauges.set("serve.control.prefix_pages_target", -1.0 if tgt is None else float(tgt))

    def verify_invariants(self, idle: bool = False) -> None:
        """Assert the engine's accounting (``AssertionError`` on a
        violation), valid mid-flight: every submitted request is live or
        has one result; the live set is the queued, running and staged
        requests; every page holder is a running request or the prefix
        index; the index is charged exactly its pages, its arena neither
        leaks nor aliases, and its references equal the shared mappings
        the slots hold. With ``idle`` (after ``run()``) also: nothing
        queued, running or staged, no in-flight step of a live slot, and
        the pool down to the index's pages (the index survives a drain)."""
        running = {s.entry.request_id for s in self.slots if s}
        queued = self.sched.ids()
        staged = (set() if self.postdecode is None
                  else {st.entry.request_id for st in self.postdecode._staged})
        both = [rid for rid in self._live if rid in self.results]
        assert not both, f"request both live and finished: {sorted(both)}"
        assert len(self.results) + len(self._live) == self._submitted, (
            f"{self._submitted} submitted but {len(self.results)} results "
            f"+ {len(self._live)} live"
        )
        assert self._live == queued | running | staged, (
            f"live {sorted(self._live)} != queued {sorted(queued)} | running "
            f"{sorted(running)} | staged {sorted(staged)}"
        )
        assert self.pool.holders() - {PREFIX_HOLDER} <= running, (
            f"page leak: pages held by {sorted(self.pool.holders() - {PREFIX_HOLDER} - running)}"
        )
        index_pages = 0
        if self.prefix is not None:
            index_pages = len(self.prefix)
            assert self.pool.held(PREFIX_HOLDER) == index_pages, (
                f"prefix budget drift: index holds {index_pages} pages but is charged "
                f"{self.pool.held(PREFIX_HOLDER)}"
            )
            self.prefix.verify_invariants()
            mapped = sum(len(s.shared_nodes) for s in self.slots if s)
            assert self.prefix.total_refs() == mapped, (
                f"prefix refcount drift: {self.prefix.total_refs()} references held but "
                f"{mapped} shared table mappings live"
            )
        if not idle:
            return
        assert not running and not queued and not staged, "engine not idle"
        pending = [] if self._pending is None else [s for s, _ in self._pending[1]]
        assert not any(self.slots[s.index] is s for s in pending), (
            "engine idle with a live in-flight step"
        )
        assert self.pool.used == index_pages, (
            f"page leak: {self.pool.used} pages held, {index_pages} by the prefix index"
        )
