"""The registry of telemetry names (counterpart of
``dalle_pytorch_tpu/utils/telemetry_names.py``, whose sets it keeps as
they are, flat literals, so that a test or a tool can check names
against them).

Every counter, gauge, histogram, span and event name is declared here
under its kind, one dot-separated namespace a subsystem: ``serve.*`` the
engine and its post-decode stages, ``train.*`` the trainer, ``data.*`` /
``webdata.*`` the tar loader, ``telemetry.*`` the layer itself,
``router.*`` the replicated front door, ``serve.vitals.*`` and
``serve.control.*`` the vitals and the controller (and the JAX package's
``download.*`` names, which the port does not emit). Names built from an enum value
(``f"serve.{outcome.value}"``) are registered by their expansions. A
span's duration histogram ``<span>_s`` (observed by
``utils/telemetry.py``) is derived: ``SPAN_DURATION_HISTOGRAMS``.
Host-side only: imports nothing.
"""

from __future__ import annotations

# --------------------------------------------------------------- spans

SPANS = frozenset({
    # serving engine (serving/engine.py)
    "serve.request",        # submit -> typed outcome (the lifecycle span)
    "serve.prefill",        # monolithic, or cross-iteration when chunked
    "serve.prefill_chunk",  # one per chunk, synced in-span
    "serve.slot_insert",
    "serve.decode_step",    # one per DISPATCHED decode step (split mode)
    "serve.iteration",      # one per fused ragged iteration (one dispatch)
    "serve.spec_verify",    # one per speculative iteration: draft+verify+
                            # accept dispatch and its synchronous readback
    # post-decode pipeline (serving/postdecode.py): one span per batched
    # stage dispatch — the auto "<span>_s" histograms ARE the per-stage
    # latency distributions
    "serve.stage.vae_decode",
    "serve.stage.clip_rerank",
    # replicated front door (serving/router.py)
    "router.request",       # router submit -> typed outcome
    # trainer (train_dalle.py)
    "train.step",           # dispatch -> verdict (device-inclusive)
    "train.data_wait",
    "train.ckpt_save",
})

# -------------------------------------------------------------- events

EVENTS = frozenset({
    # serving engine
    "serve.admit",
    "serve.first_token",
    "serve.evict",
    "serve.decode_stall",
    "serve.prefill_retry",
    "serve.prefix_hit",      # admission mapped >=1 cached prompt page
    "serve.snapshot_reject", # prefix snapshot failed verify-on-load
    # adaptive control loop (serving/control.py): one per controller
    # evaluation, carrying its input vitals and output knobs — the
    # audit/replay record (DESIGN.md §8.6)
    "serve.control.decision",
    # replicated front door
    "router.respawn",        # dead replica rebuilt and readmitted HEALTHY
    "router.respawn_fail",   # a respawn attempt failed (or exhausted)
    "router.shed",
    "router.drain",
    "router.drained",
    "router.failover",
    "router.failover_dispatch",
    "router.invariant_violation",
    "router.breaker_open",
    "router.readmit",
    # trainer
    "train.nan_skip",
    "train.nan_abort",
    "train.preempt_signal",
    # data loaders (data/webdata.py)
    "data.shard_open",
    "data.shard_quarantined",
    "data.shard_abort",
})

# ------------------------------------------------------------ counters

COUNTERS = frozenset({
    # serving engine lifecycle
    "serve.submitted",
    "serve.admitted",
    "serve.completed",
    "serve.rejected",
    # typed-outcome tallies (f"serve.{outcome.value}" expansions)
    "serve.deadline_exceeded",
    "serve.cancelled",
    "serve.preempt_cap",
    "serve.prefill_failed",
    "serve.completed_tokens_only",
    "serve.completed_unranked",
    # typed-reject tallies (f"serve.rejected.{reason.value}" expansions)
    "serve.rejected.demand_exceeds_pool",
    "serve.rejected.queue_full",
    "serve.rejected.no_replica",
    # engine work/robustness tallies
    "serve.clamped",
    "serve.preempted",
    "serve.decode_steps",
    "serve.dispatches",     # model-jit dispatches (fused: 1/iteration)
    "serve.prefill_chunks",
    "serve.prefill_retries",
    "serve.fault_request_cancel",
    "serve.fault_prefill_fail",
    "serve.fault_decode_stall",
    "serve.fault_page_exhaust",
    "serve.fault_prefix_hash_collide",
    "serve.fault_prefix_publish_fail",
    "serve.fault_spec_verify_abort",
    "serve.fault_journal_torn",
    "serve.fault_snapshot_corrupt",
    "serve.fault_vae_decode_fail",
    "serve.fault_rerank_fail",
    "serve.fault_stage_timeout",
    "serve.fault_control_stall",
    # adaptive control loop (serving/control.py; DESIGN.md §8.6)
    "serve.control.decisions",    # controller evaluations run
    "serve.control.adjustments",  # evaluations that changed >=1 knob
    "serve.control.stalls",       # evaluations degraded to static defaults
    # post-decode pipeline (serving/postdecode.py; DESIGN.md §8.5)
    "serve.stage.enqueued",        # requests entering the pipeline
    "serve.stage.vae_images",      # VAE_DECODE stage completions (images)
    "serve.stage.reranked",        # CLIP_RERANK stage completions (scores)
    "serve.stage.retries",         # failed stage attempts backed off
    "serve.stage.timeouts",        # dispatches past the stage time budget
    "serve.stage.degraded",        # typed-degraded completions (both kinds)
    "serve.stage.journal_records", # stage-boundary WAL records written
    # crash recovery (serving/journal.py + engine snapshot; §8.3)
    "serve.journal.appended",   # admitted-request WAL records written
    "serve.journal.replayed",   # unfinished requests resubmitted on restart
    "serve.journal.torn",       # torn tail records detected and dropped
    "serve.snapshot.saved",     # prefix-cache snapshots committed to disk
    "serve.snapshot.restored",  # snapshots verified and restored (warm start)
    "serve.snapshot.rejected",  # snapshots refused by verify-on-load
    # speculative decoding (serving/engine.py:_spec_iteration)
    "serve.spec.drafted",     # draft tokens proposed to verify rows
    "serve.spec.accepted",    # drafts committed by exact-match acceptance
    "serve.spec.rejected",    # drafts discarded (rolled back)
    "serve.spec.fallbacks",   # iterations degraded to plain decode
    # cross-request prefix cache (serving/prefix_cache.py)
    "serve.prefix.hits",          # probes matching >=1 page
    "serve.prefix.misses",        # probes matching nothing
    "serve.prefix.pages_hit",     # cached pages mapped/copied at admission
    "serve.prefix.pages_deduped", # publish-side pages already indexed
    "serve.prefix.cow_copies",    # shared terminal pages privatized
    "serve.prefix.published",     # pages newly committed to the index
    "serve.prefix.evictions",     # LRU index evictions (budget/arena)
    "serve.prefix.publish_skips", # fail-open publishes (arena/budget full)
    # replicated front door
    "router.submitted",
    "router.shed",
    "router.drains",
    "router.drained",
    "router.readmits",
    "router.breaker_opens",
    "router.replica_deaths",
    "router.failovers",
    "router.no_replica",
    "router.fault_replica_crash",
    "router.fault_replica_stall",
    "router.fault_health_flap",
    "router.fault_replica_respawn_fail",
    "router.respawns",          # dead replicas rebuilt and readmitted
    # typed-outcome tallies (f"router.{outcome.value}" expansions)
    "router.completed",
    "router.rejected",
    "router.deadline_exceeded",
    "router.cancelled",
    "router.preempt_cap",
    "router.prefill_failed",
    "router.completed_tokens_only",
    "router.completed_unranked",
    # trainer
    "train.nan_skips",
    # data paths (the webdata.* names data.* events carry; DESIGN.md §8)
    "webdata.decode_errors",
    "webdata.shard_open_retries",
    "webdata.shards_quarantined",
    "webdata.shards_opened",
    "webdata.quarantined_skips",
    "webdata.shard_aborts",
    "download.retries",
    "download.failures",
    # the telemetry layer's self-accounting
    "telemetry.dropped",
    "telemetry.sink_errors",
})

# -------------------------------------------------------------- gauges

GAUGES = frozenset({
    "serve.pool_occupancy",
    "serve.running",
    "serve.prefilling",
    "serve.queued",
    "serve.stage.queued",        # requests parked in the post-decode pipeline
    "serve.prefix_hit_frac",     # hits / (hits + misses), lifetime
    "serve.prefix_pages",        # pages currently held by the index
    "serve.spec_accept_frac",    # accepted / drafted, lifetime
    # KV storage-format footprint (quantized-KV capacity lever, §6.1):
    # bytes of K/V storage (content + scale pools) per slot row, and
    # total physical pages per pool (slots + prefix arena) — int8 pools
    # roughly halve bytes_per_slot, which is the ~2x pages-at-fixed-HBM
    # headline bench.py --serve asserts
    "serve.kv_quant.bytes_per_slot",
    "serve.kv_quant.pages",
    # engine vitals: sliding-window reductions over existing metrics
    # (utils/vitals.py; DESIGN.md §8.6) — the controller's inputs
    "serve.vitals.spec_accept_rate",    # windowed accepted/drafted
    "serve.vitals.prefix_hit_frac",     # windowed hits/(hits+misses)
    "serve.vitals.decode_gap_s",        # windowed max inter-iteration gap
    "serve.vitals.stage_lag",           # windowed mean post-decode depth
    "serve.vitals.deadline_miss_rate",  # windowed misses/terminations
    "serve.vitals.occupancy",           # windowed mean pool occupancy
    "serve.vitals.roofline_frac",       # iteration FLOPs/s vs device peak
    # effective knob levels the control loop last applied
    "serve.control.spec_k",
    "serve.control.budget",
    "serve.control.watermark",
    "serve.control.prefix_pages_target",
    "router.queued",
    "router.fleet_occupancy",
    "router.replicas_live",
    "router.replica_state_code",
})

# ---------------------------------------------------------- histograms

HISTOGRAMS = frozenset({
    "serve.queue_wait_s",
    "serve.ttft_s",
    "serve.request_latency_s",
    "serve.completed_latency_s",
    # request -> image end-to-end latency: submit to full-pipeline DONE
    # (image-bearing completions only; DESIGN.md §8.5)
    "serve.stage.request_to_image_s",
    "router.failover_latency_s",
    # TTFT split by prefix-cache hit class (serve.ttft_s still carries
    # every request; bench's cached-vs-cold comparison reads these)
    "serve.ttft_full_hit_s",
    "serve.ttft_partial_hit_s",
    "serve.ttft_cold_s",
    # tokens committed per speculative verify step (1 .. spec_k+1); the
    # bench's accepted-tokens-per-step distribution reads this
    "serve.spec_accepted_per_step",
    # replica kill -> healthy-again (respawn) MTTR, per replica label —
    # the bench recovery record's source
    "serve.recovery_s",
    # backoff hints attached to load-typed rejections (queue_full /
    # no_replica): what the fleet told clients to wait — the traffic
    # sim's storm-amplification guard reads this distribution
    "router.retry_after_s",
})

# span durations are auto-observed as "<span>_s" (utils/telemetry.py);
# derived here so readers (bench latency splits) can validate against it
SPAN_DURATION_HISTOGRAMS = frozenset(s + "_s" for s in SPANS)

ALL_NAMES = SPANS | EVENTS | COUNTERS | GAUGES | HISTOGRAMS

_KINDS = {
    "span": SPANS,
    "event": EVENTS,
    "counter": COUNTERS,
    "gauge": GAUGES,
    "histogram": HISTOGRAMS | SPAN_DURATION_HISTOGRAMS,
}


def is_registered(name: str, kind: str = None) -> bool:
    """True iff ``name`` is registered (optionally under ``kind`` in
    span/event/counter/gauge/histogram)."""
    if kind is None:
        return name in ALL_NAMES or name in SPAN_DURATION_HISTOGRAMS
    return name in _KINDS[kind]
