"""Engine telemetry: the serving hot path rendered measurable.

Counterpart of ``ray_tpu/llm/telemetry.py``, with every metric name and
label as the reference has them, recorded into the port's
``util/metrics.py`` registry (read back with ``collect_store()`` or
rendered by ``prometheus_lines``). Reference role: vLLM's
Stats/StatLogger pipeline (engine-loop iteration stats feeding
Prometheus) and the reference serve deployments' per-request metrics.
The hooks cost a few dict updates per engine step and never touch the
device.

Every metric carries an ``engine`` label ("paged" / "dense") so mixed
deployments stay separable; gauges additionally carry a ``proc``
(host:pid) label because they are last-write-wins on the head — without
it, replicas of the same engine kind would overwrite each other. When
tracing is enabled each request carries the trace context it was
submitted under (``util/tracing.py``); the reference's ``llm.request``
span, recorded into its runtime's timeline, is not ported yet. Under the
port's runtime a worker's registry flushes to the head
(``util/metrics.py``), and a worker's exit zeroes its per-proc gauges
first (``zero_proc_gauges``).

Metric names (all prefixed ``rtpu_llm_``):
  ttft_seconds           histogram  submit -> first generated token
  inter_token_seconds    histogram  mean gap between generated tokens
  queue_wait_seconds     histogram  submit -> admission into the batch
  e2e_seconds            histogram  submit -> request retired
  batch_occupancy        gauge      active slots / max_batch_size
  kv_utilization         gauge      KV pages in use / pool size (paged)
  pending_requests       gauge      submitted, not yet admitted
  prefilling_requests    gauge      admitted, prompt not fully prefilled
  decoding_requests      gauge      in the decode set
  tokens_generated_total counter    generated tokens
  requests_total         counter    retired requests, by finish label
  preemptions_total      counter    requests finished early (KV pool dry)
  spec_proposed_total    counter    speculative tokens proposed
  spec_accepted_total    counter    speculative tokens accepted
  dispatches_total       counter    device dispatches, by program family
  prefix_cache_hits_total      counter  full prompt pages served from cache
  prefix_cache_misses_total    counter  full prompt pages computed by prefill
  prefix_cache_evictions_total counter  cached pages reclaimed under pressure
  prefix_cache_tokens_saved_total counter  prompt tokens whose prefill was
      skipped via cached pages
  prefix_cached_pages    gauge      unreferenced pages retained for reuse
  prefix_cache_hit_rate  gauge      hits / (hits + misses), cumulative
  prefix_cache_imported_pages_total counter  pages seeded from another
      replica's export (cross-replica prefix sharing)
  prefix_cache_exported_pages_total counter  cached pages gathered to host
      for another replica's import
  prefix_spill_{pages,bytes,demotions,promotions,expired,drops}_total
      counters  the host spill tier (llm/tiering.py), from engine.stats
  prefix_spill_resident_{pages,bytes} gauges  what the tier holds now
  lora_{requests,hits,loads,evictions,swaps}_total counters  the
      multi-LoRA manager's resolves (llm/multilora/manager.py)
  lora_publishes_total   counter    registry publishes, by namespace
  lora_resident_adapters gauge      slot-table rows holding an adapter

Cache heat plane (llm/chainstats.py) — per-chain series, bounded to the
engine's top-K chains plus the ``__overflow__`` sink so label
cardinality can never follow prompt diversity:
  prefix_chain_hits         gauge  cumulative page hits, per hot chain
  prefix_chain_tokens_saved gauge  prompt tokens skipped, per hot chain
  prefix_chain_resident_pages gauge  pages of the chain now in HBM
  prefix_chain_last_hit_age_s gauge  seconds since the chain last hit
  prefix_chain_tracked      gauge  chains with dedicated slots (rollup)

The prefix gauges and the fleet rollup both read
``engine.prefix_accounting()`` — the single accounting source shared
with ``pool_stats()`` — so surfaces cannot drift apart.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Optional

from ..util.metrics import (LATENCY_BUCKETS, Counter, Gauge, Histogram,
                            cached_metric)


def _hist(name, desc, boundaries=LATENCY_BUCKETS):
    return cached_metric(Histogram, name, desc, boundaries=boundaries,
                         tag_keys=("engine",))


def _gauge(name, desc):
    # gauges carry a per-process label: they are last-write-wins on the
    # head, so two replicas of the same engine kind flushing under one
    # key would mask each other (a saturated replica's kv_utilization
    # hidden by an idle one). Counters/histograms sum deltas and stay
    # engine-keyed.
    return cached_metric(Gauge, name, desc, tag_keys=("engine", "proc"))


_proc_pid = None
_proc_label = ""


def _proc() -> str:
    """host:pid, re-derived after fork so a worker never inherits the
    parent's identity."""
    global _proc_pid, _proc_label
    pid = os.getpid()
    if pid != _proc_pid:
        import socket
        _proc_pid = pid
        _proc_label = f"{socket.gethostname()}:{pid}"
    return _proc_label


def _counter(name, desc, tag_keys=("engine",)):
    return cached_metric(Counter, name, desc, tag_keys=tag_keys)


def zero_proc_gauges() -> None:
    """Exit-path hook (core/worker.py): zero this process's per-proc
    gauge series before the final flush, so a downscaled replica's last
    values don't pin the head's merged store forever. Best-effort — a
    SIGKILLed replica skips it."""
    try:
        from ..util import metrics as um
        um.zero_gauges(("proc", _proc()))
    except Exception:
        pass  # lost telemetry on exit is acceptable


def _never_raise(fn):
    """These hooks sit inside the engine step loop and submit path; an
    exception here (e.g. a user metric registered under a colliding
    name) must degrade to lost telemetry, never kill the engine thread
    and strand every in-flight request."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        try:
            return fn(*args, **kw)
        except Exception:
            pass  # contract: degrade to lost telemetry
    return wrapped


# --------------------------------------------------------------------- #
# hooks (called by engine.py / paged_engine.py)
# --------------------------------------------------------------------- #

@_never_raise
def on_submit(engine, req) -> None:
    """Stamp trace/request identity on the request at intake. Runs on the
    submitter's thread (inside the replica's activated task span when the
    request came through Serve), so the engine loop thread can emit the
    request's span later without any contextvar of its own."""
    req.submit_wall = time.time()
    try:
        from ..util import tracing
        if tracing.tracing_enabled():
            req.trace_ctx = tracing.current_context() or \
                (tracing.new_trace_id(), None)
        from ..serve.context import get_request_context
        req.request_id = get_request_context().request_id
    except Exception:
        pass  # tracing/request context are optional


@_never_raise
def on_admit(engine, req) -> None:
    req.admit_t = time.perf_counter()


@_never_raise
def on_first_token(engine, req) -> None:
    tags = {"engine": engine.telemetry_kind}
    if req.submit_t:
        _hist("rtpu_llm_ttft_seconds",
              "time to first generated token").observe(
            req.first_token_t - req.submit_t, tags=tags)
        if req.admit_t:
            _hist("rtpu_llm_queue_wait_seconds",
                  "submit to batch admission").observe(
                max(req.admit_t - req.submit_t, 0.0), tags=tags)


@_never_raise
def on_finish(engine, req, finish: Optional[str] = None) -> None:
    now = time.perf_counter()
    if finish is None:
        eos = engine._eos_id()
        if eos is not None and eos in req.out_ids:
            finish = "stop"
        elif len(req.out_ids) >= req.params.max_tokens:
            finish = "length"
        else:
            finish = "other"
    tags = {"engine": engine.telemetry_kind}
    _counter("rtpu_llm_requests_total", "retired requests",
             tag_keys=("engine", "finish")).inc(
        1.0, tags={**tags, "finish": finish})
    if req.submit_t:
        _hist("rtpu_llm_e2e_seconds", "submit to retirement").observe(
            now - req.submit_t, tags=tags)
    n = len(req.out_ids)
    if n > 1 and req.first_token_t:
        _hist("rtpu_llm_inter_token_seconds",
              "mean inter-token gap over the request").observe(
            max(now - req.first_token_t, 0.0) / (n - 1), tags=tags)


@_never_raise
def on_preempted(engine) -> None:
    _counter("rtpu_llm_preemptions_total",
             "requests finished early because the KV page pool ran "
             "dry").inc(1.0, tags={"engine": engine.telemetry_kind})


@_never_raise
def on_step(engine) -> None:
    """Per-step gauges + counter deltas from the engine's stats dict.
    Cheap on purpose: a handful of dict updates under one lock, all
    host-side state (never forces a device transfer)."""
    kind = engine.telemetry_kind
    tags = {"engine": kind}
    gtags = {"engine": kind, "proc": _proc()}
    cfg = engine.cfg
    _gauge("rtpu_llm_batch_occupancy",
           "active decode slots / max_batch_size").set(
        len(engine._active) / max(cfg.max_batch_size, 1), tags=gtags)
    _gauge("rtpu_llm_pending_requests",
           "submitted, not yet admitted").set(
        len(engine._pending), tags=gtags)
    _gauge("rtpu_llm_decoding_requests", "requests in the decode set").set(
        len(engine._active), tags=gtags)
    prefilling = getattr(engine, "_prefilling", None)
    if prefilling is not None:
        _gauge("rtpu_llm_prefilling_requests",
               "admitted, prompt not fully prefilled").set(
            len(prefilling), tags=gtags)
    free = getattr(engine, "_free_pages", None)
    if free is not None:
        pool = cfg.num_pages - 1  # page 0 is the write sink
        # cached (unreferenced, prefix-reusable) pages are reclaimable on
        # demand: they count as capacity, not utilization — a warm cache
        # must not read as a saturated pool
        cached = len(getattr(engine, "_cached_lru", ()))
        _gauge("rtpu_llm_kv_utilization",
               "KV pages in use / pool size").set(
            (pool - len(free) - cached) / max(pool, 1), tags=gtags)
        if getattr(engine, "_prefix_on", False):
            # single accounting source (paged_engine.prefix_accounting):
            # the gauges here, pool_stats() and metrics_summary() must
            # agree by construction, not by parallel bookkeeping
            acct = engine.prefix_accounting()
            _gauge("rtpu_llm_prefix_cached_pages",
                   "unreferenced KV pages retained for prefix reuse").set(
                acct["cached_pages"], tags=gtags)
            if acct["hits"] + acct["misses"]:
                _gauge("rtpu_llm_prefix_cache_hit_rate",
                       "prefix cache hits / (hits + misses)").set(
                    acct["hit_rate"], tags=gtags)
            if getattr(engine, "spill", None) is not None:
                # tier-resident gauges: what the host tier holds NOW
                # (same accounting snapshot as the counters above)
                _gauge("rtpu_llm_prefix_spill_resident_pages",
                       "prefix pages resident in the host spill "
                       "tier").set(
                    acct["spill_resident_pages"], tags=gtags)
                _gauge("rtpu_llm_prefix_spill_resident_bytes",
                       "bytes resident in the host spill tier").set(
                    acct["spill_resident_bytes"], tags=gtags)
    stats = getattr(engine, "stats", None)
    if stats:
        _ship_stat_deltas(engine, stats, tags)
    if getattr(engine, "chains", None) is not None:
        _ship_chain_stats(engine, gtags)


_STAT_COUNTERS = (
    ("tokens_out", "rtpu_llm_tokens_generated_total",
     "generated tokens", None),
    ("spec_proposed", "rtpu_llm_spec_proposed_total",
     "speculative draft tokens proposed", None),
    ("spec_accepted", "rtpu_llm_spec_accepted_total",
     "speculative draft tokens accepted", None),
    ("prefill_dispatches", "rtpu_llm_dispatches_total",
     "device dispatches by program family", "prefill"),
    ("decode_dispatches", "rtpu_llm_dispatches_total",
     "device dispatches by program family", "decode"),
    ("spec_dispatches", "rtpu_llm_dispatches_total",
     "device dispatches by program family", "verify"),
    ("prefix_hits", "rtpu_llm_prefix_cache_hits_total",
     "full prompt pages served from the prefix cache", None),
    ("prefix_misses", "rtpu_llm_prefix_cache_misses_total",
     "full prompt pages computed by prefill", None),
    ("prefix_evictions", "rtpu_llm_prefix_cache_evictions_total",
     "cached pages reclaimed under allocation pressure", None),
    ("prefix_tokens_saved", "rtpu_llm_prefix_cache_tokens_saved_total",
     "prompt tokens whose prefill was skipped via cached pages", None),
    ("prefix_imported_pages", "rtpu_llm_prefix_cache_imported_pages_total",
     "pages seeded from another replica's export", None),
    ("prefix_exported_pages", "rtpu_llm_prefix_cache_exported_pages_total",
     "cached pages gathered to host for another replica", None),
    # spill tier (cfg.kv_spill, llm/tiering.py) — the
    # rtpu_llm_prefix_spill_* family; engine.stats is the single source
    ("spill_pages", "rtpu_llm_prefix_spill_pages_total",
     "evicted prefix pages captured into the host spill tier", None),
    ("spill_bytes", "rtpu_llm_prefix_spill_bytes_total",
     "bytes demoted into the host spill tier", None),
    ("spill_demotions", "rtpu_llm_prefix_spill_demotions_total",
     "eviction-site demote decisions that kept a tier copy "
     "(captures plus clean re-evictions of tier-resident content)",
     None),
    ("spill_promotions", "rtpu_llm_prefix_spill_promotions_total",
     "spilled pages promoted back into HBM (admission-time, re-warm, "
     "or cross-replica via the prefix directory)", None),
    ("spill_expired", "rtpu_llm_prefix_spill_expired_total",
     "tier pages expired under the byte budget or at teardown", None),
    ("spill_drops", "rtpu_llm_prefix_spill_drops_total",
     "validate-on-promote failures: stale/corrupt spill content "
     "dropped, request prefilled cold", None),
    # mesh-parallel engine (cfg.mesh): the zero-involuntary-reshard
    # contract is that reshard_bytes stays 0 while input/output bytes
    # track exactly the declared host arrays (token ids in, tokens out)
    ("mesh_dispatches", "rtpu_llm_mesh_dispatches_total",
     "device dispatches executed under a sharded mesh", None),
    ("mesh_input_bytes", "rtpu_llm_mesh_input_bytes_total",
     "declared host->mesh input bytes (token ids, block tables)", None),
    ("mesh_output_bytes", "rtpu_llm_mesh_output_bytes_total",
     "declared mesh->host output bytes (sampled tokens, logprobs)",
     None),
    ("mesh_reshard_bytes", "rtpu_llm_mesh_reshard_bytes_total",
     "bytes of committed buffers found off their pinned sharding "
     "after a dispatch (must stay 0)", None),
)


def _ship_stat_deltas(engine, stats: dict, tags: dict) -> None:
    last = getattr(engine, "_telem_shipped", None)
    if last is None:
        last = engine._telem_shipped = {}
    for key, name, desc, family in _STAT_COUNTERS:
        cur = stats.get(key)
        if cur is None:
            continue
        delta = cur - last.get(key, 0)
        if delta <= 0:
            continue
        last[key] = cur
        if family is None:
            _counter(name, desc).inc(float(delta), tags=tags)
        else:
            _counter(name, desc, tag_keys=("engine", "family")).inc(
                float(delta), tags={**tags, "family": family})


def _chain_gauge(name, desc):
    # per-chain gauges: the `chain` label values come verbatim from the
    # ChainStatsTable's slot identities (minted once, at most
    # chain_stats_slots of them, plus __overflow__), so the series set
    # stays bounded no matter how diverse client prompts are
    return cached_metric(Gauge, name, desc,
                         tag_keys=("engine", "proc", "chain"))


#: seconds between chain-gauge publishes. The per-chain table updates at
#: O(1) on the hot path; only this snapshot walk is rate-limited.
_CHAIN_SHIP_INTERVAL_S = 2.0


def _ship_chain_stats(engine, gtags: dict) -> None:
    """Publish the engine's top-K hot chains (+ overflow sink) as
    per-chain gauges. Gauge semantics fit: per-chain values are
    last-write-wins snapshots of cumulative table counters, and a
    replica's series zero out with the other proc gauges on exit."""
    now = time.monotonic()
    last = getattr(engine, "_chain_ship_t", 0.0)
    if now - last < _CHAIN_SHIP_INTERVAL_S:
        return
    engine._chain_ship_t = now
    rows = engine.chains.top(engine.cfg.chain_stats_top_k, now)
    for row in rows:
        ctags = {**gtags, "chain": row["chain"]}
        _chain_gauge("rtpu_llm_prefix_chain_hits",
                     "cumulative prefix-cache page hits, per hot "
                     "chain").set(row["hits"], tags=ctags)
        _chain_gauge("rtpu_llm_prefix_chain_tokens_saved",
                     "prompt tokens whose prefill was skipped, per hot "
                     "chain").set(row["tokens_saved"], tags=ctags)
        _chain_gauge("rtpu_llm_prefix_chain_resident_pages",
                     "KV pages of the chain currently in HBM").set(
            row["resident_pages"], tags=ctags)
        age = row["last_hit_age_s"]
        if age is not None:
            _chain_gauge("rtpu_llm_prefix_chain_last_hit_age_s",
                         "seconds since the chain last served a "
                         "hit").set(age, tags=ctags)
    _gauge("rtpu_llm_prefix_chain_tracked",
           "chains holding dedicated heat-table slots").set(
        engine.chains.stats()["tracked"], tags=gtags)


# --------------------------------------------------------------------- #
# multi-LoRA (llm/multilora) — the rtpu_llm_lora_* family
# --------------------------------------------------------------------- #
#   lora_requests_total        counter  adapter-routed requests resolved
#   lora_hits_total            counter  resolves served by a resident slot
#   lora_loads_total           counter  cold slot loads (registry fetch +
#       the in-place copy into the slot table)
#   lora_evictions_total       counter  LRU slots reclaimed for a load
#   lora_swaps_total           counter  hot-swaps: a newer version loaded
#       while an older one stayed resident (pinned by in-flight requests)
#   lora_publishes_total       counter  registry publishes, by namespace
#   lora_resident_adapters     gauge    slots currently holding an adapter

def lora_publishes() -> Counter:
    return _counter("rtpu_llm_lora_publishes_total",
                    "adapter versions published to the registry",
                    tag_keys=("namespace",))


_LORA_COUNTERS = (
    ("requests", "rtpu_llm_lora_requests_total",
     "requests resolved to an adapter slot"),
    ("hits", "rtpu_llm_lora_hits_total",
     "adapter resolves served by an already-resident slot"),
    ("loads", "rtpu_llm_lora_loads_total",
     "cold adapter loads into the slot table"),
    ("evictions", "rtpu_llm_lora_evictions_total",
     "resident slots LRU-reclaimed to load another adapter"),
    ("swaps", "rtpu_llm_lora_swaps_total",
     "hot-swaps (newer version loaded beside a pinned older one)"),
)


@_never_raise
def on_lora_stats(manager) -> None:
    """Ship the manager's counter deltas + residency gauge (called on
    every resolve — a handful of dict updates, same budget as
    on_step)."""
    last = getattr(manager, "_telem_shipped", None)
    if last is None:
        last = manager._telem_shipped = {}
    for key, name, desc in _LORA_COUNTERS:
        cur = manager.stats.get(key, 0)
        delta = cur - last.get(key, 0)
        if delta > 0:
            last[key] = cur
            _counter(name, desc).inc(float(delta), tags={"engine": "paged"})
    _gauge("rtpu_llm_lora_resident_adapters",
           "slot-table rows currently holding an adapter").set(
        float(len(manager._resident)),
        tags={"engine": "paged", "proc": _proc()})
