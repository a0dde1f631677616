"""Serve telemetry: request-path metrics + the metrics_summary() helper.

Counterpart of ``ray_tpu/serve/metrics.py``: the same series under the
same names, in the port's metrics registry.

Reference parity: serve/_private's per-deployment counters and latency
histograms feeding the metrics agent (_private/metrics_agent.py) and the
autoscaler. Everything here records through util/metrics.py, so series
from the proxy, handles, replicas and controller — each its own process —
merge on the head and render on `/metrics` with zero new transport.

Metric names and label sets:
  rtpu_serve_proxy_requests_total{route,method,status}   counter
  rtpu_serve_request_latency_seconds{app,route}          histogram (e2e,
      observed at the proxy: parse -> route -> replica -> respond)
  rtpu_serve_request_errors_total{app,route,code}        counter
  rtpu_serve_handle_requests_total{app,deployment}       counter
  rtpu_serve_router_wait_seconds{app,deployment}         histogram (handle
      call -> request handed to a replica: replica-set refresh + cold start)
  rtpu_serve_replica_latency_seconds{app,deployment}     histogram
  rtpu_serve_replica_requests_total{app,deployment,outcome} counter
  rtpu_serve_queue_depth{app,deployment}                 gauge (ongoing
      requests summed over replicas; the autoscaler's input signal)
  rtpu_serve_replicas{app,deployment}                    gauge
  rtpu_serve_autoscale_decisions_total{app,deployment,direction} counter
  rtpu_serve_batch_size{fn}                              histogram
  rtpu_serve_batch_wait_seconds{fn}                      histogram
  rtpu_serve_stream_dispatches_total{app,deployment,transport} counter
      (control-plane dispatches serving streams — the static decode
      plan's "dispatches per token -> ~0" headline reads from this)
  rtpu_serve_stream_items_total{app,deployment,transport} counter
  rtpu_serve_admission_admitted_total{app,deployment}     counter
  rtpu_serve_admission_shed_total{app,deployment,reason}  counter (shed
      429s by reason: queue_full | slo | deadline)
  rtpu_serve_admission_queue_wait_seconds{app,deployment} histogram
  rtpu_serve_admission_inflight{app,deployment,proxy}     gauge
  rtpu_serve_tenant_requests_total{app,deployment,tenant,outcome} counter
      (per-tenant admission outcomes: admitted | shed; tenant ids are
      clamped to a bounded tracked set per gate — see
      cfg.serve_tenant_max_tracked — so cardinality stays bounded)
  rtpu_serve_tenant_inflight{app,deployment,tenant,proxy} gauge
  rtpu_serve_tenant_queued{app,deployment,tenant,proxy,proc} gauge
      (requests parked in a tenant's admission queue — the per-tenant
      queue-depth series the adapter-aware autoscaler signal reads from
      the TSDB; the proc label lets the head's worker-death sweep zero
      a killed proxy's series so a stale backlog can't scale out
      forever)
  rtpu_serve_autoscale_signal_total{app,deployment,reason} counter
      (TSDB-signal-driven scale-out decisions by triggering reason:
      shed | burn | ttft_slope | tenant_queue)
  rtpu_serve_proxies                                      gauge
  rtpu_serve_prefix_directory_hits_total{model}           counter
  rtpu_serve_prefix_directory_misses_total{model}         counter
  rtpu_serve_prefix_directory_imported_pages_total{model} counter
  rtpu_serve_prefix_directory_publishes_total{model}      counter
  rtpu_serve_prefix_directory_stale_total{model}          counter

``metrics_summary()`` condenses the merged store into finite p50/p95/p99
latencies (TTFT, e2e, replica) plus the headline gauges/counters — the
number a perf PR cites, and what ``bench_serve.py --metrics`` prints.
"""
from __future__ import annotations

from typing import Optional

from ..util.metrics import (LATENCY_BUCKETS as _LAT, Counter, Gauge,
                            Histogram, cached_metric as _metric,
                            collect_store as _um_collect_store,
                            histogram_stats as _um_histogram_stats)

_SIZES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def proxy_requests() -> Counter:
    return _metric(Counter, "rtpu_serve_proxy_requests_total",
                   "HTTP requests through the Serve proxy",
                   tag_keys=("route", "method", "status"))


def request_latency() -> Histogram:
    return _metric(Histogram, "rtpu_serve_request_latency_seconds",
                   "end-to-end request latency observed at the proxy",
                   boundaries=_LAT, tag_keys=("app", "route"))


def request_errors() -> Counter:
    return _metric(Counter, "rtpu_serve_request_errors_total",
                   "requests that returned an error",
                   tag_keys=("app", "route", "code"))


def handle_requests() -> Counter:
    return _metric(Counter, "rtpu_serve_handle_requests_total",
                   "requests routed through DeploymentHandles",
                   tag_keys=("app", "deployment"))


def router_wait() -> Histogram:
    return _metric(Histogram, "rtpu_serve_router_wait_seconds",
                   "handle call to replica hand-off (replica-set refresh "
                   "and cold-start wait)", boundaries=_LAT,
                   tag_keys=("app", "deployment"))


def replica_latency() -> Histogram:
    return _metric(Histogram, "rtpu_serve_replica_latency_seconds",
                   "request execution time inside a replica",
                   boundaries=_LAT, tag_keys=("app", "deployment"))


def replica_requests() -> Counter:
    return _metric(Counter, "rtpu_serve_replica_requests_total",
                   "requests executed by replicas",
                   tag_keys=("app", "deployment", "outcome"))


def queue_depth() -> Gauge:
    return _metric(Gauge, "rtpu_serve_queue_depth",
                   "ongoing requests summed over a deployment's replicas",
                   tag_keys=("app", "deployment"))


def replica_count() -> Gauge:
    return _metric(Gauge, "rtpu_serve_replicas",
                   "running replicas per deployment",
                   tag_keys=("app", "deployment"))


def autoscale_decisions() -> Counter:
    return _metric(Counter, "rtpu_serve_autoscale_decisions_total",
                   "autoscaler retarget decisions",
                   tag_keys=("app", "deployment", "direction"))


def stream_dispatches() -> Counter:
    return _metric(Counter, "rtpu_serve_stream_dispatches_total",
                   "control-plane dispatches (actor calls) made to serve "
                   "streaming responses: setup + per-chunk pulls on the "
                   "poll transport, setup + liveness probes only on the "
                   "static decode plan (chan transport)",
                   tag_keys=("app", "deployment", "transport"))


def stream_items() -> Counter:
    return _metric(Counter, "rtpu_serve_stream_items_total",
                   "items delivered by streaming responses, by transport",
                   tag_keys=("app", "deployment", "transport"))


# -- front door: admission control + prefix directory ----------------- #

def admission_admitted() -> Counter:
    return _metric(Counter, "rtpu_serve_admission_admitted_total",
                   "requests admitted by the proxy's SLO-aware gate "
                   "(immediately or after queueing)",
                   tag_keys=("app", "deployment"))


def admission_shed() -> Counter:
    return _metric(Counter, "rtpu_serve_admission_shed_total",
                   "requests shed 429+Retry-After instead of queueing "
                   "past the budget (reason: queue_full | slo | "
                   "deadline)",
                   tag_keys=("app", "deployment", "reason"))


def admission_queue_wait() -> Histogram:
    return _metric(Histogram, "rtpu_serve_admission_queue_wait_seconds",
                   "time admitted requests spent parked in the "
                   "admission queue before an execution slot freed",
                   boundaries=_LAT, tag_keys=("app", "deployment"))


def admission_inflight() -> Gauge:
    return _metric(Gauge, "rtpu_serve_admission_inflight",
                   "requests this proxy currently holds an admission "
                   "slot for, per deployment",
                   tag_keys=("app", "deployment", "proxy"))


def tenant_requests() -> Counter:
    return _metric(Counter, "rtpu_serve_tenant_requests_total",
                   "per-tenant admission outcomes at the front door "
                   "(outcome: admitted | shed); only requests that "
                   "resolve a tenant id mint series, and gate-side "
                   "bucketing bounds the tenant label set",
                   tag_keys=("app", "deployment", "tenant", "outcome"))


def tenant_inflight() -> Gauge:
    return _metric(Gauge, "rtpu_serve_tenant_inflight",
                   "admission slots a tenant currently holds at this "
                   "proxy",
                   tag_keys=("app", "deployment", "tenant", "proxy"))


def tenant_queued() -> Gauge:
    # the proc label (host:pid) rides along so the head's worker-death
    # sweep zeroes a killed proxy's series — this gauge DRIVES
    # autoscaling, and a pinned stale backlog would scale out forever
    return _metric(Gauge, "rtpu_serve_tenant_queued",
                   "requests parked in a tenant's admission queue at "
                   "this proxy (per-tenant queue depth; the "
                   "adapter-aware autoscaling signal's input series)",
                   tag_keys=("app", "deployment", "tenant", "proxy",
                             "proc"))


def autoscale_signal() -> Counter:
    return _metric(Counter, "rtpu_serve_autoscale_signal_total",
                   "scale-out decisions driven by the TSDB signals "
                   "(obs/scraper.py autoscale_signals), by the reason "
                   "that fired",
                   tag_keys=("app", "deployment", "reason"))


def proxy_count() -> Gauge:
    return _metric(Gauge, "rtpu_serve_proxies",
                   "live controller-managed proxy actors")


def prefix_directory_hits() -> Counter:
    return _metric(Counter, "rtpu_serve_prefix_directory_hits_total",
                   "admission-time prefix lookups that found a warmer "
                   "replica in the cluster directory and imported its "
                   "KV pages", tag_keys=("model",))


def prefix_directory_misses() -> Counter:
    return _metric(Counter, "rtpu_serve_prefix_directory_misses_total",
                   "admission-time prefix lookups the directory could "
                   "not improve on (no entry, or nothing beyond local "
                   "coverage)", tag_keys=("model",))


def prefix_directory_imported_pages() -> Counter:
    return _metric(Counter,
                   "rtpu_serve_prefix_directory_imported_pages_total",
                   "KV pages imported from other replicas via the "
                   "prefix directory", tag_keys=("model",))


def prefix_directory_publishes() -> Counter:
    return _metric(Counter,
                   "rtpu_serve_prefix_directory_publishes_total",
                   "page hashes this process published to the cluster "
                   "prefix directory", tag_keys=("model",))


def prefix_directory_stale() -> Counter:
    return _metric(Counter, "rtpu_serve_prefix_directory_stale_total",
                   "directory hints that failed on use (owner dead or "
                   "pages evicted) and were dropped; the request "
                   "prefilled cold — hints, never correctness",
                   tag_keys=("model",))


def batch_size() -> Histogram:
    return _metric(Histogram, "rtpu_serve_batch_size",
                   "items per @serve.batch invocation",
                   boundaries=_SIZES, tag_keys=("fn",))


def batch_wait() -> Histogram:
    return _metric(Histogram, "rtpu_serve_batch_wait_seconds",
                   "oldest item's queue wait per @serve.batch invocation",
                   boundaries=_LAT, tag_keys=("fn",))


# --------------------------------------------------------------------- #
# summary
# --------------------------------------------------------------------- #

# the store merge + histogram fold are shared with rl.podracer's
# summary; the canonical implementations live in util/metrics.py
_collect_store = _um_collect_store
_hist_stats = _um_histogram_stats


def _counter_total(rec: Optional[dict]) -> float:
    return sum(rec["series"].values()) if rec else 0.0


def metrics_summary() -> dict:
    """Percentiles and headline series from the merged metric store.

    Returns a dict with (present only when data exists):
      ttft / inter_token / queue_wait / e2e_latency / replica_latency —
          {count, mean, p50, p95, p99} in seconds
      kv_utilization / batch_occupancy — {<engine>: value of the
          most-loaded process}
      prefix_cache — {hits, misses, evictions, tokens_saved,
          imported_pages, exported_pages, hit_rate,
          cached_pages: {<engine>: pages on the deepest-cache process}}
      cache — the heat plane's per-chain fold: {chains: [{chain, hits,
          tokens_saved, resident_pages, last_hit_age_s}, ...hot-first],
          tracked_chains} summed across replicas from the bounded
          rtpu_llm_prefix_chain_* gauges; plus, when the spill tier
          ran anywhere, spill — {demotions, promotions, expired,
          drops, spilled_pages, spilled_bytes, resident_pages,
          resident_bytes} from the rtpu_llm_prefix_spill_* families
          (residency summed across replicas: every tier is distinct
          host memory)
      tenants — {<tenant>: {admitted, shed}} per-tenant admission
          outcomes (front-door fairness/quota counter-verification)
      lora — {requests, hits, loads, evictions, swaps, publishes,
          resident_adapters} multi-LoRA lifecycle counters
      requests — {proxy, handle, replica, errors} cumulative counts
    Worker-side series ship on a ~2s cadence; a summary taken immediately
    after traffic may trail by one flush tick.
    """
    store = _collect_store()
    out: dict = {}
    for key, name in (
            ("ttft", "rtpu_llm_ttft_seconds"),
            ("inter_token", "rtpu_llm_inter_token_seconds"),
            ("queue_wait", "rtpu_llm_queue_wait_seconds"),
            ("e2e_latency", "rtpu_serve_request_latency_seconds"),
            ("replica_latency", "rtpu_serve_replica_latency_seconds"),
            ("router_wait", "rtpu_serve_router_wait_seconds")):
        stats = _hist_stats(store.get(name))
        if stats is not None:
            out[key] = stats
    for key, name in (("kv_utilization", "rtpu_llm_kv_utilization"),
                      ("batch_occupancy", "rtpu_llm_batch_occupancy")):
        rec = store.get(name)
        if rec:
            # gauge series are per-process (proc label); the headline
            # number per engine kind is the MOST LOADED process — mean
            # would let one idle replica mask a saturated one
            agg: dict = {}
            for kk, vv in rec["series"].items():
                eng = next((v for k, v in kk if k == "engine"), "")
                agg[eng] = max(agg.get(eng, 0.0), vv)
            out[key] = agg
    hits = _counter_total(store.get("rtpu_llm_prefix_cache_hits_total"))
    misses = _counter_total(store.get("rtpu_llm_prefix_cache_misses_total"))
    if hits or misses:
        cached: dict = {}
        rec = store.get("rtpu_llm_prefix_cached_pages")
        if rec:
            for kk, vv in rec["series"].items():
                eng = next((v for k, v in kk if k == "engine"), "")
                cached[eng] = max(cached.get(eng, 0.0), vv)
        out["prefix_cache"] = {
            "hits": hits, "misses": misses,
            "evictions": _counter_total(
                store.get("rtpu_llm_prefix_cache_evictions_total")),
            "tokens_saved": _counter_total(
                store.get("rtpu_llm_prefix_cache_tokens_saved_total")),
            "imported_pages": _counter_total(
                store.get("rtpu_llm_prefix_cache_imported_pages_total")),
            "exported_pages": _counter_total(
                store.get("rtpu_llm_prefix_cache_exported_pages_total")),
            "hit_rate": hits / (hits + misses),
            "cached_pages": cached,
        }
    # cache heat plane: the per-chain gauge fold (bounded — top-K per
    # engine plus __overflow__ by construction, llm/telemetry.py)
    chains: dict = {}
    for name, field, fold in (
            ("rtpu_llm_prefix_chain_hits", "hits", "sum"),
            ("rtpu_llm_prefix_chain_tokens_saved", "tokens_saved",
             "sum"),
            ("rtpu_llm_prefix_chain_resident_pages", "resident_pages",
             "sum"),
            ("rtpu_llm_prefix_chain_last_hit_age_s", "last_hit_age_s",
             "min")):
        rec = store.get(name)
        for kk, vv in (rec or {}).get("series", {}).items():
            chain = next((v for k, v in kk if k == "chain"), "")
            row = chains.setdefault(chain, {"chain": chain})
            if fold == "sum":
                row[field] = row.get(field, 0.0) + vv
            else:
                row[field] = min(row.get(field, vv), vv)
    # spill tier (llm/tiering.py): lifecycle counters + live residency.
    # Zero everywhere unless some engine ran with kv_spill — the fold
    # only appears when the tier actually moved or holds pages.
    spill = {
        "demotions": _counter_total(
            store.get("rtpu_llm_prefix_spill_demotions_total")),
        "promotions": _counter_total(
            store.get("rtpu_llm_prefix_spill_promotions_total")),
        "expired": _counter_total(
            store.get("rtpu_llm_prefix_spill_expired_total")),
        "drops": _counter_total(
            store.get("rtpu_llm_prefix_spill_drops_total")),
        "spilled_pages": _counter_total(
            store.get("rtpu_llm_prefix_spill_pages_total")),
        "spilled_bytes": _counter_total(
            store.get("rtpu_llm_prefix_spill_bytes_total")),
        "resident_pages": _counter_total(
            store.get("rtpu_llm_prefix_spill_resident_pages")),
        "resident_bytes": _counter_total(
            store.get("rtpu_llm_prefix_spill_resident_bytes")),
    }
    if not any(spill.values()):
        spill = None
    if chains or spill:
        out["cache"] = {
            "chains": sorted(chains.values(),
                             key=lambda r: -r.get("hits", 0.0)),
            "tracked_chains": _counter_total(
                store.get("rtpu_llm_prefix_chain_tracked")),
        }
        if spill:
            out["cache"]["spill"] = spill
    disp = store.get("rtpu_serve_stream_dispatches_total")
    items = store.get("rtpu_serve_stream_items_total")
    if disp or items:
        by_transport: dict = {}
        for rec, field in ((disp, "dispatches"), (items, "items")):
            for kk, vv in (rec or {}).get("series", {}).items():
                tr = next((v for k, v in kk if k == "transport"), "")
                by_transport.setdefault(tr, {})[field] = \
                    by_transport.get(tr, {}).get(field, 0.0) + vv
        for tr, rec in by_transport.items():
            n_items = rec.get("items", 0.0)
            if n_items:
                # the decode-plan headline: ~0 for "chan" in steady state
                rec["dispatches_per_item"] = \
                    rec.get("dispatches", 0.0) / n_items
        out["stream"] = by_transport
    admitted = _counter_total(
        store.get("rtpu_serve_admission_admitted_total"))
    shed = _counter_total(store.get("rtpu_serve_admission_shed_total"))
    if admitted or shed:
        qw = _hist_stats(
            store.get("rtpu_serve_admission_queue_wait_seconds"))
        out["admission"] = {
            "admitted": admitted, "shed": shed,
            "shed_rate": shed / (admitted + shed),
        }
        if qw is not None:
            out["admission"]["queue_wait"] = qw
    trec = store.get("rtpu_serve_tenant_requests_total")
    if trec:
        tenants: dict = {}
        for kk, vv in trec["series"].items():
            ten = next((v for k, v in kk if k == "tenant"), "")
            outcome = next((v for k, v in kk if k == "outcome"), "")
            if ten:
                tenants.setdefault(ten, {"admitted": 0.0, "shed": 0.0})
                tenants[ten][outcome] = \
                    tenants[ten].get(outcome, 0.0) + vv
        if tenants:
            out["tenants"] = tenants
    lora_req = _counter_total(store.get("rtpu_llm_lora_requests_total"))
    lora_loads = _counter_total(store.get("rtpu_llm_lora_loads_total"))
    if lora_req or lora_loads:
        resident: dict = {}
        rec = store.get("rtpu_llm_lora_resident_adapters")
        if rec:
            for kk, vv in rec["series"].items():
                eng = next((v for k, v in kk if k == "engine"), "")
                resident[eng] = max(resident.get(eng, 0.0), vv)
        out["lora"] = {
            "requests": lora_req,
            "hits": _counter_total(
                store.get("rtpu_llm_lora_hits_total")),
            "loads": lora_loads,
            "evictions": _counter_total(
                store.get("rtpu_llm_lora_evictions_total")),
            "swaps": _counter_total(
                store.get("rtpu_llm_lora_swaps_total")),
            "publishes": _counter_total(
                store.get("rtpu_llm_lora_publishes_total")),
            "resident_adapters": resident,
        }
    dhits = _counter_total(
        store.get("rtpu_serve_prefix_directory_hits_total"))
    dmiss = _counter_total(
        store.get("rtpu_serve_prefix_directory_misses_total"))
    if dhits or dmiss:
        out["prefix_directory"] = {
            "hits": dhits, "misses": dmiss,
            "imported_pages": _counter_total(store.get(
                "rtpu_serve_prefix_directory_imported_pages_total")),
            "publishes": _counter_total(store.get(
                "rtpu_serve_prefix_directory_publishes_total")),
            "stale_dropped": _counter_total(store.get(
                "rtpu_serve_prefix_directory_stale_total")),
        }
    out["requests"] = {
        "proxy": _counter_total(
            store.get("rtpu_serve_proxy_requests_total")),
        "handle": _counter_total(
            store.get("rtpu_serve_handle_requests_total")),
        "replica": _counter_total(
            store.get("rtpu_serve_replica_requests_total")),
        "errors": _counter_total(
            store.get("rtpu_serve_request_errors_total")),
        "llm": _counter_total(store.get("rtpu_llm_requests_total")),
        "llm_tokens": _counter_total(
            store.get("rtpu_llm_tokens_generated_total")),
        "llm_preemptions": _counter_total(
            store.get("rtpu_llm_preemptions_total")),
    }
    return out
