"""Typed runtime config flags, overridable via ``RTPU_*`` env vars.

Reference parity: the ``RAY_CONFIG`` flag system
(src/ray/common/ray_config.h:60, ray_config_def.h — 226 entries).  The
reference generates a C++ class whose every field reads a ``RAY_<name>`` env
var at process start; here a flag is a typed descriptor on a singleton, read
once at first access and cacheable, with ``RTPU_<NAME>`` (upper-cased) as
the override channel.  Workers inherit the head's environment, so flags set
before ``init()`` propagate to the whole local cluster.

Usage::

    from ray_tpu_torch.core.config import cfg
    cap = cfg.object_store_memory
    cfg.override(worker_prestart=0)      # tests / programmatic override
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Flag:
    """One typed config entry (a ``RAY_CONFIG(type, name, default)`` row)."""

    __slots__ = ("name", "default", "type", "doc", "env")

    def __init__(self, name: str, default: Any, doc: str = ""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.doc = doc
        self.env = f"RTPU_{name.upper()}"

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return _parse_bool(raw)
        if self.type is int:
            return int(raw, 0)  # accepts 0x..., underscores not needed
        return self.type(raw)


class Config:
    """Singleton flag table. Attribute access returns the effective value:
    programmatic override > ``RTPU_*`` env var > default."""

    def __init__(self, flags: list[Flag]):
        self._flags = {f.name: f for f in flags}
        self._overrides: dict[str, Any] = {}
        self._cache: dict[str, Any] = {}
        self._lock = threading.Lock()

    def __getattr__(self, name: str) -> Any:
        # __getattr__ only fires for names not found normally, so _flags
        # etc. resolve through __init__'s instance dict without recursion.
        flags = object.__getattribute__(self, "_flags")
        if name not in flags:
            raise AttributeError(f"unknown config flag {name!r}")
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            if name in self._cache:
                return self._cache[name]
            f = flags[name]
            raw = os.environ.get(f.env)
            val = f.default if raw is None else f.parse(raw)
            self._cache[name] = val
            return val

    def override(self, **kv: Any) -> None:
        """Programmatically pin flags (tests, embedders). Type-checked."""
        with self._lock:
            for name, val in kv.items():
                f = self._flags.get(name)
                if f is None:
                    raise AttributeError(f"unknown config flag {name!r}")
                if not isinstance(val, f.type) and not (
                        f.type is float and isinstance(val, int)):
                    raise TypeError(
                        f"{name} expects {f.type.__name__}, got "
                        f"{type(val).__name__}")
                self._overrides[name] = f.type(val)

    def overrides_for_env(self) -> dict[str, str]:
        """Current programmatic overrides as {RTPU_* env name: str value},
        for shipping driver-side cfg.override()s to spawned workers."""
        with self._lock:
            out = {}
            for name, val in self._overrides.items():
                f = self._flags[name]
                if f.type is bool:
                    out[f.env] = "1" if val else "0"
                else:
                    out[f.env] = str(val)
            return out

    def reset(self, *names: str) -> None:
        """Drop overrides/cache (all flags when called with no names)."""
        with self._lock:
            if not names:
                self._overrides.clear()
                self._cache.clear()
            for n in names:
                self._overrides.pop(n, None)
                self._cache.pop(n, None)

    def dump(self) -> dict[str, Any]:
        """Effective value of every flag (for the state API / debugging)."""
        return {n: getattr(self, n) for n in self._flags}

    def describe(self) -> list[dict[str, Any]]:
        out = []
        for n, f in self._flags.items():
            out.append({"name": n, "env": f.env, "type": f.type.__name__,
                        "default": f.default, "value": getattr(self, n),
                        "doc": f.doc})
        return out


_FLAGS = [
    # ---- object store / memory -------------------------------------- #
    Flag("object_store_memory", 2 << 30,
         "shm object store capacity in bytes"),
    Flag("object_spilling_threshold", 0.8,
         "store fill fraction above which sealed objects spill to disk"),
    Flag("min_spilling_size", 1 << 20,
         "don't spill objects smaller than this (bytes)"),
    Flag("put_copy_threads", 0,
         "threads for the large-piece memmove on the put path (0 = auto: "
         "4 when pieces exceed the parallel threshold; 1 = always copy "
         "single-threaded). ctypes.memmove releases the GIL, so slicing "
         "one multi-hundred-MiB copy across threads tracks memory "
         "bandwidth instead of one core's share of it"),
    Flag("tracing_enabled", False,
         "propagate (trace_id, span_id) context through task submission "
         "and record per-task spans in the timeline (util/tracing.py)"),
    Flag("transfer_chunk_bytes", 8 << 20,
         "cross-node object pulls move in pieces of this size: a transport "
         "failure resumes from the last good byte instead of restarting "
         "the whole frame, and frames larger than the local store stream "
         "to the spill directory piecewise"),
    Flag("collective_inline_bytes", 64 << 10,
         "collective payloads up to this size ride inside the rendezvous "
         "actor message (one round trip); larger ones move store-to-store "
         "as ObjectRefs so bulk bytes never funnel through one process"),
    Flag("zero_copy_get", False,
         "deserialize large buffers as read-only views pinned into the shm "
         "store (released when the arrays are GC'd) instead of copying "
         "them out — plasma's semantics; arrays come back non-writable"),
    Flag("store_prefault", False,
         "fault in the whole store mapping at create (one-time cost "
         "~0.4s/GiB) so big puts run at warm-memcpy speed; production "
         "long-lived clusters want this on"),
    Flag("memory_monitor_refresh_ms", 250,
         "memory-monitor poll interval; 0 disables the monitor"),
    Flag("memory_usage_threshold", 0.95,
         "host memory fraction above which the OOM killer engages"),
    # ---- scheduler / worker pool ------------------------------------ #
    Flag("worker_prestart", 4,
         "max workers prestarted at init so first tasks skip cold-start"),
    Flag("worker_idle_timeout_s", 60.0,
         "idle workers beyond the prestart pool are reaped after this"),
    Flag("head_tcp_port", 0,
         "fixed TCP port for the head's control listener (0 = ephemeral); "
         "set it (plus RTPU_CLUSTER_AUTHKEY) so agents/drivers can re-dial "
         "a restarted head at the same address"),
    Flag("driver_reconnect_timeout_s", 30.0,
         "how long an external driver retries dialing a restarted head "
         "before its pending calls fail (0 disables reconnection)"),
    Flag("worker_pipeline_depth", 4,
         "extra same-shape tasks queued on a busy worker so the done->"
         "dispatch round-trip leaves the critical path (0 disables); "
         "idle workers steal from the longest pipeline, so skew does "
         "not strand work behind a slow task"),
    Flag("scheduler_spread_threshold", 0.5,
         "node utilization below which the hybrid policy packs"),
    Flag("task_retry_delay_ms", 0,
         "delay before re-submitting a retriable failed task"),
    Flag("actor_restart_delay_ms", 0,
         "delay before restarting a restartable dead actor"),
    Flag("pg_retry_timeout_s", 120.0,
         "how long placement groups keep retrying reservation"),
    # ---- control plane ---------------------------------------------- #
    Flag("control_batching", True,
         "coalesce control-plane messages (submit/done/ref traffic) into "
         "batch frames via the adaptive flush buffer, and coalesce burst "
         "submissions into shared scheduling passes on the head; off "
         "restores one-message-per-write for debugging (results must be "
         "identical either way)"),
    Flag("send_batch_max", 512,
         "force-flush the control-plane send buffer at this many queued "
         "messages (bounds per-frame pickle size and head-side latency)"),
    Flag("submit_burst_window_us", 100.0,
         "an in-process submit arriving within this window of the "
         "previous one is treated as part of a burst: its scheduling "
         "pass is deferred to the scheduler pump so one pass (and one "
         "batched frame per worker) serves the whole burst; 0 schedules "
         "every submit inline"),
    Flag("rpc_pool_workers", 32,
         "threads serving worker->head RPCs (pg_wait parks here)"),
    Flag("driver_submit_queue", True,
         "in-process driver submits enqueue to the scheduler pump (one "
         "lock acquisition + one scheduling pass per burst, v2-style "
         "presumed interest) instead of taking the runtime lock per "
         ".remote(); off restores per-call inline submission for "
         "debugging — results must be identical either way"),
    Flag("dag_sealed_channels", True,
         "compiled-DAG edges ride sealed ring channels (futex wait on "
         "{data, stop}, ack-object ring retirement, zero-copy reads "
         "allowed) instead of the legacy delete-and-recreate polling "
         "transport; off restores the polling transport — results must "
         "be bit-identical either way"),
    Flag("dag_ref_wait_executor", False,
         "await ObjectRef falls back to the legacy one-thread-per-await "
         "executor hop instead of the shared wait_sealed completion "
         "multiplexer (debugging)"),
    Flag("task_records_max", 10000,
         "bounded task-state records kept for the state API"),
    Flag("timeline_events_max", 20000,
         "bounded chrome-trace timeline events kept in memory"),
    Flag("health_check_period_ms", 1000,
         "node-agent heartbeat period"),
    Flag("health_check_timeout_s", 10.0,
         "node declared dead after this long without a heartbeat"),
    Flag("gcs_snapshot_period_s", 5.0,
         "head-table persistence snapshot period; 0 disables"),
    # ---- serve ------------------------------------------------------- #
    Flag("serve_replica_poll_s", 10.0,
         "handle replica-set TTL refresh — fallback only; the long-poll "
         "listener pushes changes promptly"),
    Flag("serve_autoscale_period_s", 1.0,
         "controller reconcile/autoscale loop period"),
    Flag("serve_static_decode_plan", True,
         "streaming serve responses ride a sealed ring channel (replica "
         "drains the generator into shm, the handle reads it directly: "
         "zero control-plane dispatches per item in steady state) when "
         "handle and replica share an object store; off (or no shared "
         "store) falls back to per-chunk stream_next actor calls — "
         "items must be identical either way"),
    Flag("serve_stream_ring", 64,
         "in-flight item bound of the static decode plan's ring channel "
         "(producer blocks once this far ahead of the consumer)"),
    # ---- serve front door (serve/frontdoor/) ------------------------- #
    Flag("serve_num_proxies", 1,
         "HTTP proxies the controller keeps alive per application "
         "deploy (ports http_port..http_port+n-1); each is a "
         "controller-managed actor, replaced on death like a replica"),
    Flag("serve_admission_control", True,
         "SLO-aware admission at the proxies: per-deployment budgets "
         "derived from live replica capacity (replicas x "
         "max_ongoing_requests, split across proxies); past the budget "
         "requests queue with bounded depth and deadline, then shed as "
         "HTTP 429 + Retry-After instead of timing out as 500s"),
    Flag("serve_admission_queue_depth", 64,
         "per-proxy, per-deployment bound on requests parked waiting "
         "for an admission slot; arrivals past it shed immediately"),
    Flag("serve_admission_timeout_s", 2.0,
         "admission-queue deadline (the TTFT SLO contribution the "
         "queue may add): a request predicted or measured to wait "
         "longer sheds with a Retry-After estimate instead of queueing"),
    Flag("serve_prefix_directory", True,
         "cluster-wide prefix-cache directory: paged-engine replicas "
         "publish chained page hashes to the head (core/directory.py), "
         "and admission-match prefixes warmed on ANY replica by "
         "importing the KV pages from the owner over the object store"),
    Flag("serve_prefix_publish_s", 0.25,
         "how often a replica's engine loop drains newly published / "
         "evicted page hashes to the prefix directory (one async frame "
         "per drain with anything to report)"),
    Flag("serve_prefix_import_timeout_s", 10.0,
         "deadline for fetching a warmed prefix's KV pages from the "
         "owning replica; on timeout/death the entries are dropped "
         "from the directory and the request prefills cold (stale "
         "entries are hints, never correctness)"),
    Flag("dir_max_entries", 65536,
         "per-directory entry cap of the head's shared directory "
         "service (FIFO eviction; bounds head memory no matter how "
         "many pages the fleet publishes)"),
    # ---- multi-tenant serving (llm/multilora + tenant front door) ---- #
    Flag("llm_lora_refresh_s", 0.25,
         "TTL on a serving replica's cached latest-version lookups in "
         "the adapter registry: the upper bound on how long a freshly "
         "published adapter version takes to start serving (the "
         "hot-swap observation window), and the floor on dir_query "
         "cadence per adapter on the request hot path"),
    Flag("serve_tenant_fair", True,
         "weighted-fair admission queueing across tenants at the "
         "proxies: parked requests drain round-robin per tenant "
         "(deficit-weighted), so one tenant's burst cannot starve "
         "another tenant's queue position; off restores one global "
         "FIFO"),
    Flag("serve_tenant_max_share", 0.5,
         "per-tenant quota as a fraction of a deployment's admission "
         "budget (and of its queue depth): a TENANTED request past its "
         "tenant's share sheds 429+Retry-After (reason tenant_quota) "
         "while other tenants keep admitting. Applies only to requests "
         "that resolve a tenant id (header/body/adapter); untenanted "
         "traffic keeps the plain budget. 1.0 disables the quota"),
    Flag("serve_tenant_max_tracked", 64,
         "per-gate bound on distinct tenant ids tracked for quota / "
         "fair-queueing / metrics; tenants past the cap share one "
         "__other__ bucket (tenant ids are client-controlled — "
         "unbounded ids must not grow gate state or metric "
         "cardinality)"),
    # ---- metrics plane (ray_tpu_torch/obs/) -------------------------------- #
    Flag("tsdb_enable", True,
         "head-side metrics TSDB (obs/tsdb.py): a scraper thread folds "
         "the merged user-metric store into fixed-memory per-series "
         "rings every tsdb_scrape_s, powering metrics_history(), the "
         "SLO burn-rate engine, cli top/slo and signal-driven "
         "autoscaling; off = instantaneous snapshots only"),
    Flag("tsdb_scrape_s", 15.0,
         "TSDB scrape tick; SLO burn windows scale with it (240 ticks "
         "= the canonical 1h fast window at the 15 s default), so "
         "tests with a 50 ms tick exercise the full page/warn ladder "
         "in seconds"),
    Flag("tsdb_retention_points", 2048,
         "per-series ring capacity in samples (preallocated: 16 bytes "
         "per point; 2048 x 15 s default = 8.5 h of history, enough "
         "for the 6 h slow-burn window)"),
    Flag("tsdb_max_series", 4096,
         "hard cardinality cap across all (name, label-set) series; "
         "past it, samples for unseen label sets fold into a per-name "
         "__overflow__ sink — client-controlled labels can never grow "
         "head memory (ceiling = (max_series + one sink per metric "
         "NAME, code-controlled) x retention x 16 bytes, ~128 MiB at "
         "the defaults)"),
    Flag("serve_slo_ttft_s", 2.0,
         "shipped TTFT SLO threshold: 95% of requests must see first "
         "token within this many seconds (obs/slo.py ttft_p95)"),
    Flag("serve_slo_e2e_s", 10.0,
         "shipped end-to-end latency SLO threshold: 99% of proxied "
         "requests complete within this many seconds (e2e_p99)"),
    Flag("serve_slo_error_ratio", 0.01,
         "shipped error-ratio SLO budget: at most this fraction of "
         "proxy requests may error (error_ratio)"),
    Flag("serve_slo_shed_ratio", 0.05,
         "shipped admission shed-ratio SLO budget: at most this "
         "fraction of arrivals may shed 429 (shed_ratio)"),
    Flag("serve_autoscale_signals", "on",
         "signal-driven autoscaling (obs/scraper.py autoscale_signals "
         "composed into the serve controller's queue-depth rule): "
         "scale OUT when the shed rate, TTFT/e2e burn rate, TTFT "
         "slope or a per-tenant admission backlog says the SLO will "
         "be violated — BEFORE the first 429; 'off' reproduces the "
         "legacy ongoing-requests-only autoscaler exactly"),
    # ---- observability ----------------------------------------------- #
    Flag("metrics_export_port", 0,
         "Prometheus /metrics port (0 = ephemeral)"),
    Flag("event_export_enabled", False,
         "write task/actor events to session_dir/events.jsonl"),
    Flag("flight_recorder", True,
         "always-on per-process flight recorder (core/flight.py): "
         "sub-microsecond struct-packed event ring instrumenting the "
         "zero-dispatch fast paths; off = evt() is a no-op (the "
         "overhead A/B knob)"),
    Flag("flight_ring_slots", 16384,
         "flight-recorder ring capacity in events (rounded up to a "
         "power of two; 44 bytes/event — the default is ~720 KiB per "
         "process, overwritten oldest-first with a drop counter)"),
    Flag("stall_watchdog", True,
         "stuck-task watchdog on the head (core/stacks.py stall "
         "doctor): per-task-name runtime EWMAs flag tasks RUNNING "
         "beyond stuck_task_multiple x typical (with an absolute "
         "floor), auto-attach the owning worker's live stack to the "
         "task record, and emit rtpu_core_stuck_tasks metrics + a "
         "task_stuck flight event"),
    Flag("stall_watchdog_period_s", 2.0,
         "watchdog scan period (one pass over the bounded RUNNING "
         "task records; a scan does no control-plane traffic unless "
         "it flags something)"),
    Flag("stuck_task_multiple", 10.0,
         "a task is suspect once its runtime exceeds this multiple of "
         "its task-name EWMA (never below stuck_task_floor_s)"),
    Flag("stuck_task_floor_s", 30.0,
         "absolute minimum runtime before the watchdog may flag a "
         "task — also the threshold for task names with no history"),
]

cfg = Config(_FLAGS)
