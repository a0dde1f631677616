"""ray_tpu_torch.state — cluster state API + Prometheus metrics; the
port's copy of ``ray_tpu.state``.

Reference parity: python/ray/util/state/api.py (`ray list tasks|actors|
objects|nodes|workers`, `ray summary`) backed by the GCS task-event store
(src/ray/gcs/gcs_task_manager.h:94), and the per-node Prometheus pipeline
(_private/metrics_agent.py + stats/metric_defs.cc). Here the head runtime
IS the control plane, so the state API reads its tables directly (driver)
or over the worker->head rpc channel, and one HTTP endpoint exposes the
native counters in Prometheus text format (under the reference's metric
names). A worker row names the GPU indices its process leases where the
reference's says whether it is a TPU worker. ``autoscaler_status`` raises
``NotImplementedError``: the autoscaler (``ray_tpu_torch/autoscaler/``)
is not ported yet.

    import ray_tpu_torch
    from ray_tpu_torch import state
    state.list_tasks()                  # [{'task_id', 'name', 'state', ...}]
    state.list_actors()
    state.list_objects()
    state.list_nodes()
    state.list_workers()
    state.summary()
    port = state.start_metrics_server()  # GET /metrics
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .core import runtime as rt_mod


def _head():
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    if not isinstance(rt, rt_mod.Runtime):
        raise RuntimeError(
            "the state API reads head tables; call it from the driver")
    return rt


def _remote():
    """The worker/driver-client runtime if this process is not the head
    (state calls then go through the `state_list` head RPC). Local-mode
    falls through to _head() for its clear error."""
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    if isinstance(rt, (rt_mod.Runtime, rt_mod.LocalModeRuntime)):
        return None
    return rt


_STATE_NAMES = {0: "PENDING", 1: "READY", 2: "FAILED", 3: "SPILLED"}


def list_tasks(limit: int = 1000, filters: Optional[dict] = None) -> list[dict]:
    """Most-recent-first task records (reference: `ray list tasks`)."""
    remote = _remote()
    if remote is not None:
        # filters apply server-side, BEFORE the limit truncation, so
        # remote and head-local calls return identical rows
        return remote._rpc("state_list", "tasks", limit, filters)
    rt = _head()
    with rt.lock:
        recs = [dict(r) for r in reversed(rt.task_records.values())]
    if filters:
        recs = [r for r in recs
                if all(r.get(k) == v for k, v in filters.items())]
    return recs[:limit]


def list_actors(limit: int = 1000) -> list[dict]:
    remote = _remote()
    if remote is not None:
        return remote._rpc("state_list", "actors", limit)
    from .core.actor import split_actor_name
    rt = _head()
    with rt.lock:
        out = []
        for aid, a in rt.actors.items():
            ns, short = split_actor_name(a.spec.named or "")
            out.append({
                "actor_id": aid.hex(), "class_name": a.spec.name,
                "state": a.state.upper(), "name": short, "namespace": ns,
                "worker": a.wid or "", "restarts_left": a.restarts_left,
                "pending_calls": len(a.queue), "running_calls": len(a.running),
                "death_cause": a.death_cause,
            })
    return out[:limit]


def list_objects(limit: int = 1000) -> list[dict]:
    remote = _remote()
    if remote is not None:
        return remote._rpc("state_list", "objects", limit)
    rt = _head()
    with rt.lock:
        out = []
        for oid, e in rt.directory.items():
            out.append({
                "object_id": oid.hex(),
                "state": _STATE_NAMES.get(e.state, str(e.state)),
                "in_store": rt.store.contains(oid),
                "has_lineage": e.lineage is not None,
                "holders": sorted(rt.interest.get(oid, ())),
            })
            if len(out) >= limit:
                break
    return out


def list_nodes() -> list[dict]:
    remote = _remote()
    if remote is not None:
        return remote.node_table()
    return _head().node_table()


def list_workers() -> list[dict]:
    remote = _remote()
    if remote is not None:
        return remote._rpc("state_list", "workers", 10000)
    rt = _head()
    with rt.lock:
        return [{
            "worker_id": w.wid, "state": w.state,
            "node": w.node_id.hex(),
            "pid": getattr(w.proc, "pid", None),
            "gpu": list(w.gpus),
            "current_task": (w.current.name if w.current else ""),
            "actor_id": w.actor_id.hex() if w.actor_id else "",
        } for w in rt.workers.values()]


def list_jobs() -> list[dict]:
    """Job table (reference: `ray job list` / GcsJobManager)."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("job_list")
    return _head().jobs.list()


def autoscaler_status() -> dict:
    """Instance tables + recent scale events of every autoscaler running
    in the head process (reference: `ray status` over the GCS autoscaler
    state). The autoscaler is not ported, so this raises rather than
    report an empty table; the head's `autoscaler_status` rpc raises the
    same way."""
    raise NotImplementedError(
        "autoscaler_status reads the autoscalers of "
        "ray_tpu_torch/autoscaler/, which is not ported yet (ROADMAP A22)")


def summary() -> dict:
    """Cluster summary (reference: `ray summary tasks` + cluster status).
    Includes flight-recorder health per process (events recorded vs
    dropped — a silently saturated ring shows up here) and the live
    channel-endpoint count across the cluster."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("state_summary")
    rt = _head()
    with rt.lock:
        by_state: dict[str, int] = {}
        for r in rt.task_records.values():
            by_state[r["state"]] = by_state.get(r["state"], 0) + 1
        out = {
            "tasks": dict(rt.counters),
            "tasks_by_state": by_state,
            "actors": len(rt.actors),
            "workers": {s: sum(1 for w in rt.workers.values()
                               if w.state == s)
                        for s in ("idle", "busy", "actor", "starting",
                                  "dead")},
            "nodes_alive": sum(1 for n in rt.nodes.values() if n.alive),
            "pending_tasks": len(rt.pending),
            "objects_tracked": len(rt.directory),
            "object_store": {
                "capacity": rt.store.capacity(),
                "bytes_in_use": rt.store.bytes_in_use(),
                "num_objects": rt.store.num_objects(),
                "evictions": rt.store.evictions(),
            },
        }
    # flight collection pulls worker rings over the control plane and
    # must never run under the head lock (worker replies need it free)
    procs = rt.flight_stats()
    out["flight"] = {
        "per_process": procs,
        "events_recorded": sum(p["recorded"] for p in procs),
        "events_dropped": sum(p["dropped"] for p in procs),
    }
    out["active_channels"] = sum(
        p["chan_open"] - p["chan_closed"] for p in procs)
    # the reference adds the streaming data plane's rollup here ("data",
    # when that plane ran this session); the port has no data/ yet
    # stall-doctor watchdog health (scan counters only — a summary poll
    # must never trigger a cluster-wide stack collection)
    out["watchdog"] = rt.watchdog_health()
    # metrics plane: per-SLO alert states + TSDB health (the scraper's
    # cached report — a summary poll never re-evaluates burn windows)
    if rt.obs is not None:
        rep = rt.obs.engine.report()
        out["slo"] = {"states": dict(rep.get("states", {})),
                      "paging": sorted(
                          n for n, s in rep.get("states", {}).items()
                          if s == "page"),
                      "tsdb": rt.obs.stats()}
    return out


def metrics_history(name: str, tags: Optional[dict] = None,
                    window_s: Optional[float] = None,
                    quantiles: Optional[tuple] = None,
                    group_by: Optional[tuple] = None) -> dict:
    """Range-query the head's metrics TSDB (obs/tsdb.py): every retained
    (ts, value) point per matching series, trimmed to ``window_s``.
    ``tags`` matches subset-style ({"app": "default"} aggregates across
    unnamed labels); ``quantiles=(0.5, 0.95)`` additionally folds
    histogram bucket series into windowed quantile values. Counters get
    a reset-aware ``rate_per_s``. ``group_by=("app", "deployment")``
    adds per-group rate/quantile rows under "groups" so a table column
    costs one round-trip, not one per deployment. Works from a remote
    driver over the existing rpc path."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("metrics_history", name, tags, window_s,
                           quantiles, group_by)
    return _head().metrics_history(name, tags, window_s, quantiles,
                                   group_by)


def metrics_names() -> list[str]:
    """Every metric name with at least one retained TSDB series."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("metrics_names")
    return _head().metrics_names()


def slo_report() -> dict:
    """The SLO engine's latest multi-window burn-rate evaluation: per
    objective the alert state (ok | warn | page), fast/slow window burn
    rates, budget and window spans — plus TSDB health. What ``cli slo``
    and GET /api/slo render."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("slo_report")
    return _head().slo_report()


def cache_report(top_k: int = 10) -> dict:
    """The cluster-wide prefix-cache heat map (cache heat plane):
    fleet hit/miss/eviction totals, the ``top_k`` hottest prompt chains
    folded across replicas, per-replica pool summaries from the shared
    prefix directories (with reclaimable — cached-but-unreferenced —
    bytes), per-tenant warmth, and a recent hit-rate trend when the
    TSDB scraper is on. What ``cli cache`` and GET /api/cache render,
    and the signal base for KV tiering / tenant prewarming."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("cache_report", top_k)
    return _head().cache_report(top_k=top_k)


def stack_report(timeout_s: float = 3.0) -> dict:
    """Cluster-wide live thread stacks (reference: `ray stack`), pulled
    over the control plane from every worker and driver and annotated
    with what the head knows: the task each thread is executing, the
    object/channel a parked thread is waiting on (wait beacons) and who
    produces it. Works while executor threads are wedged — replies come
    from each peer's recv thread."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("stack_report", timeout_s)
    return _head().stack_report(timeout_s=timeout_s)


def hang_report(timeout_s: float = 3.0) -> dict:
    """One-shot hang diagnosis: watchdog-flagged stuck tasks (with the
    owning worker's stack attached), suspected wait-graph deadlocks
    naming the tasks/channels/threads in each cycle, and watchdog
    health. The stall doctor's `cli doctor` and GET /api/hangs read
    exactly this."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("hang_report", timeout_s)
    return _head().hang_report(timeout_s=timeout_s)


def memory_summary(limit: int = 1000) -> dict:
    """Per-object reference breakdown + store totals — the `ray memory`
    debugging view (reference: scripts.py `ray memory` over
    _private/internal_api.memory_summary; here read straight from the
    head's ownership tables: interest holders, transfer pins,
    containment edges, lineage). Rows are capped at `limit`, pinned/
    most-referenced first, so a leak investigation sees the heavy
    objects without shipping the whole directory."""
    remote = _remote()
    if remote is not None:
        return remote._rpc("memory_summary", limit)
    rt = _head()
    with rt.lock:
        rows = []
        for oid, e in rt.directory.items():
            holders = sorted(rt.interest.get(oid, ()))
            rows.append({
                "object_id": oid.hex(),
                "state": _STATE_NAMES.get(e.state, str(e.state)),
                "ref_holders": holders,
                "num_refs": len(holders),
                "transfer_pins": rt.xfer_pins.get(oid, 0),
                "contains": len(rt.contained.get(oid, ())),
                "pinned": oid in rt._pinned,
                "reconstructable": e.lineage is not None,
            })
        rows.sort(key=lambda r: (not r["pinned"], -r["num_refs"]))
        task_holders = sum(1 for r in rows for h in r["ref_holders"]
                           if h.startswith("task:"))
        out = {
            "objects": rows[:limit],
            "num_objects_tracked": len(rt.directory),
            "num_task_arg_refs": task_holders,
            "num_transfer_pins": sum(rt.xfer_pins.values()),
            "object_store": {
                "capacity": rt.store.capacity(),
                "bytes_in_use": rt.store.bytes_in_use(),
                "num_objects": rt.store.num_objects(),
                "evictions": rt.store.evictions(),
            },
        }
    # store/spill residency probes (shm lookup + file stat per object)
    # run OUTSIDE the head lock and only for the rows actually returned —
    # a huge directory must not stall scheduling for a capped listing
    from .core.ids import ObjectID as _OID
    for r in out["objects"]:
        oid = _OID(bytes.fromhex(r["object_id"]))
        r["in_store"] = rt.store.contains(oid)
        r["spilled"] = rt.spill.contains(oid)
    return out


# ---------------------------------------------------------------------------
# Prometheus endpoint (reference: _private/metrics_agent.py exposition)
# ---------------------------------------------------------------------------

def _prometheus_text() -> str:
    s = summary()
    lines = []

    def gauge(name, value, help_txt):
        lines.append(f"# HELP {name} {help_txt}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")

    def counter(name, value, help_txt):
        lines.append(f"# HELP {name} {help_txt}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {value}")

    for k, v in s["tasks"].items():
        counter(f"ray_tpu_{k}_total", v, f"cumulative {k.replace('_', ' ')}")
    gauge("ray_tpu_pending_tasks", s["pending_tasks"],
          "tasks queued for scheduling")
    gauge("ray_tpu_actors", s["actors"], "actors registered")
    gauge("ray_tpu_nodes_alive", s["nodes_alive"], "alive nodes")
    gauge("ray_tpu_objects_tracked", s["objects_tracked"],
          "directory entries")
    lines.append("# HELP ray_tpu_workers worker processes by state")
    lines.append("# TYPE ray_tpu_workers gauge")
    for st, n in s["workers"].items():
        lines.append(
            f'ray_tpu_workers{{state="{st}"}} {n}')
    st = s["object_store"]
    gauge("ray_tpu_object_store_capacity_bytes", st["capacity"],
          "shm store capacity")
    gauge("ray_tpu_object_store_used_bytes", st["bytes_in_use"],
          "shm store bytes in use")
    gauge("ray_tpu_object_store_objects", st["num_objects"],
          "objects resident in the shm store")
    counter("ray_tpu_object_store_evictions_total", st["evictions"],
            "LRU evictions")
    # user-defined metrics (util/metrics.py Counter/Gauge/Histogram);
    # remote drivers pull the merged store over the head RPC
    from .util.metrics import prometheus_lines
    remote = _remote()
    if remote is not None:
        try:
            lines.extend(prometheus_lines(
                remote._rpc("user_metrics_dump")))
        except Exception:
            pass  # head mid-restart: built-ins still render
    else:
        rt = _head()
        if getattr(rt, "user_metrics", None):
            with rt.lock:
                lines.extend(prometheus_lines(rt.user_metrics))
    return "\n".join(lines) + "\n"


_server = None


def start_metrics_server(port: int = 0) -> int:
    """Serve GET /metrics in Prometheus text format; returns the bound
    port. Idempotent per process."""
    global _server
    if _server is not None:
        return _server.server_address[1]
    _head()  # fail fast if not on the driver
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            try:
                body = _prometheus_text().encode()
            except Exception as e:  # noqa: BLE001
                self.send_response(500)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    _server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="rtpu-metrics").start()
    return _server.server_address[1]


def stop_metrics_server() -> None:
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None


def timeline(flight: bool = False):
    """Chrome-trace events (reference: ray.timeline).

    ``flight=False`` keeps the classic span-tracing event list.
    ``flight=True`` returns the full flight-recorder view: every
    process's event ring pulled over the control plane, clock-offset
    stitched onto the head's monotonic clock, with span events merged
    in — a ``{"traceEvents": [...]}`` object Perfetto/chrome://tracing
    loads directly, showing producer-seal -> consumer-wake flow arrows
    on every channel message."""
    if not flight:
        return _head().timeline()
    remote = _remote()
    if remote is not None:
        return remote._rpc("flight_timeline")
    return _head().flight_timeline()
