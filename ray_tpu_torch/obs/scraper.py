"""Head-side metrics scraper: folds the merged user-metric store into
the TSDB every ``cfg.tsdb_scrape_s``, runs the SLO engine, and answers
the autoscaler's signal queries.

No new transport: every process already ships its metric deltas to the
head over the existing control connection (util/metrics.py's 2 s
flusher), and ``Runtime.user_metrics_dump()`` is the merged view. The
scraper samples THAT — one dict walk per tick, no wire frames, no
PROTOCOL_VERSION bump. Remote drivers reach the history through the
existing rpc path (``metrics_history`` / ``slo_report`` /
``obs_signals`` in Runtime._RPC_METHODS).

Signal evaluation (:func:`autoscale_signals`) is head-side on purpose:
the controller asks one question per deployment per scrape period
("should I scale out?") instead of pulling four series over the RPC and
re-deriving burn rates in an actor process.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .slo import WARN_BURN, SLOEngine
from .tsdb import TSDB

#: window for the reactive signals, in scrape ticks (with the 15 s
#: default scrape this is 5 minutes — the fast-short SLO window)
SIGNAL_WINDOW_TICKS = 20.0


class MetricsScraper:
    """One daemon thread on the head. Owns the TSDB + SLO engine."""

    def __init__(self, rt, tsdb: Optional[TSDB] = None,
                 engine: Optional[SLOEngine] = None):
        from ..core.config import cfg
        self.rt = rt
        self.period_s = max(0.01, float(cfg.tsdb_scrape_s))
        self.tsdb = tsdb if tsdb is not None else TSDB(
            cfg.tsdb_retention_points, cfg.tsdb_scrape_s,
            cfg.tsdb_max_series)
        self.engine = engine if engine is not None \
            else SLOEngine(self.tsdb)
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes ticks: callers may drive scrape_once() manually
        # (bench_serve's soak verdict, tests) while the daemon thread
        # runs — SLOEngine.evaluate's state machine must never see two
        # concurrent evaluations
        self._tick_lock = threading.Lock()

    def start(self) -> "MetricsScraper":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-obs-scraper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.period_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # a bad tick must not kill the history thread

    def scrape_once(self, now: Optional[float] = None) -> None:
        """One tick: snapshot the merged store into the TSDB, sample a
        few core runtime gauges, evaluate the SLOs. Public so tests and
        the bench driver can drive it with a synthetic clock; the tick
        lock keeps a manual call from racing the daemon thread (a
        concurrent double-evaluate would double-fire alert
        transitions)."""
        now = time.time() if now is None else now
        with self._tick_lock:
            # user_metrics_dump flushes nothing itself; flush() folds
            # THIS process's pending deltas (head-resident serve
            # handles, engine stats) in first so head-local series
            # aren't a tick stale
            from ..util import metrics as um
            um.flush()
            self.tsdb.record_store(self.rt.user_metrics_dump(), now)
            self._scrape_core(now)
            self.engine.evaluate(now)
            self.ticks += 1

    def _scrape_core(self, now: float) -> None:
        """A few built-in runtime series the dashboards trend that no
        user metric carries (cheap reads; the store probes are lockless
        native calls)."""
        rt = self.rt
        with rt.lock:
            pending = len(rt.pending)
            workers_busy = sum(1 for w in rt.workers.values()
                               if w.state in ("busy", "actor"))
        self.tsdb.record("rtpu_core_pending_tasks", "gauge", (), now,
                         float(pending))
        self.tsdb.record("rtpu_core_workers_busy", "gauge", (), now,
                         float(workers_busy))
        self.tsdb.record("rtpu_core_store_bytes_in_use", "gauge", (),
                         now, float(rt.store.bytes_in_use()))

    def stats(self) -> dict:
        return {**self.tsdb.stats(), "ticks": self.ticks,
                "period_s": self.period_s}


def autoscale_signals(tsdb: TSDB, engine: Optional[SLOEngine],
                      app: str, deployment: str,
                      now: Optional[float] = None) -> dict:
    """Should ``app/deployment`` scale OUT? Composes the TSDB-backed
    signals the queue-depth autoscaler is blind to (ROADMAP items 3+4):

    - ``shed``: the admission gate shed recently (reactive — we are
      already late; rate over the signal window > 0);
    - ``burn``: the TTFT-p95 / e2e-p99 SLO is burning its error budget
      above the WARN rate on the fast-short window — the predictive
      signal that fires BEFORE the first 429 (queue wait is climbing
      into the latency histograms while admission still admits);
    - ``ttft_slope``: TTFT p95 is rising across the window AND already
      past half its SLO threshold (trend confirmation for clusters
      whose histograms move slower than their burn windows);
    - ``tenant_queue``: some tenant has requests parked at the
      admission gate (per-tenant queue-depth series — the
      adapter-aware scale-out input: one tenant's hot adapter backlog
      is invisible to deployment-wide ongoing counts).

    The latency histograms carry engine labels, not app/deployment, so
    ``burn`` and ``ttft_slope`` are CLUSTER-level observations; both
    are therefore gated on deployment-LOCAL pressure (a non-empty
    admission queue or non-zero ongoing requests) — deployment A's
    TTFT collapse must not step every healthy autoscaled deployment B
    out to max.

    Returns ``{"scale_out": bool, "reasons": [...], ...evidence}``.
    Never raises — an empty TSDB yields no signal, not an error."""
    now = time.time() if now is None else now
    window_s = SIGNAL_WINDOW_TICKS * tsdb.scrape_s
    tags = {"app": app, "deployment": deployment}
    reasons = []

    shed_rate = tsdb.rate("rtpu_serve_admission_shed_total", tags,
                          window_s, now=now)
    if shed_rate > 0:
        reasons.append("shed")

    tenant_queued = tsdb.instant("rtpu_serve_tenant_queued", tags)
    tq_max = max((s["value"] for s in tenant_queued), default=0.0)
    ongoing = max((s["value"] for s in tsdb.instant(
        "rtpu_serve_queue_depth", tags)), default=0.0)
    # deployment-local pressure: the gate for the cluster-level
    # latency signals below
    local_pressure = tq_max > 0 or ongoing > 0

    from ..core.config import cfg
    ttft_thresh = cfg.serve_slo_ttft_s
    burn = {}
    if engine is not None:
        for row in engine.report().get("slos", ()):
            if row["slo"] in ("ttft_p95", "e2e_p99"):
                burn[row["slo"]] = {"state": row["state"],
                                    "fast_short": row["burn_fast"][0]}
        if local_pressure and any(
                b["fast_short"] > WARN_BURN or b["state"] != "ok"
                for b in burn.values()):
            reasons.append("burn")

    half = window_s / 2.0
    p95_now = tsdb.histogram_quantiles(
        "rtpu_llm_ttft_seconds", None, half, (0.95,), now=now)[0]
    p95_prev = tsdb.histogram_quantiles(
        "rtpu_llm_ttft_seconds", None, half, (0.95,), now=now - half)[0]
    if local_pressure and p95_now is not None and \
            p95_now >= 0.5 * ttft_thresh and \
            (p95_prev is None or p95_now > p95_prev):
        reasons.append("ttft_slope")

    if tq_max > 0:
        reasons.append("tenant_queue")

    return {
        "scale_out": bool(reasons),
        "reasons": reasons,
        "shed_rate_per_s": shed_rate,
        "ttft_p95_s": p95_now,
        "ttft_p95_prev_s": p95_prev,
        "tenant_queued_max": tq_max,
        "burn": burn,
        "window_s": window_s,
    }
