"""User-defined metrics: Counter / Gauge / Histogram.

Reference parity: python/ray/util/metrics.py (Counter:117, Gauge:192,
Histogram:249 — tagged application metrics flowing to the cluster's
Prometheus endpoint via each process's metrics agent).

TPU-first shape: there is no per-node metrics agent; every process keeps
a local registry and a background flusher ships DELTAS to the head over
the existing control connection (~2s cadence, one small message), where
they merge into the head's registry: counters and histogram buckets SUM
across processes, gauges are last-write-wins. The head's Prometheus text
(`state._prometheus_text`, dashboard `/metrics`) appends them after the
built-in runtime metrics.

    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
    requests = Counter("app_requests", description="...",
                       tag_keys=("route",))
    requests.inc(1.0, tags={"route": "/v1"})
"""
from __future__ import annotations

import re
import threading
import time
from typing import Optional, Sequence

_lock = threading.Lock()
# name -> _MetricDef; (name, tags) -> value/buckets live in the defs
_registry: dict[str, "Metric"] = {}
_flusher_started = False
# name -> Metric singletons handed out by cached_metric()
_metric_cache: dict = {}

# shared latency boundaries (seconds) for serving histograms: sub-ms
# through 60s covers in-process CPU smoke engines and remote-attached-TPU
# serving alike. llm/telemetry.py and serve/metrics.py both bucket with
# these so rtpu_llm_* / rtpu_serve_* quantiles stay comparable.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _tags_key(tag_keys, tags: Optional[dict]) -> tuple:
    tags = tags or {}
    unknown = set(tags) - set(tag_keys)
    if unknown:
        raise ValueError(f"undeclared tag keys {sorted(unknown)}; "
                         f"declared: {list(tag_keys)}")
    return tuple((k, str(tags.get(k, ""))) for k in tag_keys)


class Metric:
    KIND = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
            raise ValueError(f"invalid Prometheus metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: dict[tuple, float] = {}
        self._dirty: set[tuple] = set()
        with _lock:
            prev = _registry.get(name)
            if prev is not None and (
                    prev.KIND != self.KIND
                    or prev.tag_keys != self.tag_keys
                    or getattr(prev, "boundaries", None)
                    != getattr(self, "boundaries", None)):
                raise ValueError(
                    f"metric {name!r} already registered with a different "
                    f"kind/tags/boundaries")
            _registry[name] = prev or self
            if prev is not None:
                # share storage: re-constructing the same metric in the
                # same process must not fork the series
                self._values = prev._values
                self._dirty = prev._dirty
        _ensure_flusher()

    # -- recording (subclasses call) --------------------------------------

    def _record(self, key: tuple, value: float, add: bool):
        with _lock:
            if add:
                self._values[key] = self._values.get(key, 0.0) + value
            else:
                self._values[key] = value
            self._dirty.add(key)

    # -- flush protocol ----------------------------------------------------

    def _drain(self) -> list:
        """(kind, name, desc, key, value, add) rows to ship; counters/
        histogram buckets ship deltas, gauges ship values."""
        out = []
        with _lock:
            for key in self._dirty:
                val = self._values[key]
                if self.KIND in ("counter", "histogram"):
                    out.append((self.KIND, self.name, self.description,
                                key, val, True))
                    self._values[key] = 0.0  # delta shipped
                else:
                    out.append((self.KIND, self.name, self.description,
                                key, val, False))
            self._dirty.clear()
        return out

    def _restore(self, rows: list) -> None:
        """Put undelivered drained rows back (flush failed: monotonic
        counters must not silently undercount)."""
        with _lock:
            for kind, _n, _d, key, value, add in rows:
                if add:
                    self._values[key] = self._values.get(key, 0.0) + value
                elif key not in self._dirty:
                    self._values.setdefault(key, value)
                self._dirty.add(key)


class Counter(Metric):
    """Monotonic counter (reference: util/metrics.py:117)."""

    KIND = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        if value < 0:
            raise ValueError("Counter.inc() takes a non-negative value")
        self._record(_tags_key(self.tag_keys, tags), value, add=True)


class Gauge(Metric):
    """Last-write-wins value (reference: util/metrics.py:192)."""

    KIND = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        self._record(_tags_key(self.tag_keys, tags), float(value),
                     add=False)


class Histogram(Metric):
    """Bucketed observations (reference: util/metrics.py:249). Buckets
    are cumulative Prometheus-style: an observation lands in every bucket
    whose boundary is >= value, plus +Inf."""

    KIND = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys=()):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be a sorted non-empty list")
        self.boundaries = tuple(float(b) for b in boundaries)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[dict] = None):
        base = _tags_key(self.tag_keys, tags)
        value = float(value)
        with _lock:
            for b in self.boundaries:
                key = base + (("le", repr(b)),)
                if value <= b:
                    self._values[key] = self._values.get(key, 0.0) + 1.0
                    self._dirty.add(key)
                elif key not in self._values:
                    # materialize empty lower buckets (standard client-lib
                    # behavior): quantile estimation interpolates between
                    # ADJACENT boundaries, so a missing empty bucket makes
                    # it anchor at 0 and systematically underestimate —
                    # and an all-above-max series would render +Inf only
                    self._values[key] = 0.0
                    self._dirty.add(key)
            ikey = base + (("le", "+Inf"),)
            self._values[ikey] = self._values.get(ikey, 0.0) + 1.0
            self._dirty.add(ikey)
            skey = base + (("__sum__", ""),)
            self._values[skey] = self._values.get(skey, 0.0) + value
            self._dirty.add(skey)


# --------------------------------------------------------------------- #
# flushing to the head
# --------------------------------------------------------------------- #

def _flush_once() -> bool:
    from ..core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    if rt is None or not (isinstance(rt, rt_mod.Runtime)
                          or hasattr(rt, "send")):
        return False  # nothing drained: deltas keep accumulating locally
    with _lock:
        metrics = list(_registry.values())
    per_metric = [(m, m._drain()) for m in metrics]
    rows = [r for _, rs in per_metric for r in rs]
    if not rows:
        return True
    if isinstance(rt, rt_mod.Runtime):
        rt.merge_user_metrics(rows)
        return True
    try:
        rt.send({"t": "user_metrics", "rows": rows})
        return True
    except Exception:
        # delivery failed (head restarting?): restore the deltas so the
        # next flush re-ships them
        for m, rs in per_metric:
            m._restore(rs)
        return False


def _ensure_flusher():
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        while True:
            time.sleep(2.0)
            try:
                _flush_once()
            except Exception:
                pass  # flusher survives transient head loss

    threading.Thread(target=loop, daemon=True,
                     name="rtpu-user-metrics").start()


def flush() -> None:
    """Force an immediate flush (tests / pre-shutdown)."""
    _flush_once()


def shutdown_flush() -> None:
    """Best-effort final flush, wired into runtime teardown: counter
    deltas recorded since the last 2s flush tick would otherwise be lost
    when the process exits. Never raises — teardown must proceed."""
    try:
        _flush_once()
    except Exception:
        pass  # teardown proceeds regardless (docstring)


def zero_gauges(label: tuple) -> None:
    """Set every gauge series carrying the given (key, value) label pair
    to 0 and mark it for shipping. Exit-path cleanup for per-process
    gauges: the head store is last-write-wins with no owner left to
    update a dead process's series, so without this a killed replica's
    last kv_utilization/occupancy values pin /metrics forever."""
    with _lock:
        for m in _registry.values():
            if m.KIND != "gauge":
                continue
            for key in list(m._values):
                if label in key:
                    m._values[key] = 0.0
                    m._dirty.add(key)


def mark_gauges_dirty() -> None:
    """Re-mark every gauge series dirty. Called after a worker/driver
    reconnects to a restarted head: gauges are last-write-wins and live
    only in the head's merged store, which the restart lost — without
    this they vanish from /metrics until the next set(). Counters and
    histogram buckets need no help (their deltas keep accumulating
    locally until a flush succeeds)."""
    with _lock:
        for m in _registry.values():
            if m.KIND == "gauge":
                m._dirty.update(m._values.keys())


def local_store() -> dict:
    """This process's registry rendered in head-store format
    ({name: {kind, desc, series}}). Used when no runtime exists (bench
    runs, unit tests) so metrics_summary()/prometheus_lines() work off
    the local registry; counters that already flushed to a head are not
    included (they drained)."""
    with _lock:
        return {name: {"kind": m.KIND, "desc": m.description,
                       "series": dict(m._values)}
                for name, m in _registry.items() if m._values}


def cached_metric(cls, name: str, description: str = "", **kw):
    """Process-wide metric singleton: construct once, hand the same
    object back on every call (instrumentation sites call this per
    event; re-constructing would re-validate against the registry each
    time). Cleared by _reset_registry() so tests can't leak series."""
    m = _metric_cache.get(name)
    if m is None:
        m = _metric_cache[name] = cls(name, description=description, **kw)
    return m


def _reset_registry() -> None:
    """Test hook: drop every registered metric (and the cached_metric
    singletons) so series can't leak across tests. Metric objects held
    by callers keep working locally but re-register on next
    construction."""
    with _lock:
        _registry.clear()
        _metric_cache.clear()


def histogram_quantiles(buckets: dict, total: float,
                        qs: Sequence[float]) -> list:
    """Quantiles from cumulative Prometheus buckets ({le_label: count},
    le labels as emitted by Histogram.observe — repr(boundary) or
    "+Inf"). Linear interpolation within a bucket, the standard
    histogram_quantile() estimate; a quantile landing in the +Inf bucket
    returns the highest finite boundary (the value is only known to
    exceed it). Returns None per quantile when the histogram is empty."""
    if total <= 0:
        return [None] * len(qs)
    pts = sorted(((float(le), c) for le, c in buckets.items()),
                 key=lambda p: p[0])
    out = []
    for q in qs:
        target = min(max(q, 0.0), 1.0) * total
        prev_b, prev_c, val = 0.0, 0.0, None
        for b, c in pts:
            if c >= target:
                if b == float("inf"):
                    val = prev_b
                else:
                    width = c - prev_c
                    frac = 0.0 if width <= 0 else (target - prev_c) / width
                    val = prev_b + frac * (b - prev_b)
                break
            prev_b, prev_c = b, c
        out.append(val)
    return out


def collect_store() -> dict:
    """The merged user-metric store: head tables on the head driver, the
    user_metrics_dump RPC from a remote driver/worker, this process's
    registry when no runtime exists (bench / unit tests). The shared
    entry point behind serve.metrics_summary() and
    rl.podracer.metrics_summary()."""
    from ..core import runtime as rt_mod
    flush()   # ship this process's deltas first
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        return local_store()
    if isinstance(rt, rt_mod.Runtime):
        with rt.lock:
            return {n: {"kind": r["kind"], "desc": r["desc"],
                        "series": dict(r["series"])}
                    for n, r in rt.user_metrics.items()}
    try:
        return rt._rpc("user_metrics_dump")
    except Exception:
        return local_store()


def histogram_stats(rec: Optional[dict]) -> Optional[dict]:
    """Fold one head-store histogram record (cumulative le buckets +
    __sum__ rows, summed across label sets) into
    {count, mean, p50, p95, p99}; None when absent/empty."""
    if not rec:
        return None
    buckets: dict[str, float] = {}
    total_sum = 0.0
    for key, val in rec["series"].items():
        le = next((v for k, v in key if k == "le"), None)
        if le is not None:
            buckets[le] = buckets.get(le, 0.0) + val
        elif any(k == "__sum__" for k, _ in key):
            total_sum += val
    count = buckets.get("+Inf", 0.0)
    if count <= 0:
        return None
    p50, p95, p99 = histogram_quantiles(buckets, count, (0.5, 0.95, 0.99))
    return {"count": count, "mean": total_sum / count,
            "p50": p50, "p95": p95, "p99": p99}


def _esc_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\"", "\\\"") \
        .replace("\n", "\\n")


def _esc_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _series(name: str, key, val) -> str:
    tags = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
    return f"{name}{{{tags}}} {val}" if tags else f"{name} {val}"


def prometheus_lines(store: dict) -> list[str]:
    """Render the head's merged user-metric store as Prometheus text
    (called by state._prometheus_text). Histograms use the standard
    _bucket/_count/_sum triplet: buckets in ascending numeric `le` order
    (lexical sort would put "10.0" before "2.5", which OpenMetrics
    forbids), then _sum, then _count per label set."""
    lines = []
    for name, rec in sorted(store.items()):
        kind = rec["kind"] if rec["kind"] in ("counter",
                                              "histogram") else "gauge"
        lines.append(f"# HELP {name} {_esc_help(rec['desc'])}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "histogram":
            lines.extend(_histogram_lines(name, rec["series"]))
            continue
        for key, val in sorted(rec["series"].items()):
            if any(k == "__sum__" for k, _ in key):
                # defensive: a kind-mismatched merge left histogram rows
                # under a non-histogram name; render the sum series
                plain = tuple((k, v) for k, v in key if k != "__sum__")
                lines.append(_series(f"{name}_sum", plain, val))
                continue
            lines.append(_series(name, key, val))
    return lines


def _histogram_lines(name: str, series: dict) -> list[str]:
    # group by base label set (everything but le/__sum__), so each label
    # combination emits a complete ordered triplet
    groups: dict = {}
    lines = []
    for key, val in series.items():
        base = tuple((k, v) for k, v in key
                     if k not in ("le", "__sum__"))
        g = groups.setdefault(base, {"buckets": {}, "sum": None})
        if any(k == "__sum__" for k, _ in key):
            g["sum"] = val
            continue
        le = dict(key).get("le")
        if le is None:
            # kind-mismatched cross-process merge folded plain (gauge/
            # counter) rows under a histogram name; render them rather
            # than crash the whole /metrics page
            lines.append(_series(name, key, val))
            continue
        g["buckets"][le] = val
    for base in sorted(groups):
        g = groups[base]
        for le, val in sorted(g["buckets"].items(),
                              key=lambda kv: float(kv[0])):
            lines.append(_series(f"{name}_bucket",
                                 base + (("le", le),), val))
        if g["sum"] is not None:
            lines.append(_series(f"{name}_sum", base, g["sum"]))
        inf = g["buckets"].get("+Inf")
        if inf is not None:
            lines.append(_series(f"{name}_count", base, inf))
    return lines
