"""Fixed-memory cluster time-series store (the metrics plane's floor).

Every ``rtpu_*`` metric so far has been an instantaneous last-value
snapshot: ``metrics_summary()`` can show the current queue depth, never
a trend, so nothing downstream (SLO burn rates, signal-driven
autoscaling, ``cli top``) could exist. This module is the retained
substrate: a per-series preallocated (ts, value) ring — no allocation
after first touch, no unbounded growth — fed by the head scraper
(obs/scraper.py) from the merged user-metric store every
``cfg.tsdb_scrape_s`` tick.

Memory is bounded by construction, not by policy:

- each series owns exactly ``retention_points`` (ts, value) float pairs,
  preallocated on first record and overwritten oldest-first;
- the series COUNT is capped (``cfg.tsdb_max_series``): once the table
  is full, samples for never-before-seen label sets fold into one
  ``__overflow__`` sink series per metric name — client-controlled
  labels (tenant ids, routes) can never grow head memory, the same
  contract as the front door's bounded tenant tracking. (The sinks
  themselves may sit past the cap: at most one extra ring per metric
  NAME, and names come from code, not from request data — the ceiling
  is ``(max_series + n_names) x retention x 16`` bytes, which
  ``stats()`` reports against the live name count.)

Counters are stored as the scraped cumulative values; :meth:`TSDB.rate`
and :meth:`TSDB.increase` are monotonic-reset-aware (a value drop reads
as a restart from zero, Prometheus ``increase()`` semantics), so a
replica death mid-window undercounts by at most the pre-reset running
total rather than going negative. Histogram bucket series ride the same
rings (one series per ``le``); :meth:`TSDB.histogram_quantiles` takes
bucket *increases* over any window and folds them through
``util.metrics.histogram_quantiles`` — windowed p50/p95/p99, not
since-boot.

Tag matching is subset-style: ``tags={"app": "default"}`` matches every
series carrying that pair, so callers aggregate across the labels they
don't name (again the Prometheus convention).
"""
from __future__ import annotations

import threading
from array import array
from typing import Optional, Sequence

from ..util.metrics import histogram_quantiles as _hist_quantiles

#: the per-name sink key once the series table is full
OVERFLOW_KEY = (("__overflow__", ""),)


class _SeriesRing:
    """One series: preallocated (ts, value) ring, oldest overwritten."""

    __slots__ = ("kind", "ts", "vals", "n", "head", "cap")

    def __init__(self, kind: str, cap: int):
        self.kind = kind
        self.cap = cap
        self.ts = array("d", bytes(8 * cap))
        self.vals = array("d", bytes(8 * cap))
        self.n = 0        # live points (<= cap)
        self.head = 0     # next write slot

    def push(self, ts: float, value: float) -> None:
        self.ts[self.head] = ts
        self.vals[self.head] = value
        self.head = (self.head + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def points(self, since: Optional[float] = None) -> list:
        """Chronological [(ts, value)] — all retained points, or only
        those at or after ``since``. Delta/rate queries use the first
        IN-window point as their baseline (increments that landed
        between the last pre-window sample and the window edge are
        dropped, not double-counted — the conservative side of
        Prometheus's extrapolation)."""
        start = (self.head - self.n) % self.cap
        out = [(self.ts[(start + i) % self.cap],
                self.vals[(start + i) % self.cap])
               for i in range(self.n)]
        if since is None:
            return out
        return [p for p in out if p[0] >= since]

    def window(self, since: Optional[float],
               until: Optional[float]) -> list:
        """Points in [since, until] — ``until`` matters for historical
        queries (a slope's previous-window read must not see newer
        samples)."""
        pts = self.points(since)
        if until is None:
            return pts
        return [p for p in pts if p[0] <= until]

    def last(self) -> Optional[tuple]:
        if self.n == 0:
            return None
        i = (self.head - 1) % self.cap
        return (self.ts[i], self.vals[i])


def _key_matches(key: tuple, tags: Optional[dict]) -> bool:
    if not tags:
        return True
    pairs = dict(key)
    return all(pairs.get(k) == str(v) for k, v in tags.items())


def _increase(points: list) -> float:
    """Reset-aware counter increase across chronological points (the
    first point is the baseline; a drop = restart from zero)."""
    if len(points) < 2:
        return 0.0
    inc = 0.0
    prev = points[0][1]
    for _t, v in points[1:]:
        inc += (v - prev) if v >= prev else v
        prev = v
    return inc


class TSDB:
    """The head's bounded-memory time-series store. Thread-safe: the
    scraper records from its own thread while RPC-pool threads query."""

    def __init__(self, retention_points: int, scrape_s: float,
                 max_series: int):
        self.retention_points = max(8, int(retention_points))
        self.scrape_s = max(0.01, float(scrape_s))
        self.max_series = max(16, int(max_series))
        self._lock = threading.Lock()
        # (name, key) -> _SeriesRing
        self._series: dict[tuple, _SeriesRing] = {}  # guarded by: self._lock
        self._kinds: dict[str, str] = {}  # guarded by: self._lock
        self._overflow_samples = 0  # guarded by: self._lock
        self._recorded = 0  # guarded by: self._lock

    # -- ingest -----------------------------------------------------------

    def record(self, name: str, kind: str, key: tuple, ts: float,
               value: float) -> None:
        """Append one sample. ``key`` is the util/metrics tag tuple
        (sorted (k, v) pairs; histogram bucket rows carry their ``le``
        pair). Past the series cap, unseen (name, key) pairs fold into
        the per-name ``__overflow__`` sink."""
        with self._lock:
            ring = self._series.get((name, key))
            if ring is None:
                if len(self._series) >= self.max_series:
                    # table full: fold into the per-name sink. The sink
                    # ring itself may allocate past max_series — bounded
                    # by the number of metric NAMES, which come from
                    # code, not from client-controlled label values
                    # (the cap's actual threat model)
                    key = OVERFLOW_KEY
                    self._overflow_samples += 1
                    ring = self._series.get((name, key))
                if ring is None:
                    ring = self._series[(name, key)] = _SeriesRing(
                        kind, self.retention_points)
            self._kinds[name] = kind
            ring.push(ts, value)
            self._recorded += 1

    def record_store(self, store: dict, ts: float) -> None:
        """Fold one ``util.metrics.collect_store()`` snapshot — the
        scraper's per-tick call. Histogram ``le``/``__sum__`` rows become
        ordinary series (their key carries the distinguishing pair)."""
        for name, rec in store.items():
            kind = rec.get("kind", "gauge")
            for key, value in rec.get("series", {}).items():
                self.record(name, kind, key, ts, float(value))

    # -- queries ----------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _k in self._series})

    def kind_of(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def query(self, name: str, tags: Optional[dict] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> list[dict]:
        """Range query: every matching series with its retained points
        trimmed to [now - window_s, now]. An explicit ``now`` makes the
        query historical (synthetic clocks, slope previous-window
        reads); the upper bound is unenforced only when neither window
        nor now is given."""
        since = until = None
        if window_s is not None:
            import time
            until = time.time() if now is None else now
            since = until - window_s
        elif now is not None:
            until = now
        with self._lock:
            rows = [(k, r) for (n, k), r in self._series.items()
                    if n == name and _key_matches(k, tags)]
            return [{"key": list(k), "kind": r.kind,
                     "points": r.window(since, until)} for k, r in rows]

    def instant(self, name: str, tags: Optional[dict] = None) -> list[dict]:
        """Latest sample per matching series."""
        with self._lock:
            out = []
            for (n, k), r in self._series.items():
                if n != name or not _key_matches(k, tags):
                    continue
                last = r.last()
                if last is not None:
                    out.append({"key": list(k), "ts": last[0],
                                "value": last[1]})
            return out

    def increase(self, name: str, tags: Optional[dict] = None,
                 window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Counter increase over the window, summed across matching
        series, monotonic-reset-aware."""
        total = 0.0
        for s in self.query(name, tags, window_s, now=now):
            total += _increase(s["points"])
        return total

    def rate(self, name: str, tags: Optional[dict] = None,
             window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """Per-second counter rate over the window (increase / window).
        With no window, uses the full retention span actually covered."""
        if window_s is None:
            spans = [s["points"] for s in self.query(name, tags)]
            ts = [p[0] for pts in spans for p in pts]
            if len(ts) < 2:
                return 0.0
            window_s = max(max(ts) - min(ts), self.scrape_s)
            if now is None:
                # anchor the window at the DATA's end, not wall-clock
                # now: an idle counter's whole retained span must stay
                # inside the window (otherwise the earliest points fall
                # off and a since-boot burst reads as rate 0)
                now = max(ts)
        return self.increase(name, tags, window_s, now=now) \
            / max(window_s, 1e-9)

    def histogram_buckets(self, name: str, tags: Optional[dict] = None,
                          window_s: Optional[float] = None,
                          now: Optional[float] = None) -> tuple:
        """(cumulative bucket increases {le: count}, total observations)
        over the window — the shared substrate for windowed quantiles
        and the SLO engine's good-event fractions."""
        buckets: dict[str, float] = {}
        for s in self.query(name, tags, window_s, now=now):
            le = next((v for k, v in s["key"] if k == "le"), None)
            if le is None:
                continue
            buckets[le] = buckets.get(le, 0.0) + _increase(s["points"])
        return buckets, buckets.get("+Inf", 0.0)

    def histogram_quantiles(self, name: str, tags: Optional[dict] = None,
                            window_s: Optional[float] = None,
                            qs: Sequence[float] = (0.5, 0.95, 0.99),
                            now: Optional[float] = None) -> list:
        """Windowed quantiles from bucket-series increases — p50/p95/p99
        over ANY range, not since boot. Returns [None]*len(qs) when the
        window saw no observations."""
        buckets, total = self.histogram_buckets(name, tags, window_s,
                                                now=now)
        return _hist_quantiles(buckets, total, qs)

    def slope_per_s(self, name: str, tags: Optional[dict] = None,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> float:
        """Least-squares slope (value units per second) of a gauge over
        the window, summed-value across matching series per timestamp.
        The autoscaler's trend signal (is TTFT p95 / queue depth
        RISING?) without keeping model state anywhere."""
        merged: dict[float, float] = {}
        for s in self.query(name, tags, window_s, now=now):
            for t, v in s["points"]:
                merged[t] = merged.get(t, 0.0) + v
        pts = sorted(merged.items())
        if len(pts) < 2:
            return 0.0
        n = len(pts)
        mt = sum(t for t, _ in pts) / n
        mv = sum(v for _, v in pts) / n
        denom = sum((t - mt) ** 2 for t, _ in pts)
        if denom <= 0:
            return 0.0
        return sum((t - mt) * (v - mv) for t, v in pts) / denom

    # -- health -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "max_series": self.max_series,
                "retention_points": self.retention_points,
                "scrape_s": self.scrape_s,
                "samples_recorded": self._recorded,
                "overflow_samples": self._overflow_samples,
                # the proof the store is bounded: rings are preallocated
                # (2 doubles/point), so this is a ceiling, not a guess —
                # max_series client-driven series plus at most one
                # __overflow__ sink per (code-controlled) metric name
                "max_bytes": ((self.max_series
                               + len({n for n, _k in self._series}))
                              * self.retention_points * 16),
            }
