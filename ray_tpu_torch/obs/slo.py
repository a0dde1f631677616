"""Declarative SLOs evaluated as multi-window burn rates over the TSDB.

An :class:`SLO` names a metric, an objective, and a base window::

    SLO("ttft_p95", "rtpu_llm_ttft_seconds", "p95 <= 2.0")
    SLO("shed_ratio", "rtpu_serve_admission_shed_total",
        "ratio <= 0.05",
        denominator=("rtpu_serve_admission_admitted_total",
                     "rtpu_serve_admission_shed_total"))

Two objective shapes:

- ``pNN <= T``: a latency histogram; good events are observations at or
  under ``T`` seconds (interpolated between bucket boundaries), the
  error budget is ``1 - NN/100`` — "95% of requests see TTFT <= 2s".
- ``ratio <= B``: a counter ratio; bad events are the metric's windowed
  increase, total events the summed denominator increases, budget B.

**Burn rate** is the classic SRE quantity: ``bad_fraction / budget`` —
1.0 means exactly consuming the budget, 14 means the budget is gone in
1/14th of the compliance period. Each SLO is evaluated over two window
PAIRS scaled to ``cfg.tsdb_scrape_s`` (so tests with a 50 ms scrape run
in seconds while production with the 15 s default gets the canonical
5m/1h + 30m/6h):

- **page** when the fast pair — ``window`` (default 240 ticks = 1h at
  15 s) AND ``window/12`` (5m) — both burn above ``page_burn`` (14.4:
  budget exhausted inside ~3 days at that rate);
- **warn** when the slow pair — ``window/2`` (30m) and ``6*window``
  (6h) — both burn above ``warn_burn`` (6.0).

The dual-window AND is what keeps this noise-immune: the short window
makes alerts reset quickly once the burn stops, the long window keeps a
two-sample blip from paging anyone.

The per-SLO alert state machine (ok -> warn -> page, hysteresis-free
because the windows themselves smooth) emits on every transition: a
``slo_transition`` flight event, ``rtpu_obs_slo_transitions_total`` and
the ``rtpu_obs_slo_state`` / ``rtpu_obs_slo_burn_rate`` gauges — which
the scraper then folds back into the TSDB like any other series, so
``cli slo`` can show alert history.
"""
from __future__ import annotations

import re
import time
from typing import Optional, Sequence

from ..core import flight as _fl
from ..util.metrics import Counter, Gauge, cached_metric as _metric

_OBJECTIVE_RE = re.compile(
    r"^\s*(?:p(?P<q>\d+(?:\.\d+)?)|(?P<ratio>ratio))\s*<=?\s*"
    r"(?P<bound>[0-9.eE+-]+)\s*$")

_STATES = ("ok", "warn", "page")
_STATE_CODE = {s: i for i, s in enumerate(_STATES)}

# canonical burn thresholds (Google SRE workbook multiwindow values)
PAGE_BURN = 14.4
WARN_BURN = 6.0


def _slo_state_gauge() -> Gauge:
    return _metric(Gauge, "rtpu_obs_slo_state",
                   "alert state per SLO (0 ok, 1 warn, 2 page)",
                   tag_keys=("slo",))


def _slo_burn_gauge() -> Gauge:
    return _metric(Gauge, "rtpu_obs_slo_burn_rate",
                   "error-budget burn rate per SLO and window pair "
                   "(1.0 = consuming exactly the budget)",
                   tag_keys=("slo", "pair"))


def _slo_transitions() -> Counter:
    return _metric(Counter, "rtpu_obs_slo_transitions_total",
                   "alert state-machine transitions",
                   tag_keys=("slo", "from", "to"))


class SLO:
    """One declarative objective. ``window`` is the fast-long window in
    seconds; None derives 240 scrape ticks (1h at the 15 s default)."""

    def __init__(self, name: str, metric: str, objective: str,
                 window: Optional[float] = None, *,
                 denominator: Sequence[str] = (),
                 tags: Optional[dict] = None,
                 page_burn: float = PAGE_BURN,
                 warn_burn: float = WARN_BURN):
        m = _OBJECTIVE_RE.match(objective)
        if m is None:
            raise ValueError(
                f"objective {objective!r} must look like 'p95 <= 2.0' "
                f"or 'ratio <= 0.05'")
        self.name = name
        self.metric = metric
        self.objective = objective
        self.window = window
        self.tags = dict(tags or {})
        self.denominator = tuple(denominator)
        self.page_burn = float(page_burn)
        self.warn_burn = float(warn_burn)
        if m.group("ratio"):
            self.kind = "ratio"
            self.threshold = None
            self.budget = float(m.group("bound"))
        else:
            self.kind = "quantile"
            self.threshold = float(m.group("bound"))
            self.budget = 1.0 - float(m.group("q")) / 100.0
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"objective {objective!r} leaves no error "
                             f"budget to burn")
        if self.kind == "ratio" and not self.denominator:
            raise ValueError("ratio objectives need denominator=(...) "
                             "counter names")

    # -- burn math --------------------------------------------------------

    def _bad_fraction(self, tsdb, window_s: float,
                      now: Optional[float]) -> Optional[float]:
        """Fraction of the window's events violating the objective, or
        None when the window saw no events at all (no traffic burns no
        budget)."""
        if self.kind == "quantile":
            buckets, total = tsdb.histogram_buckets(
                self.metric, self.tags, window_s, now=now)
            if total <= 0:
                return None
            return 1.0 - _good_count(buckets, self.threshold) / total
        bad = tsdb.increase(self.metric, self.tags, window_s, now=now)
        total = sum(tsdb.increase(d, self.tags, window_s, now=now)
                    for d in self.denominator)
        if total <= 0:
            return None
        return min(bad / total, 1.0)

    def burn(self, tsdb, window_s: float,
             now: Optional[float] = None) -> float:
        bad = self._bad_fraction(tsdb, window_s, now)
        return 0.0 if bad is None else bad / self.budget

    def windows(self, scrape_s: float) -> dict:
        """The four evaluation windows in seconds, derived from the base
        window (fast-long) scaled to the scrape tick."""
        fast_long = self.window if self.window is not None \
            else 240.0 * scrape_s
        return {"fast": (fast_long / 12.0, fast_long),
                "slow": (fast_long / 2.0, fast_long * 6.0)}


def _good_count(buckets: dict, threshold: float) -> float:
    """Observations at or under ``threshold``, linearly interpolated
    between the adjacent cumulative bucket boundaries (the same estimate
    histogram_quantile makes, inverted)."""
    pts = sorted(((float(le), c) for le, c in buckets.items()),
                 key=lambda p: p[0])
    if not pts:
        return 0.0
    prev_b, prev_c = 0.0, 0.0
    for b, c in pts:
        if threshold < b:
            if b == float("inf"):
                return prev_c
            width = b - prev_b
            frac = 1.0 if width <= 0 else (threshold - prev_b) / width
            return prev_c + max(0.0, min(1.0, frac)) * (c - prev_c)
        prev_b, prev_c = b, c
    return pts[-1][1]


def default_serve_slos() -> list[SLO]:
    """The shipped serving objectives (thresholds are cfg flags):
    TTFT p95, end-to-end p99, proxy error ratio, admission shed ratio."""
    from ..core.config import cfg
    return [
        SLO("ttft_p95", "rtpu_llm_ttft_seconds",
            f"p95 <= {cfg.serve_slo_ttft_s}"),
        SLO("e2e_p99", "rtpu_serve_request_latency_seconds",
            f"p99 <= {cfg.serve_slo_e2e_s}"),
        SLO("error_ratio", "rtpu_serve_request_errors_total",
            f"ratio <= {cfg.serve_slo_error_ratio}",
            denominator=("rtpu_serve_proxy_requests_total",)),
        SLO("shed_ratio", "rtpu_serve_admission_shed_total",
            f"ratio <= {cfg.serve_slo_shed_ratio}",
            denominator=("rtpu_serve_admission_admitted_total",
                         "rtpu_serve_admission_shed_total")),
    ]


class SLOEngine:
    """Evaluates a set of SLOs against a TSDB and runs the per-SLO alert
    state machine. Single-threaded by contract: only the scraper tick
    calls :meth:`evaluate`; readers take :meth:`report` snapshots."""

    def __init__(self, tsdb, slos: Optional[Sequence[SLO]] = None):
        self.tsdb = tsdb
        self.slos = list(slos) if slos is not None \
            else default_serve_slos()
        self._state: dict[str, dict] = {
            s.name: {"state": "ok", "since": time.time()}
            for s in self.slos}
        self._last_report: dict = {"slos": [], "states": {}}

    def add(self, slo: SLO) -> None:
        self.slos.append(slo)
        self._state[slo.name] = {"state": "ok", "since": time.time()}

    def evaluate(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        rows = []
        for i, slo in enumerate(self.slos):
            pairs = slo.windows(self.tsdb.scrape_s)
            burns = {
                pair: (slo.burn(self.tsdb, short, now),
                       slo.burn(self.tsdb, long_, now))
                for pair, (short, long_) in pairs.items()}
            paging = all(b > slo.page_burn for b in burns["fast"])
            warning = all(b > slo.warn_burn for b in burns["slow"])
            new = "page" if paging else ("warn" if warning else "ok")
            st = self._state[slo.name]
            old = st["state"]
            if new != old:
                st["state"] = new
                st["since"] = now
                self._on_transition(i, slo, old, new)
            self._gauge(slo, burns, new)
            rows.append({
                "slo": slo.name, "metric": slo.metric,
                "objective": slo.objective, "state": new,
                "since": st["since"],
                "burn_fast": [round(b, 4) for b in burns["fast"]],
                "burn_slow": [round(b, 4) for b in burns["slow"]],
                "budget": slo.budget,
                "windows_s": {k: list(v) for k, v in pairs.items()},
            })
        self._last_report = {
            "slos": rows,
            "states": {r["slo"]: r["state"] for r in rows},
            "evaluated_at": now,
        }
        return self._last_report

    def report(self) -> dict:
        return self._last_report

    def _on_transition(self, idx: int, slo: SLO, old: str, new: str):
        _fl.evt(_fl.SLO_TRANSITION, idx, _STATE_CODE[new],
                _STATE_CODE[old])
        try:
            _slo_transitions().inc(1.0, tags={
                "slo": slo.name, "from": old, "to": new})
        except Exception:
            pass  # telemetry must never fail an evaluation tick

    def _gauge(self, slo: SLO, burns: dict, state: str):
        try:
            _slo_state_gauge().set(float(_STATE_CODE[state]),
                                   tags={"slo": slo.name})
            for pair, (short, long_) in burns.items():
                # the pair's effective burn is the MIN of its two
                # windows (both must exceed the threshold to alert)
                _slo_burn_gauge().set(min(short, long_), tags={
                    "slo": slo.name, "pair": pair})
        except Exception:
            pass  # telemetry must never fail an evaluation tick
