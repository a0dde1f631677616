"""ray_tpu_torch.obs — the metrics plane: cluster time-series history, SLO
burn-rate engine, and the autoscaler's signal source.

- :mod:`ray_tpu_torch.obs.tsdb` — fixed-memory ring-buffer time-series store
  (bounded by construction: preallocated per-series rings + a hard
  cardinality cap with an ``__overflow__`` sink).
- :mod:`ray_tpu_torch.obs.scraper` — head thread folding the merged
  user-metric store into the TSDB every ``cfg.tsdb_scrape_s`` (no new
  wire frames), plus :func:`~ray_tpu_torch.obs.scraper.autoscale_signals`.
- :mod:`ray_tpu_torch.obs.slo` — declarative ``SLO(metric, objective,
  window)`` objectives evaluated as multi-window burn rates with an
  ok -> warn -> page alert state machine.

The port's copy of ``ray_tpu/obs``. The reference's query surfaces
(``state.metrics_history()``, ``cli top``, the dashboard) wait for the
port's state API; the head's rpcs (``metrics_history``, ``slo_report``,
``obs_signals``) read it today.
"""
from __future__ import annotations

__all__ = ["TSDB", "SLO", "SLOEngine", "MetricsScraper",
           "autoscale_signals", "default_serve_slos"]


def __getattr__(name):
    # PEP 562 lazy exports: importing ray_tpu_torch.obs must stay feather-
    # weight (GL005 / test_no_heavy_imports guard the closure)
    if name in ("TSDB",):
        from .tsdb import TSDB
        return TSDB
    if name in ("SLO", "SLOEngine", "default_serve_slos"):
        from . import slo as _slo
        return getattr(_slo, name)
    if name in ("MetricsScraper", "autoscale_signals"):
        from . import scraper as _scraper
        return getattr(_scraper, name)
    raise AttributeError(name)
