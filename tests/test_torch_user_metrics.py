"""User-defined metrics (reference: python/ray/util/metrics.py —
Counter:117, Gauge:192, Histogram:249 exported via Prometheus).

The port's copy of ``tests/test_user_metrics.py``, with its imports
pointed at ``ray_tpu_torch``.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import metrics as um


@pytest.fixture
def ray2():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def _prom_text():
    from ray_tpu_torch import state
    return state._prometheus_text()


def test_counter_across_tasks_and_driver(ray2):
    c = um.Counter("app_events", description="events",
                   tag_keys=("kind",))
    c.inc(2.0, tags={"kind": "driver"})
    um.flush()

    @ray_tpu_torch.remote
    def work():
        from ray_tpu_torch.util import metrics as m
        cc = m.Counter("app_events", description="events",
                       tag_keys=("kind",))
        cc.inc(3.0, tags={"kind": "task"})
        m.flush()
        return 1

    assert ray_tpu_torch.get([work.remote() for _ in range(2)],
                             timeout=60) == [1, 1]
    # deltas from both worker processes SUM on the head
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        text = _prom_text()
        if 'app_events{kind="task"} 6.0' in text:
            break
        time.sleep(0.3)
    assert 'app_events{kind="driver"} 2.0' in text
    assert 'app_events{kind="task"} 6.0' in text
    assert "# TYPE app_events counter" in text


def test_gauge_last_write_wins(ray2):
    g = um.Gauge("app_depth", description="queue depth")
    g.set(5.0)
    g.set(7.0)
    um.flush()
    assert "app_depth 7.0" in _prom_text()


def test_histogram_buckets(ray2):
    h = um.Histogram("app_latency", description="latency",
                     boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    um.flush()
    text = _prom_text()
    assert "# TYPE app_latency histogram" in text
    assert 'app_latency_bucket{le="0.1"} 1.0' in text
    assert 'app_latency_bucket{le="1.0"} 2.0' in text
    assert 'app_latency_bucket{le="+Inf"} 3.0' in text
    assert "app_latency_count 3.0" in text
    assert "app_latency_sum 5.55" in text


def test_label_escaping_and_bad_boundaries(ray2):
    c = um.Counter("app_esc", tag_keys=("q",))
    c.inc(1.0, tags={"q": 'a"b\nc'})
    um.flush()
    text = _prom_text()
    assert 'app_esc{q="a\\"b\\nc"} 1.0' in text
    with pytest.raises(ValueError):
        um.Counter("0bad")
    um.Histogram("app_hist2", boundaries=[0.1])
    with pytest.raises(ValueError):
        um.Histogram("app_hist2", boundaries=[0.5, 2.0])  # differs


def test_metric_validation(ray2):
    with pytest.raises(ValueError):
        um.Counter("bad name!")
    c = um.Counter("app_val", tag_keys=("a",))
    with pytest.raises(ValueError):
        c.inc(1.0, tags={"b": "x"})  # undeclared tag
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(ValueError):
        um.Gauge("app_val")  # same name, different kind
    with pytest.raises(ValueError):
        um.Histogram("app_hist", boundaries=[])


# --------------------------------------------------------------------- #
# rendering + flush-protocol units (no cluster needed)
# --------------------------------------------------------------------- #

@pytest.fixture
def fresh_registry():
    um._reset_registry()
    yield
    um._reset_registry()


def test_prometheus_histogram_triplet_ordering(fresh_registry):
    h = um.Histogram("tri_lat", description="d",
                     boundaries=[0.5, 2.5, 10.0], tag_keys=("route",))
    for v in (0.1, 1.0, 20.0):
        h.observe(v, tags={"route": "/a"})
    lines = um.prometheus_lines(um.local_store())
    tri = [ln for ln in lines if ln.startswith("tri_lat")]
    # buckets in ascending NUMERIC le order (lexical sort would put
    # "10.0" before "2.5"), then _sum, then _count — one full triplet
    les = [ln.split('le="')[1].split('"')[0] for ln in tri
           if ln.startswith("tri_lat_bucket")]
    assert les == ["0.5", "2.5", "10.0", "+Inf"]
    counts = [float(ln.rsplit(" ", 1)[1]) for ln in tri
              if ln.startswith("tri_lat_bucket")]
    assert counts == [1.0, 2.0, 2.0, 3.0]  # cumulative
    names = [ln.split("{")[0].split(" ")[0] for ln in tri]
    assert names.index("tri_lat_sum") > names.index("tri_lat_bucket")
    assert names[-1] == "tri_lat_count"
    # _count mirrors the +Inf bucket
    assert tri[-1] == 'tri_lat_count{route="/a"} 3.0'


def test_prometheus_label_escaping(fresh_registry):
    c = um.Counter("esc_total", tag_keys=("q",))
    c.inc(1.0, tags={"q": 'a"b\\c\nd'})
    lines = um.prometheus_lines(um.local_store())
    assert 'esc_total{q="a\\"b\\\\c\\nd"} 1.0' in lines


def test_counter_restore_after_failed_flush(fresh_registry):
    c = um.Counter("restore_total")
    c.inc(5.0)
    rows = c._drain()
    assert [r[4] for r in rows] == [5.0]
    assert not c._dirty          # drained: nothing pending
    c.inc(2.0)                   # new delta while the send is in flight
    c._restore(rows)             # delivery failed: put the 5.0 back
    rows2 = c._drain()
    assert [r[4] for r in rows2] == [7.0]  # nothing under- or over-counted


def test_mark_gauges_dirty_reships_series(fresh_registry):
    g = um.Gauge("depth_g", tag_keys=("k",))
    g.set(3.0, tags={"k": "a"})
    assert g._drain()            # shipped once
    assert not g._drain()        # steady state: nothing dirty
    um.mark_gauges_dirty()       # head restarted: its store is gone
    rows = g._drain()
    assert [(r[3], r[4]) for r in rows] == [((("k", "a"),), 3.0)]


def test_zero_gauges_by_label(fresh_registry):
    g = um.Gauge("proc_g", tag_keys=("engine", "proc"))
    g.set(0.9, tags={"engine": "paged", "proc": "h:1"})
    g.set(0.2, tags={"engine": "paged", "proc": "h:2"})
    g._drain()
    um.zero_gauges(("proc", "h:1"))   # process h:1 died
    rows = g._drain()                 # only its series re-ships, at 0
    assert [(r[3], r[4]) for r in rows] == \
        [((("engine", "paged"), ("proc", "h:1")), 0.0)]


def test_reset_registry_drops_kind_conflicts(fresh_registry):
    um.Counter("reused_name")
    with pytest.raises(ValueError):
        um.Gauge("reused_name")
    um._reset_registry()
    um.Gauge("reused_name")      # fresh registry: no stale kind


def test_histogram_quantiles_units():
    # interpolated mid-bucket estimates
    buckets = {"1.0": 10.0, "2.0": 20.0, "+Inf": 20.0}
    p50, p99 = um.histogram_quantiles(buckets, 20.0, (0.5, 0.99))
    assert p50 == pytest.approx(1.0)
    assert p99 == pytest.approx(1.98)
    # a quantile landing in +Inf clamps to the highest finite boundary
    (p95,) = um.histogram_quantiles({"1.0": 0.0, "+Inf": 5.0}, 5.0, (0.95,))
    assert p95 == 1.0
    # empty histogram: None per quantile
    assert um.histogram_quantiles({}, 0.0, (0.5, 0.99)) == [None, None]


def test_observe_materializes_empty_buckets(fresh_registry):
    """Quantile interpolation anchors at the previous boundary, so
    observe() must create the zero-count buckets below the observation —
    otherwise a series whose values all land high interpolates from 0
    (or, past the last boundary, collapses to 0.0)."""
    h = um.Histogram("mat_lat", boundaries=[1.0, 2.0, 4.0],
                     tag_keys=("k",))
    h.observe(3.0, tags={"k": "a"})       # below-boundaries 1.0/2.0 empty
    rec = um.local_store()["mat_lat"]
    buckets = {dict(key)["le"]: v for key, v in rec["series"].items()
               if any(k == "le" for k, _ in key)}
    assert buckets == {"1.0": 0.0, "2.0": 0.0, "4.0": 1.0, "+Inf": 1.0}
    (p50,) = um.histogram_quantiles(buckets, 1.0, (0.5,))
    assert 2.0 <= p50 <= 4.0              # not dragged toward 0
    # every observation above the top boundary: clamp to it, not 0.0
    h.observe(99.0, tags={"k": "b"})
    buckets_b = {dict(key)["le"]: v for key, v in
                 um.local_store()["mat_lat"]["series"].items()
                 if any(k == "le" for k, _ in key)
                 and dict(key).get("k") == "b"}
    (p95,) = um.histogram_quantiles(buckets_b, 1.0, (0.95,))
    assert p95 == 4.0


def test_prometheus_lines_tolerates_kind_mismatched_merge(fresh_registry):
    # a cross-process kind collision can fold plain rows into a histogram
    # record; /metrics must render them instead of raising KeyError
    store = {"mix_lat": {"kind": "histogram", "desc": "d", "series": {
        ((("k", "a"), ("le", "1.0"))): 1.0,
        ((("k", "a"), ("le", "+Inf"))): 1.0,
        ((("k", "a"), ("__sum__", ""))): 0.5,
        ((("k", "b"),)): 7.0,            # gauge row, no le/__sum__
    }}}
    lines = um.prometheus_lines(store)
    assert 'mix_lat{k="b"} 7.0' in lines
    assert 'mix_lat_count{k="a"} 1.0' in lines
