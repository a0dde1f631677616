"""Metrics plane acceptance (ray_tpu_torch/obs): TSDB memory-bound proofs,
SLO burn-rate alert transitions under a synthetic clock, the
metrics_history/slo_report query surfaces head-side and over the remote
rpc path, and signal-driven autoscaling — including the ramp proof that
a scale-out decision lands BEFORE the first admission shed, and that
``serve_autoscale_signals=off`` reproduces legacy autoscaler decisions
exactly.

The port's copy of ``tests/test_obs.py``, with its imports pointed at
``ray_tpu_torch``.

Left out: ``test_dashboard_obs_endpoints`` (queue A23): it needs the
port's ``ray_tpu_torch.dashboard`` (not ported yet).

Left out: ``test_cli_top_slo_parse_and_frame`` (queue A23): it needs the
port's ``ray_tpu_torch.cli`` (not ported yet).

Left out: ``test_ramp_scale_out_lands_before_first_shed`` (queue A23):
it needs the port's ``ray_tpu_torch.cli`` (not ported yet).
"""
import itertools
import math
import time

import pytest


# ------------------------------------------------------------------ #
# TSDB units (obs/tsdb.py)
# ------------------------------------------------------------------ #

def test_tsdb_ring_wrap_keeps_newest():
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(retention_points=16, scrape_s=1.0, max_series=64)
    for i in range(40):
        t.record("g", "gauge", (("k", "v"),), float(i), float(i) * 2)
    (s,) = t.query("g")
    assert len(s["points"]) == 16
    assert s["points"][0] == (24.0, 48.0)       # oldest retained
    assert s["points"][-1] == (39.0, 78.0)      # newest
    # chronological and contiguous across the wrap
    ts = [p[0] for p in s["points"]]
    assert ts == sorted(ts) and ts == [float(x) for x in range(24, 40)]


def test_tsdb_preallocated_and_bounded():
    """The memory proof: rings preallocate at first record and never
    grow; stats() reports the hard byte ceiling."""
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(retention_points=32, scrape_s=1.0, max_series=8)
    t.record("g", "gauge", (), 0.0, 1.0)
    ring = t._series[("g", ())]
    assert len(ring.ts) == 32 and len(ring.vals) == 32
    for i in range(1000):
        t.record("g", "gauge", (), float(i), 1.0)
    assert len(ring.ts) == 32                    # still the same arrays
    st = t.stats()
    # ceiling = cap + one potential __overflow__ sink per live NAME
    assert st["max_bytes"] == (t.max_series + 1) * 32 * 16


def test_tsdb_counter_reset_aware_rate():
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(64, 1.0, 64)
    # 0 -> 5 -> 10, reset (replica died), 2 -> 4
    for i, v in enumerate([0.0, 5.0, 10.0, 2.0, 4.0]):
        t.record("c", "counter", (), float(i), v)
    # increase = 5 + 5 + 2 (restart from zero) + 2 — never negative
    assert t.increase("c", None, 10.0, now=4.0) == pytest.approx(14.0)
    assert t.rate("c", None, 4.0, now=4.0) == pytest.approx(14.0 / 4.0)
    # window trimming: only the last step counts
    assert t.increase("c", None, 1.0, now=4.0) == pytest.approx(2.0)
    # a no-window rate anchors at the DATA's end, not wall-clock now: a
    # since-boot burst followed by idleness must not read as rate 0
    t2 = TSDB(64, 1.0, 64)
    t2.record("b", "counter", (), 0.0, 0.0)
    t2.record("b", "counter", (), 1.0, 100.0)
    assert t2.rate("b") == pytest.approx(100.0)


def test_tsdb_windowed_histogram_quantiles():
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(64, 1.0, 64)

    def snap(ts, a, b, inf, s):
        t.record("h", "histogram", (("le", "0.1"),), ts, float(a))
        t.record("h", "histogram", (("le", "1.0"),), ts, float(b))
        t.record("h", "histogram", (("le", "+Inf"),), ts, float(inf))
        t.record("h", "histogram", (("__sum__", ""),), ts, float(s))

    snap(0.0, 0, 0, 0, 0.0)
    snap(10.0, 10, 20, 20, 6.0)      # epoch A: half fast, half slow
    snap(20.0, 110, 120, 120, 16.0)  # epoch B: 100 more, ALL fast
    # full range: 120 obs, ~92% under 0.1
    q_all = t.histogram_quantiles("h", None, 30.0, (0.5,), now=20.0)
    assert q_all[0] is not None and q_all[0] <= 0.1
    # windowed to epoch B only: p95 under 0.1 (all 100 were fast) —
    # impossible to see from since-boot cumulative buckets
    q_b = t.histogram_quantiles("h", None, 10.0, (0.95,), now=20.0)
    assert q_b[0] is not None and q_b[0] <= 0.1
    # epoch A alone: p95 lands in the slow bucket
    q_a = t.histogram_quantiles("h", None, 10.0, (0.95,), now=10.0)
    assert q_a[0] is not None and q_a[0] > 0.1
    # empty window: no observations -> None
    assert t.histogram_quantiles("h", None, 1.0, (0.5,),
                                 now=100.0) == [None]


def test_tsdb_cardinality_cap_overflow_sink():
    from ray_tpu_torch.obs.tsdb import TSDB, OVERFLOW_KEY
    t = TSDB(8, 1.0, max_series=16)
    for i in range(200):
        t.record("m", "counter", (("tenant", f"t{i}"),), float(i), 1.0)
    st = t.stats()
    # 16 real series + at most the one per-name sink
    assert st["series"] <= 17
    assert st["overflow_samples"] >= 184
    ov = t.query("m", {"__overflow__": ""})
    assert ov and ov[0]["key"] == list(OVERFLOW_KEY)
    assert ov[0]["points"], "overflow samples were dropped, not folded"
    # established series keep recording past the cap
    t.record("m", "counter", (("tenant", "t0"),), 300.0, 2.0)
    (s0,) = t.query("m", {"tenant": "t0"})
    assert s0["points"][-1] == (300.0, 2.0)


def test_tsdb_tag_subset_matching():
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(8, 1.0, 64)
    t.record("q", "gauge", (("app", "a"), ("dep", "d1")), 1.0, 5.0)
    t.record("q", "gauge", (("app", "a"), ("dep", "d2")), 1.0, 7.0)
    t.record("q", "gauge", (("app", "b"), ("dep", "d1")), 1.0, 9.0)
    assert len(t.query("q", {"app": "a"})) == 2
    assert len(t.query("q", {"app": "a", "dep": "d2"})) == 1
    vals = [s["value"] for s in t.instant("q", {"dep": "d1"})]
    assert sorted(vals) == [5.0, 9.0]


# ------------------------------------------------------------------ #
# SLO burn-rate engine (obs/slo.py) — synthetic clock
# ------------------------------------------------------------------ #

def test_slo_objective_parsing():
    from ray_tpu_torch.obs.slo import SLO
    s = SLO("t", "m", "p95 <= 2.0")
    assert s.kind == "quantile" and s.threshold == 2.0
    assert s.budget == pytest.approx(0.05)
    r = SLO("r", "bad", "ratio <= 0.01", denominator=("all",))
    assert r.kind == "ratio" and r.budget == 0.01
    with pytest.raises(ValueError):
        SLO("x", "m", "under 2 seconds")
    with pytest.raises(ValueError):
        SLO("x", "m", "ratio <= 0.01")          # no denominator
    with pytest.raises(ValueError):
        SLO("x", "m", "p100 <= 1.0")            # zero budget


def test_slo_burn_alert_transitions_synthetic_clock():
    """ok -> page during a shed storm, back to ok after recovery —
    driven entirely by a synthetic clock, and the transitions land in
    the rtpu_obs_slo_transitions_total counter."""
    from ray_tpu_torch.obs.slo import SLO, SLOEngine
    from ray_tpu_torch.obs.tsdb import TSDB
    from ray_tpu_torch.util import metrics as um
    um._reset_registry()
    t = TSDB(2048, 0.05, 256)
    eng = SLOEngine(t, [SLO("shed_ratio", "shed_total",
                            "ratio <= 0.05",
                            denominator=("ok_total", "shed_total"))])
    now, ok_c, shed_c = 1000.0, 0.0, 0.0

    def tick(d_ok, d_shed, n):
        nonlocal now, ok_c, shed_c
        rep = None
        for _ in range(n):
            ok_c += d_ok
            shed_c += d_shed
            t.record("ok_total", "counter", (), now, ok_c)
            t.record("shed_total", "counter", (), now, shed_c)
            rep = eng.evaluate(now)
            now += 0.05
        return rep

    rep = tick(10, 0, 100)                      # healthy
    assert rep["states"]["shed_ratio"] == "ok"
    rep = tick(0, 10, 400)                      # the storm
    assert rep["states"]["shed_ratio"] == "page"
    row = rep["slos"][0]
    # both fast windows burning far past the 14.4 page threshold
    assert min(row["burn_fast"]) > 14.4
    rep = tick(10, 0, 3000)                     # recovery drains windows
    assert rep["states"]["shed_ratio"] == "ok"
    # the state machine counted ok->page (warn may be skipped when both
    # pairs trip in one tick) and the recovery transition back
    store = um.local_store()
    series = store["rtpu_obs_slo_transitions_total"]["series"]
    tos = {dict(k).get("to") for k in series}
    assert "page" in tos and "ok" in tos
    # windows scale with the scrape tick (the tests-run-in-seconds
    # contract): fast long = 240 ticks of 0.05 s
    assert row["windows_s"]["fast"][1] == pytest.approx(12.0)


def test_slo_quantile_burn_uses_windowed_buckets():
    """A latency histogram whose RECENT window violates the objective
    burns even though the since-boot distribution looks fine."""
    from ray_tpu_torch.obs.slo import SLO
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(2048, 1.0, 64)
    slo = SLO("lat", "h", "p95 <= 0.5", window=60.0)

    def snap(ts, fast, slow):
        t.record("h", "histogram", (("le", "0.1"),), ts, float(fast))
        t.record("h", "histogram", (("le", "+Inf"),), ts,
                 float(fast + slow))

    # 10k fast observations of history, then a fully-slow recent minute
    snap(0.0, 0, 0)
    snap(1000.0, 10000, 0)
    snap(1055.0, 10000, 200)
    assert slo.burn(t, 60.0, now=1060.0) > 14.4
    # the since-boot window barely burns (2% bad of 10.2k)
    assert slo.burn(t, 1100.0, now=1060.0) < 1.0


def test_default_serve_slos_ship_the_four():
    from ray_tpu_torch.obs.slo import default_serve_slos
    names = [s.name for s in default_serve_slos()]
    assert names == ["ttft_p95", "e2e_p99", "error_ratio", "shed_ratio"]


# ------------------------------------------------------------------ #
# autoscale signals (obs/scraper.py) — unit
# ------------------------------------------------------------------ #

def test_autoscale_signals_fire_and_stay_quiet():
    from ray_tpu_torch.obs.scraper import autoscale_signals
    from ray_tpu_torch.obs.tsdb import TSDB
    t = TSDB(2048, 0.05, 256)
    tags = (("app", "a"), ("deployment", "d"))
    now = 500.0
    # quiet cluster: no signal
    sig = autoscale_signals(t, None, "a", "d", now=now)
    assert sig["scale_out"] is False and sig["reasons"] == []
    # a shed in the window -> reactive signal
    t.record("rtpu_serve_admission_shed_total", "counter",
             tags + (("reason", "queue_full"),), now - 0.5, 0.0)
    t.record("rtpu_serve_admission_shed_total", "counter",
             tags + (("reason", "queue_full"),), now, 3.0)
    sig = autoscale_signals(t, None, "a", "d", now=now)
    assert sig["scale_out"] and "shed" in sig["reasons"]
    # a per-tenant admission backlog -> adapter-aware signal
    t2 = TSDB(2048, 0.05, 256)
    t2.record("rtpu_serve_tenant_queued", "gauge",
              tags + (("tenant", "acme"), ("proxy", "proxy-0")),
              now, 4.0)
    sig = autoscale_signals(t2, None, "a", "d", now=now)
    assert sig["scale_out"] and sig["reasons"] == ["tenant_queue"]
    assert sig["tenant_queued_max"] == 4.0
    # another deployment's backlog must not fire ours
    sig = autoscale_signals(t2, None, "a", "other", now=now)
    assert sig["scale_out"] is False


def test_autoscale_signal_ttft_slope_gated_on_local_pressure():
    """TTFT histograms are cluster-level (engine labels, no app/dep):
    the slope signal fires only for a deployment showing LOCAL pressure
    — deployment A's TTFT collapse must not scale healthy B out."""
    from ray_tpu_torch.obs.scraper import SIGNAL_WINDOW_TICKS, autoscale_signals
    from ray_tpu_torch.obs.tsdb import TSDB
    from ray_tpu_torch.core.config import cfg
    t = TSDB(2048, 1.0, 256)
    win = SIGNAL_WINDOW_TICKS * 1.0
    now = 1000.0
    thresh = cfg.serve_slo_ttft_s

    def snap(ts, fast, slow):
        t.record("rtpu_llm_ttft_seconds", "histogram",
                 (("le", repr(thresh / 4)),), ts, float(fast))
        t.record("rtpu_llm_ttft_seconds", "histogram",
                 (("le", repr(thresh * 4)),), ts, float(fast + slow))
        t.record("rtpu_llm_ttft_seconds", "histogram",
                 (("le", "+Inf"),), ts, float(fast + slow))

    # first half-window fast, recent half-window slow and rising
    snap(now - win, 0, 0)
    snap(now - win / 2, 100, 0)
    snap(now, 100, 50)
    # deployment d carries ongoing load; deployment idle does not
    t.record("rtpu_serve_queue_depth", "gauge",
             (("app", "a"), ("deployment", "d")), now, 3.0)
    sig = autoscale_signals(t, None, "a", "d", now=now)
    assert "ttft_slope" in sig["reasons"]
    assert sig["ttft_p95_s"] > (sig["ttft_p95_prev_s"] or 0.0)
    # the same cluster-wide TTFT data must NOT fire an idle deployment
    quiet = autoscale_signals(t, None, "a", "idle", now=now)
    assert "ttft_slope" not in quiet["reasons"]
    assert quiet["scale_out"] is False


# ------------------------------------------------------------------ #
# signal composition in the controller — signals-off ≡ legacy
# ------------------------------------------------------------------ #

def _mk_state(asc):
    from ray_tpu_torch.serve.api import DeploymentSpec
    from ray_tpu_torch.serve.controller import _DeploymentState
    spec = DeploymentSpec(name="d", func_or_class=lambda: None,
                          autoscaling_config=asc)
    return _DeploymentState(spec, "app", itertools.count(1))


def test_signals_off_reproduces_legacy_exactly():
    """With serve_autoscale_signals=off the composed _autoscale emits
    the SAME target sequence as the pure legacy formula over a load
    sweep — bit-for-bit, not approximately."""
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.serve.api import AutoscalingConfig
    from ray_tpu_torch.serve.controller import ServeController
    asc = AutoscalingConfig(min_replicas=1, max_replicas=8,
                            target_ongoing_requests=2.0,
                            upscale_delay_s=0.0, downscale_delay_s=0.0)
    cfg.override(serve_autoscale_signals="off")
    try:
        ctrl = ServeController()
        st = _mk_state(asc)
        legacy_target = 1
        sweep = [0, 1, 3, 5, 9, 17, 30, 12, 4, 2, 0, 0, 7]
        for ongoing in sweep:
            ctrl._autoscale(st, asc, ongoing)
            desired = math.ceil(ongoing / asc.target_ongoing_requests)
            legacy_target = max(asc.min_replicas,
                                min(asc.max_replicas, desired))
            assert st.target == legacy_target, (ongoing, st.target)
    finally:
        cfg.reset("serve_autoscale_signals")


def test_signal_steps_target_and_vetoes_downscale(monkeypatch):
    """A firing signal steps the target out by one per decision and
    suppresses a concurrent legacy scale-down; when it clears, legacy
    downscale resumes."""
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.serve.api import AutoscalingConfig
    from ray_tpu_torch.serve.controller import ServeController
    asc = AutoscalingConfig(min_replicas=1, max_replicas=3,
                            target_ongoing_requests=100.0,
                            upscale_delay_s=0.0, downscale_delay_s=0.0)
    cfg.override(serve_autoscale_signals="on")
    try:
        ctrl = ServeController()
        st = _mk_state(asc)
        fired = {"sig": {"scale_out": True, "reasons": ["shed"]}}
        monkeypatch.setattr(ServeController, "_signals_for",
                            lambda self, s: fired["sig"])
        ctrl._autoscale(st, asc, 0)      # legacy says 1, signal says out
        assert st.target == 2
        ctrl._autoscale(st, asc, 0)
        assert st.target == 3
        ctrl._autoscale(st, asc, 0)      # clamped at max_replicas
        assert st.target == 3
        fired["sig"] = None              # signal clears -> legacy rules
        ctrl._autoscale(st, asc, 0)
        assert st.target == 1
    finally:
        cfg.reset("serve_autoscale_signals")


# ------------------------------------------------------------------ #
# live cluster: scraper, query surfaces, remote rpc path, dashboard
# ------------------------------------------------------------------ #

@pytest.fixture
def obs_ray():
    """Cluster with a fast TSDB tick so burn windows span seconds."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core.config import cfg
    if ray.is_initialized():
        ray.shutdown()
    cfg.override(tsdb_scrape_s=0.25, worker_prestart=2)
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()
    cfg.reset("tsdb_scrape_s", "worker_prestart")


def test_metrics_history_head_and_remote(obs_ray):
    ray = obs_ray
    from ray_tpu_torch import state
    from ray_tpu_torch.util.metrics import Counter, Histogram, LATENCY_BUCKETS

    c = Counter("rtpu_core_obs_demo_total", tag_keys=("k",))
    h = Histogram("rtpu_llm_ttft_seconds",
                  boundaries=LATENCY_BUCKETS,
                  tag_keys=("engine", "proc"))
    for i in range(10):
        c.inc(2.0, tags={"k": "a"})
        h.observe(0.02 * (i + 1), tags={"engine": "paged", "proc": "p"})
        time.sleep(0.05)
    deadline = time.time() + 15
    hist = {}
    while time.time() < deadline:
        hist = state.metrics_history("rtpu_core_obs_demo_total",
                                     {"k": "a"}, 60.0)
        if hist.get("series") and hist.get("rate_per_s", 0) > 0:
            break
        time.sleep(0.2)
    assert hist["kind"] == "counter" and hist["rate_per_s"] > 0
    # windowed quantiles ride the same query
    q = state.metrics_history("rtpu_llm_ttft_seconds", None, 60.0,
                              quantiles=(0.5, 0.95))
    assert q["quantiles"]["0.95"] is not None
    assert "rtpu_llm_ttft_seconds" in state.metrics_names()
    # slo report: shipped objectives all evaluated, all ok while idle
    rep = state.slo_report()
    assert set(rep["states"]) >= {"ttft_p95", "e2e_p99", "error_ratio",
                                  "shed_ratio"}
    assert rep["tsdb"]["ticks"] > 0
    # summary carries the rollup
    s = state.summary()
    assert s["slo"]["paging"] == []
    # the REMOTE driver path: a worker queries the same surfaces over
    # the existing rpc channel (no new frames)
    @ray.remote
    def probe():
        from ray_tpu_torch import state as ws
        hist = ws.metrics_history("rtpu_core_obs_demo_total",
                                  {"k": "a"}, 60.0)
        return (hist["rate_per_s"], ws.slo_report()["states"],
                "rtpu_core_obs_demo_total" in ws.metrics_names())

    rate, states, has_name = ray.get(probe.remote(), timeout=60)
    assert rate > 0 and has_name
    assert states.get("ttft_p95") == "ok"
