"""Flight recorder (core/flight.py): ring mechanics, clock-offset
stitching, and the cluster-stitched Perfetto export on a REAL sealed-
channel serve stream.

The acceptance gate lives in test_serve_stream_exports_stitched_trace:
one compiled-DAG streaming serve request must export to a single
Chrome-trace/Perfetto JSON with >= 3 process tracks and a per-token
producer-seal -> consumer-wake flow edge — the exact visibility
dispatch-keyed span tracing lost once the per-item dispatches were
removed.

The port's copy of ``tests/test_flight.py``, with its imports pointed at
``ray_tpu_torch``.

Its ``shutdown_only`` fixture is the port's own, defined here under the
reference's name: ``tests/conftest.py``'s start the reference's runtime.
"""
import json
import threading
import time

import pytest

from ray_tpu_torch.core import flight


@pytest.fixture
def shutdown_only():
    import ray_tpu_torch as ray
    yield ray
    if ray.is_initialized():
        ray.shutdown()


@pytest.fixture
def small_ring():
    """A private 64-slot recorder; restores the module singleton."""
    import ray_tpu_torch.core.flight as fl
    old = (fl._rec, fl._resolved, fl.evt)
    rec = fl.install_for_test(64)
    yield rec
    fl._rec, fl._resolved, fl.evt = old


# ------------------------------------------------------------------ #
# ring mechanics
# ------------------------------------------------------------------ #

def test_ring_overflow_drops_oldest_and_counts(small_ring):
    cap = small_ring.cap
    n = cap + 50
    for i in range(n):
        flight.evt(flight.OBJ_SEAL, i)
    st = flight.stats()
    assert st["recorded"] == n
    assert st["dropped"] == n - cap
    recs = flight.decode(bytes(small_ring.buf))
    seqs = sorted(r[3] for r in recs if r[1] == flight.OBJ_SEAL)
    # oldest events were overwritten: only the newest `cap` survive —
    # minus the one slot stats()'s count() consumed and zeroed (the
    # next-to-be-overwritten slot, i.e. the oldest survivor; zeroing it
    # is what keeps a wrapped ring from exporting a record one full
    # generation stale on every poll)
    assert len(seqs) == cap - 1
    assert seqs[0] == n - cap + 1 and seqs[-1] == n - 1


def test_bad_args_never_raise(small_ring):
    flight.evt(flight.OBJ_SEAL, "not-an-int")      # type error
    flight.evt(flight.OBJ_SEAL, 1 << 70)           # overflow
    flight.evt(flight.OBJ_SEAL, 7)                 # fine
    assert small_ring.bad == 2
    recs = flight.decode(bytes(small_ring.buf))
    assert [r[3] for r in recs if r[1] == flight.OBJ_SEAL] == [7]


def test_concurrent_emitters_never_block(small_ring):
    # 8 threads x 10k events into a 64-slot ring: the hot path must not
    # lock, raise, or grow; every emit lands (as a count) even though
    # most records are overwritten
    n_threads, per = 8, 10_000

    def pump():
        for i in range(per):
            flight.evt(flight.CHAN_SEAL, i, i)

    ts = [threading.Thread(target=pump) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    st = flight.stats()
    assert st["recorded"] == n_threads * per
    assert st["dropped"] == n_threads * per - small_ring.cap
    # "well under a microsecond" with GIL contention headroom: the
    # budget that lets the recorder stay always-on
    assert wall / (n_threads * per) < 20e-6


def test_disabled_recorder_is_noop():
    import ray_tpu_torch.core.flight as fl
    old = (fl._rec, fl._resolved, fl.evt)
    try:
        fl.set_enabled(False)
        assert not fl.enabled()
        fl.evt(fl.OBJ_SEAL, 1)      # must not raise, must not record
        st = fl.stats()
        assert st["enabled"] is False and st["recorded"] == 0
        assert fl.snapshot() is None
        fl.set_enabled(True)
        assert fl.enabled()
    finally:
        fl._rec, fl._resolved, fl.evt = old
        from ray_tpu_torch.core.config import cfg
        cfg.reset("flight_recorder")


# ------------------------------------------------------------------ #
# clock-offset stitching (synthetic snapshots)
# ------------------------------------------------------------------ #

def _snap(pid, name, records, offset_ns=0):
    buf = bytearray(len(records) * flight.RECSZ)
    for i, (ts, code, tid, a0, a1) in enumerate(records):
        flight.RECORD.pack_into(buf, i * flight.RECSZ, ts, code, tid,
                                a0, a1, 0, 0)
    return {"pid": pid, "proc": name, "cap": len(records),
            "recorded": len(records), "dropped": 0, "bad": 0,
            "buf": bytes(buf), "offset_ns": offset_ns}


def test_offset_stitching_orders_cross_track_edges():
    # producer clock runs 5ms AHEAD of the head clock: raw timestamps
    # would put the wake (head clock) BEFORE the seal it consumed.
    # offset_ns subtracts the skew, restoring seal < wake per message.
    chan, base_ns = 77, 1_000_000_000
    prod = _snap(101, "producer", [
        (base_ns + 5_000_000 + i * 1000, flight.CHAN_SEAL, 1, chan, i)
        for i in range(4)], offset_ns=5_000_000)
    cons = _snap(202, "consumer", [
        (base_ns + 500 + i * 1000, flight.CHAN_WAKE, 2, chan, i)
        for i in range(4)])
    trace = flight.export_chrome([prod, cons])
    evs = [e for e in trace["traceEvents"] if e.get("ph") != "M"]
    # per-track monotone
    for pid in (101, 202):
        ts = [e["ts"] for e in evs if e["pid"] == pid
              and e.get("cat") != "flow"]
        assert ts == sorted(ts)
    # cross-track: every seal precedes the wake of the same seq
    seal = {e["args"]["seq"]: e["ts"] for e in evs
            if e["name"] == "chan_seal"}
    wake = {e["args"]["seq"]: e["ts"] for e in evs
            if e["name"] == "chan_wake"}
    assert set(seal) == set(wake) == {0, 1, 2, 3}
    for s in seal:
        assert seal[s] < wake[s]
    # flow arrows pair each seal (ph=s) with its wake (ph=f) on one id
    starts = {e["id"] for e in evs
              if e.get("cat") == "flow" and e["ph"] == "s"}
    ends = {e["id"] for e in evs
            if e.get("cat") == "flow" and e["ph"] == "f"}
    assert starts == ends and len(starts) == 4


def test_breakdown_matches_b_e_pairs():
    trace = {"traceEvents": [
        {"name": "store_wait", "ph": "B", "pid": 1, "tid": 1, "ts": 0.0},
        {"name": "store_wait", "ph": "E", "pid": 1, "tid": 1,
         "ts": 2_000_000.0},
        {"name": "ctrl_flush", "ph": "i", "pid": 1, "tid": 1, "ts": 1.0},
        # unmatched E (ring truncation): ignored, not negative time
        {"name": "chan_credit", "ph": "E", "pid": 1, "tid": 2, "ts": 5.0},
    ]}
    rep = flight.breakdown(trace)
    assert rep["wait_s"]["store_wait"] == pytest.approx(2.0)
    assert rep["wait_s"]["chan_credit"] == 0.0
    assert rep["counts"]["ctrl_flush"] == 1
    assert rep["events"] == 4


def test_torn_records_dropped_at_export(small_ring):
    flight.evt(flight.OBJ_SEAL, 3)
    buf = bytearray(small_ring.buf)
    # fabricate a torn record: plausible timestamp, unknown code
    flight.RECORD.pack_into(buf, flight.RECSZ, 123456, 9999, 1, 0, 0, 0, 0)
    trace = flight.export_chrome([{"pid": 1, "proc": "x",
                                   "buf": bytes(buf)}])
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("ph") != "M"]
    assert names == ["obj_seal"]


# ------------------------------------------------------------------ #
# the real thing: stitched export of a sealed-channel serve stream
# ------------------------------------------------------------------ #

def test_serve_stream_exports_stitched_trace(tmp_path, shutdown_only):
    ray = shutdown_only
    ray.init(num_cpus=2, object_store_memory=128 << 20)
    from ray_tpu_torch import serve, state

    @serve.deployment
    class Gen:
        def __call__(self, n: int):
            for i in range(int(n)):
                yield f"tok{i}"

    h = serve.run(Gen.bind(), name="flight-gen")
    try:
        t0 = time.monotonic_ns()
        out = list(h.options(stream=True).remote(6))
        assert out == [f"tok{i}" for i in range(6)]

        trace = state.timeline(flight=True)
        evs = [e for e in trace["traceEvents"] if e.get("ph") != "M"]

        # >= 3 process tracks: driver/handle, replica worker, + peers
        pids = {e["pid"] for e in evs}
        assert len(pids) >= 3, f"only {len(pids)} process tracks"

        # per-token seal -> wake edges on the stream channel, stitched
        # onto one clock: each consumed seq has both halves, in order
        seals = {(e["args"]["chan"], e["args"]["seq"]): e
                 for e in evs if e["name"] == "chan_seal"
                 and e["ts"] * 1000.0 >= t0}
        wakes = {(e["args"]["chan"], e["args"]["seq"]): e
                 for e in evs if e["name"] == "chan_wake"
                 and e["ts"] * 1000.0 >= t0}
        consumed = sorted(set(seals) & set(wakes))
        assert len(consumed) >= 6, (len(seals), len(wakes))
        for key in consumed:
            assert seals[key]["ts"] <= wakes[key]["ts"]
            # producer and consumer are different processes: the edge
            # is genuinely cross-track
            assert seals[key]["pid"] != wakes[key]["pid"]

        # flow arrows exist for Perfetto to draw
        assert any(e.get("cat") == "flow" and e["ph"] == "s" for e in evs)
        assert any(e.get("cat") == "flow" and e["ph"] == "f" for e in evs)

        # the export is valid JSON Chrome tracing can load
        out_file = tmp_path / "trace.json"
        out_file.write_text(json.dumps(trace))
        reloaded = json.loads(out_file.read_text())
        assert reloaded["traceEvents"]

        # state.summary() flight health: every process reports, nothing
        # silently saturated, and the live stream channels are closed
        s = state.summary()
        fl_h = s["flight"]
        assert fl_h["events_recorded"] > 0
        assert {p["proc"] for p in fl_h["per_process"]} >= {"head"}
        assert "active_channels" in s
    finally:
        serve.delete("flight-gen")


def test_flight_stats_over_control_plane(shutdown_only):
    ray = shutdown_only
    ray.init(num_cpus=2, object_store_memory=128 << 20)

    @ray.remote
    def noop():
        return 1

    ray.get([noop.remote() for _ in range(8)])
    from ray_tpu_torch.core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    stats = rt.flight_stats()
    # head + every live worker answered the pull
    assert any(p["proc"] == "head" for p in stats)
    workers = [p for p in stats if p["proc"].startswith("worker:")]
    assert workers, stats
    # the workers that executed tasks recorded exec events
    assert sum(p["recorded"] for p in stats) > 0
    assert all(p["dropped"] >= 0 and p["bad"] == 0 for p in stats)
