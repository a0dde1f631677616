"""Stall doctor acceptance: live stack capture, stuck-task watchdog,
wait-graph deadlock detection (core/stacks.py + the protocol-v6
stack_dump/stack_reply collection path).

Each hang class the doctor targets is reproduced and diagnosed end-to-end:
a wedged worker is flagged by the watchdog with the remote thread stack
attached; a constructed two-channel wait cycle is reported as a deadlock
naming both parties; stack pulls return while the target's executor
thread is provably blocked.

The port's copy of ``tests/test_stall_doctor.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

Left out: ``test_dashboard_stacks_endpoint`` (queue A23): it needs the
port's ``ray_tpu_torch.dashboard`` (not ported yet).
"""
import os
import threading
import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@pytest.fixture
def stall_ray():
    """Cluster with a fast watchdog (1s floor, 0.2s period) so stuck
    flags land within test budgets."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core.config import cfg
    if ray.is_initialized():
        ray.shutdown()
    cfg.override(stall_watchdog_period_s=0.2, stuck_task_floor_s=1.0)
    ray.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    yield ray
    ray.shutdown()
    cfg.reset("stall_watchdog_period_s", "stuck_task_floor_s")


# ------------------------------------------------------------------ #
# wait beacons (unit)
# ------------------------------------------------------------------ #

def test_wait_beacon_set_clear_roundtrip():
    from ray_tpu_torch.core import stacks
    b = stacks.beacon()
    assert b[0] == 0
    stacks.set_wait(b, stacks.WAIT_OBJ, 0xABCDEF, 3)
    snap = stacks.capture(include_stacks=False)
    me = next(t for t in snap["threads"]
              if t["tid"] == threading.get_ident())
    assert me["wait"]["kind"] == "object_wait"
    assert me["wait"]["id48"] == 0xABCDEF and me["wait"]["n"] == 3
    assert me["wait"]["for_s"] >= 0.0
    stacks.clear_wait(b)
    snap = stacks.capture(include_stacks=False)
    me = next(t for t in snap["threads"]
              if t["tid"] == threading.get_ident())
    assert "wait" not in me


def test_beacon_since_survives_slices_but_not_new_waits():
    """Sliced re-arms of the SAME logical wait keep one since (so
    for_s reflects the whole park, and the deadlock detector's
    sustained-wait gate can trigger); a wait on a different tag — the
    next channel seq — starts fresh (so a healthy consumer never looks
    perpetually parked)."""
    from ray_tpu_torch.core import stacks
    b = stacks.beacon()
    stacks.set_wait(b, stacks.WAIT_CHAN, 0x1111, tag=7)
    t0 = b[3]
    stacks.clear_wait(b)
    # immediate re-arm of the same (kind, id, tag): one logical wait
    stacks.set_wait(b, stacks.WAIT_CHAN, 0x1111, tag=7)
    assert b[3] == t0
    stacks.clear_wait(b)
    # next seq on the same channel: a NEW wait
    stacks.set_wait(b, stacks.WAIT_CHAN, 0x1111, tag=8)
    assert b[3] > t0
    stacks.clear_wait(b)
    # different kind on the same id: also new
    stacks.set_wait(b, stacks.WAIT_OBJ, 0x1111, tag=8)
    assert b[3] > t0
    stacks.clear_wait(b)


def test_store_wait_sets_beacon(ray_start_regular):
    """A thread parked in os_wait_sealed shows up in capture() with the
    object_wait beacon, and the beacon clears when the wait ends."""
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core import stacks
    from ray_tpu_torch.core.ids import ObjectID
    rt = rt_mod.get_runtime_if_exists()
    oid = ObjectID.from_random()
    done = threading.Event()

    def park():
        rt.store.wait_sealed([oid], 1, 5000)
        done.set()

    t = threading.Thread(target=park, name="beacon-park", daemon=True)
    t.start()
    deadline = time.time() + 3
    seen = None
    while time.time() < deadline and seen is None:
        snap = stacks.capture()
        for th in snap["threads"]:
            if th.get("name") == "beacon-park" and th.get("wait"):
                seen = th
                break
        time.sleep(0.02)
    assert seen is not None, "parked thread never showed a beacon"
    assert seen["wait"]["kind"] == "object_wait"
    # the beacon names the id being waited on (lo48 of the oid)
    from ray_tpu_torch.core import flight
    assert seen["wait"]["id48"] == flight.lo48(oid)
    # the captured stack reaches the wait site
    assert any("wait_sealed" in fr[2] for fr in seen["stack"])
    rt.store.put(oid, b"x")
    assert done.wait(5)


def test_credit_wait_beacon_wins_over_inner_object_wait():
    """await_ack's channel_credit beacon spans its inner wait_sealed
    slices — the generic object_wait must not overwrite it."""
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        from ray_tpu_torch.core import runtime as rt_mod
        from ray_tpu_torch.core import stacks
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.dag import channel
        rt = rt_mod.get_runtime_if_exists()
        stop = ObjectID.from_random()
        ack_base = os.urandom(16)

        def park():
            try:
                channel.await_ack(rt.store, ack_base, 0, stop,
                                  timeout_s=5.0)
            except Exception:
                pass  # timeout/stop ends the fixture thread

        t = threading.Thread(target=park, name="credit-park", daemon=True)
        t.start()
        deadline = time.time() + 3
        kind = None
        while time.time() < deadline and kind is None:
            snap = stacks.capture(include_stacks=False)
            for th in snap["threads"]:
                if th.get("name") == "credit-park" and th.get("wait"):
                    kind = th["wait"]["kind"]
            time.sleep(0.02)
        assert kind == "channel_credit"
        channel.signal_stop(rt.store, stop)
        t.join(timeout=5)
    finally:
        ray.shutdown()


# ------------------------------------------------------------------ #
# cluster stack collection (protocol v6)
# ------------------------------------------------------------------ #

def test_stack_pull_returns_while_executor_blocked(stall_ray):
    """The whole point: a stack dump succeeds while the target's ONLY
    executor thread is provably parked (blocking ray.get on a ref that
    never seals), because the reply rides the worker's recv thread."""
    ray = stall_ray
    from ray_tpu_torch import state

    @ray.remote
    def producer_never():
        time.sleep(120)

    never_ref = producer_never.remote()

    @ray.remote
    def blocked_get(boxed):
        # the ref rides inside a list so the scheduler dispatches us
        # without waiting for it; the get parks the executor thread
        return ray.get(boxed[0])

    blocked_get.remote([never_ref])
    # wait until the getter is actually running then parked
    deadline = time.time() + 15
    parked = None
    while time.time() < deadline and parked is None:
        rep = state.stack_report(timeout_s=3.0)
        for p in rep["procs"]:
            for th in p.get("threads", ()):
                w = th.get("wait")
                if w and th.get("task", "").startswith("blocked_get"):
                    parked = (p, th)
        if parked is None:
            time.sleep(0.2)
    assert parked is not None, "blocked executor never surfaced"
    proc, th = parked
    assert proc["proc"].startswith("worker:")
    assert th["wait"]["kind"] in ("object_get", "object_wait")
    # annotation resolves the waited object to its producing task
    assert "producer_never" in th["wait"].get("target", "")
    # the executor thread's stack reaches the user get site
    assert any(fr[2] == "blocked_get" for fr in th["stack"])
    assert not rep["unresponsive"]


def test_stack_report_covers_head_workers_and_driver_rpc(stall_ray):
    """stack_report includes the head and every connected worker; the
    same report is reachable over the worker->head RPC (the remote
    driver path uses exactly this)."""
    ray = stall_ray
    from ray_tpu_torch import state

    @ray.remote
    def probe():
        from ray_tpu_torch import state as wstate
        rep = wstate.stack_report()
        return sorted(p["proc"] for p in rep["procs"])

    procs = ray.get(probe.remote(), timeout=60)
    assert "head" in procs
    assert any(p.startswith("worker:") for p in procs)
    # head-local view agrees
    rep = state.stack_report()
    names = [p["proc"] for p in rep["procs"]]
    assert "head" in names and any(n.startswith("worker:") for n in names)
    # every thread row is shaped for the dashboard/CLI formatters
    from ray_tpu_torch.core import stacks
    text = stacks.format_report(rep, show_all=True)
    assert "=== head" in text


# ------------------------------------------------------------------ #
# stuck-task watchdog
# ------------------------------------------------------------------ #

def test_watchdog_flags_wedged_task_with_stack(stall_ray):
    ray = stall_ray
    from ray_tpu_torch import state

    @ray.remote
    def wedge():
        time.sleep(120)  # far past the 1s floor

    wedge.remote()
    deadline = time.time() + 20
    hang = {"stuck_tasks": []}
    while time.time() < deadline and not hang["stuck_tasks"]:
        hang = state.hang_report(timeout_s=2.0)
        time.sleep(0.2)
    assert hang["stuck_tasks"], "watchdog never flagged the wedge"
    rec = next(r for r in hang["stuck_tasks"] if r["name"] == "wedge")
    assert rec["state"] == "RUNNING" and rec["worker"]
    assert rec["running_s"] >= 1.0
    assert rec["threshold_s"] >= 1.0
    # the owning worker's live stack is attached and shows the sleep
    assert rec.get("stack"), "no stack attached to the stuck record"
    frames = [fr for th in rec["stack"] for fr in th.get("stack", ())]
    assert any(fr[2] == "wedge" for fr in frames)
    # watchdog health is in the summary and counts the flag
    wd = state.summary()["watchdog"]
    assert wd["enabled"] and wd["flagged_total"] >= 1
    assert wd["stuck_running"] >= 1
    # metrics emitted under the core namespace
    from ray_tpu_torch.util.metrics import collect_store
    store = collect_store()
    total = sum(store.get("rtpu_core_stuck_tasks_total",
                          {"series": {}})["series"].values())
    assert total >= 1
    # the task record itself carries the stuck flag (task detail view)
    tasks = state.list_tasks(filters={"name": "wedge"})
    assert tasks and tasks[0].get("stuck")


def test_watchdog_ewma_flags_outlier_of_fast_task(stall_ray):
    """A task name with history is flagged at multiple*EWMA even though
    its runtime is near the absolute floor: the EWMA path, not just the
    floor, must trigger."""
    ray = stall_ray
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.config import cfg
    cfg.override(stuck_task_multiple=50.0)
    try:
        @ray.remote
        def sometimes_slow(t):
            time.sleep(t)
            return t

        # history: ~20ms typical
        ray.get([sometimes_slow.remote(0.02) for _ in range(5)],
                timeout=60)
        rt = rt_mod.get_runtime_if_exists()
        with rt.lock:
            ewma = rt._task_ewma.get("sometimes_slow")
        assert ewma is not None and ewma < 0.5
        # the outlier: runs way past 50*ewma (~1s) and past the 1s floor
        sometimes_slow.remote(120.0)
        from ray_tpu_torch import state
        deadline = time.time() + 20
        stuck = []
        while time.time() < deadline and not stuck:
            hang = state.hang_report(timeout_s=2.0)
            stuck = [r for r in hang["stuck_tasks"]
                     if r["name"] == "sometimes_slow"]
            time.sleep(0.2)
        assert stuck, "EWMA outlier never flagged"
        assert stuck[0].get("ewma_s") is not None
    finally:
        cfg.reset("stuck_task_multiple")


# ------------------------------------------------------------------ #
# wait-graph deadlock detection
# ------------------------------------------------------------------ #

def test_two_channel_wait_cycle_reported(stall_ray):
    """The constructed deadlock: two parties each read the other's
    channel before writing their own. hang_report must name both."""
    ray = stall_ray
    from ray_tpu_torch import state
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.dag import channel
    rt = rt_mod.get_runtime_if_exists()
    stop = ObjectID.from_random()
    b1, b2 = os.urandom(16), os.urandom(16)

    def party(my_base, other_base):
        w = channel.RingWriter(rt.store, my_base, stop, ring=4)
        r = channel.RingReader(rt.store, other_base, stop, ring=4)
        try:
            w.write(r.read(timeout_s=60))
        except Exception:
            pass  # stop-flag teardown ends the fixture thread

    ta = threading.Thread(target=party, args=(b1, b2), name="party-A",
                          daemon=True)
    tb = threading.Thread(target=party, args=(b2, b1), name="party-B",
                          daemon=True)
    ta.start()
    tb.start()
    try:
        deadline = time.time() + 15
        cycles = []
        while time.time() < deadline and not cycles:
            hang = state.hang_report(timeout_s=2.0)
            cycles = hang["deadlocks"]
            time.sleep(0.2)
        assert cycles, "two-channel cycle never reported"
        parties = cycles[0]["parties"]
        names = {p["thread_name"] for p in parties}
        assert {"party-A", "party-B"} <= names
        # each party names the channel it waits on and who produces it
        for p in parties:
            assert p["wait_kind"] == "channel_recv"
            assert "channel" in p["target"]
        from ray_tpu_torch.core import stacks
        text = stacks.format_hangs(hang)
        assert "SUSPECTED DEADLOCKS" in text
        assert "party-A" in text and "party-B" in text
    finally:
        channel.signal_stop(rt.store, stop)
        ta.join(timeout=10)
        tb.join(timeout=10)


def test_no_false_deadlock_on_healthy_pipeline(stall_ray):
    """A producer/consumer pair making progress (and a consumer merely
    waiting on a live producer) is NOT a cycle."""
    ray = stall_ray
    from ray_tpu_torch import state
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.dag import channel
    rt = rt_mod.get_runtime_if_exists()
    stop = ObjectID.from_random()
    base = os.urandom(16)
    w = channel.RingWriter(rt.store, base, stop, ring=4)
    got = []

    def consume():
        r = channel.RingReader(rt.store, base, stop, ring=4)
        try:
            while True:
                got.append(r.read(timeout_s=30))
        except Exception:
            pass  # stop ends the consumer

    t = threading.Thread(target=consume, name="healthy-consumer",
                         daemon=True)
    t.start()
    try:
        for i in range(3):
            w.write(i)
        # gate on OBSERVED completion, not a wall-clock margin (the
        # test_wait precedent): under concurrent suite load the
        # consumer may take arbitrarily long to drain three items, and
        # a fixed sleep flaked exactly once that way. The deadline is a
        # failure bound, never the pass condition.
        deadline = time.time() + 30
        while time.time() < deadline and len(got) < 3:
            time.sleep(0.02)
        assert got == [0, 1, 2]
        hang = state.hang_report(timeout_s=2.0)
        assert hang["deadlocks"] == []
    finally:
        channel.signal_stop(rt.store, stop)
        t.join(timeout=10)


# ------------------------------------------------------------------ #
# protocol / surfacing
# ------------------------------------------------------------------ #

def test_stack_dump_frame_roundtrip_shape():
    """dump_reply answers a stack_dump frame with this process's
    capture under the pinned v6 frame names."""
    from ray_tpu_torch.core import stacks
    reply = stacks.dump_reply({"t": "stack_dump", "nonce": b"n1"})
    assert reply["t"] == "stack_reply" and reply["nonce"] == b"n1"
    snap = reply["snap"]
    assert snap["pid"] == os.getpid()
    assert any(t.get("stack") for t in snap["threads"])
    lite = stacks.dump_reply({"t": "stack_dump", "nonce": b"n2",
                              "no_stacks": True})
    assert all("stack" not in t for t in lite["snap"]["threads"])
