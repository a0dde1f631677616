"""The port's state API (``ray_tpu_torch.state``) and the head's state
rpcs.

The cases of ``tests/test_state.py`` run on the port with the
reference's assertions: the task lifecycle, the actor, object, worker
and node lists, the Prometheus endpoint, the event export and
``memory_summary`` and ``iter_torch_batches`` (``slow``, as in the
reference). Then the same calls from a
driver client (a script of its own that attaches with
``init(address=...)`` and loads neither JAX nor the reference) and from
inside a task; ``autoscaler_status`` raising until the autoscaler is
ported; one program under both packages whose row keys (every
``list_*``, ``summary()`` and ``memory_summary()``) must be equal, with
"gpu" in the place of "tpu"; the stall doctor's two-channel wait cycle
(``tests/test_stall_doctor.py``); and a compiled DAG seen through the
state API: its channels counted in ``summary()``, its loops parked on a
channel in ``stack_report()``, and a seal-to-wake flow for every edge in
``timeline(flight=True)``; and ``summary()["data"]``, the streaming data
plane's rollup, after a streaming run.

The remote functions and classes are defined inside the tests, so they
pickle by value: a worker never imports this module."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import agent_env
from ray_tpu_torch.core.config import cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rt():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


# -- the cases of tests/test_state.py ----------------------------------------

def test_list_tasks_lifecycle(rt):
    from ray_tpu_torch import state

    @rt.remote
    def ok():
        return 1

    @rt.remote
    def boom():
        raise ValueError("no")

    rt.get(ok.remote(), timeout=60)
    with pytest.raises(ValueError):
        rt.get(boom.remote(), timeout=60)

    # get() can observe the stored result before the worker's `done`
    # message lands; poll briefly for the terminal records
    by_name = {}
    deadline = time.time() + 10
    while time.time() < deadline:
        by_name = {}
        for t in state.list_tasks():
            by_name.setdefault(t["name"], t)
        if (by_name.get("ok", {}).get("state") == "FINISHED"
                and by_name.get("boom", {}).get("state") == "FAILED"):
            break
        time.sleep(0.05)
    assert by_name["ok"]["state"] == "FINISHED"
    assert by_name["ok"]["duration_s"] is not None
    assert by_name["boom"]["state"] == "FAILED"
    assert "ValueError" in by_name["boom"]["error"]
    # filters
    failed = state.list_tasks(filters={"state": "FAILED"})
    assert failed and all(t["state"] == "FAILED" for t in failed)


def test_list_actors_objects_workers_nodes(rt):
    from ray_tpu_torch import state

    @rt.remote
    class Keeper:
        def get(self):
            return 7

    k = Keeper.options(name="keeper").remote()
    assert rt.get(k.get.remote(), timeout=60) == 7
    ref = rt.put({"v": 1})

    actors = state.list_actors()
    assert any(a["name"] == "keeper" and a["state"] == "ALIVE"
               for a in actors)
    objs = state.list_objects()
    assert any(o["object_id"] == ref.id().hex() and o["in_store"]
               for o in objs)
    assert any(w["state"] == "actor" for w in state.list_workers())
    assert any(n["Alive"] for n in state.list_nodes())

    s = state.summary()
    assert s["tasks"]["tasks_submitted"] >= 1
    assert s["actors"] >= 1
    assert s["object_store"]["bytes_in_use"] > 0


def test_prometheus_endpoint_scrapeable(rt):
    from ray_tpu_torch import state

    @rt.remote
    def tick():
        return None

    rt.get([tick.remote() for _ in range(3)], timeout=60)
    port = state.start_metrics_server()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "ray_tpu_tasks_submitted_total" in body
        assert "ray_tpu_object_store_capacity_bytes" in body
        assert 'ray_tpu_workers{state="idle"}' in body
        # counters hold plausible values
        for line in body.splitlines():
            if line.startswith("ray_tpu_tasks_submitted_total"):
                assert float(line.split()[-1]) >= 3
    finally:
        state.stop_metrics_server()


def test_event_export_jsonl():
    """RTPU_EVENT_EXPORT_ENABLED writes task events to the session dir."""
    script = textwrap.dedent("""
        import ray_tpu_torch
        info = ray_tpu_torch.init(num_cpus=1)
        print("SESSION", info["session_dir"])

        @ray_tpu_torch.remote
        def tick(i):
            return i

        assert ray_tpu_torch.get([tick.remote(i) for i in range(3)],
                                 timeout=60) == [0, 1, 2]
        ray_tpu_torch.shutdown()
    """)
    env = dict(os.environ)
    env["RTPU_EVENT_EXPORT_ENABLED"] = "1"
    env["RTPU_WORKER_PRESTART"] = "0"
    r = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    session = [ln.split()[1] for ln in r.stdout.splitlines()
               if ln.startswith("SESSION")][0]
    with open(os.path.join(session, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    states = {e["state"] for e in events if e["name"] == "tick"}
    assert {"PENDING", "RUNNING", "FINISHED"} <= states, states


def test_memory_summary(rt):
    """`ray memory` analog: per-object ref breakdown + store totals
    (reference: scripts.py memory command over internal_api)."""
    from ray_tpu_torch import state

    ref = rt.put(np.zeros(300_000))          # pinned driver put
    small = rt.put(b"x")
    m = state.memory_summary()
    st = m["object_store"]
    assert st["bytes_in_use"] > 0 and st["capacity"] >= st["bytes_in_use"]
    rows = {r["object_id"]: r for r in m["objects"]}
    big = rows[ref.id().hex()]
    assert big["in_store"] and big["num_refs"] >= 1
    assert "driver" in big["ref_holders"]
    assert rows[small.id().hex()]["state"] == "READY"
    # pinned puts sort first
    assert m["objects"][0]["pinned"]

    # remote (worker rpc) path returns the same shape
    @rt.remote
    def probe():
        from ray_tpu_torch import state as st2
        return st2.memory_summary(limit=10)["object_store"]["num_objects"]

    assert rt.get(probe.remote(), timeout=60) >= 1
    del ref, small


@pytest.mark.slow
def test_iter_torch_batches(rt):
    from ray_tpu_torch import data
    ds = data.range(10)
    batches = list(ds.iter_torch_batches(batch_size=4))
    import torch
    assert all(isinstance(b["id"], torch.Tensor) for b in batches)
    total = torch.cat([b["id"] for b in batches])
    assert sorted(total.tolist()) == list(range(10))


# -- the port's own cases ----------------------------------------------------

def test_summary_holds_the_data_rollup_after_a_streaming_run(rt):
    """``summary()["data"]`` (the reference's ``state.py:208-216``): a
    pipeline forced through the streaming executor shows its blocks and
    its one dispatch per stage worker on the ``chan`` path."""
    from ray_tpu_torch import data, state
    from ray_tpu_torch.data.context import DataContext

    def chan():
        return state.summary().get("data", {}).get("path", {}).get(
            "chan", {"blocks": 0.0, "dispatches": 0.0})

    before = chan()
    ctx = DataContext.get_current()
    saved = ctx.streaming_executor
    ctx.streaming_executor = "force"
    try:
        ds = data.range(40, override_num_blocks=8).map_batches(
            lambda b: {"id": b["id"] + 1})
        assert [r["id"] for r in ds.iter_rows()] == list(range(1, 41))
    finally:
        ctx.streaming_executor = saved
    after = chan()
    assert after["blocks"] - before["blocks"] == 8
    assert 0 < after["dispatches"] - before["dispatches"] <= 2
    assert after["dispatches_per_block"] < 1


def test_state_calls_from_inside_a_task(rt):
    """A worker reaches the head's tables through the state rpcs: the
    same rows the driver reads."""
    @rt.remote
    class Named:
        def ping(self):
            return os.getpid()

    a = Named.options(name="seen-from-task").remote()
    pid = rt.get(a.ping.remote(), timeout=60)

    @rt.remote
    def look():
        from ray_tpu_torch import state as st
        return {"actors": st.list_actors(), "workers": st.list_workers(),
                "nodes": st.list_nodes(), "summary": st.summary(),
                "tasks": st.list_tasks(filters={"name": "Named.ping"}),
                "objects": st.list_objects(limit=5)}

    got = rt.get(look.remote(), timeout=60)
    row = next(r for r in got["actors"] if r["name"] == "seen-from-task")
    assert row["state"] == "ALIVE"
    assert any(w["pid"] == pid and w["actor_id"] == row["actor_id"]
               for w in got["workers"])
    assert got["nodes"][0]["Alive"]
    assert got["summary"]["actors"] >= 1
    assert got["tasks"] and all(t["name"] == "Named.ping"
                                for t in got["tasks"])
    assert len(got["objects"]) <= 5


_CLIENT = textwrap.dedent("""
    import json, sys
    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    rt.init(address=sys.argv[1])
    out = {"actors": state.list_actors(), "workers": state.list_workers(),
           "nodes": state.list_nodes(), "summary": state.summary(),
           "memory": state.memory_summary(limit=5),
           "tasks": state.list_tasks(limit=3),
           "objects": state.list_objects(limit=3),
           "names": state.metrics_names(),
           "timeline_events": len(state.timeline(flight=True)[
               "traceEvents"])}
    try:
        state.autoscaler_status()
        out["autoscaler"] = "answered"
    except NotImplementedError as e:
        out["autoscaler"] = str(e)
    out["banned"] = sorted(
        n for n in sys.modules
        if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))
    rt.shutdown()
    print(json.dumps(out, default=str))
""")


def test_state_calls_from_a_driver_client(rt, tmp_path):
    """A second driver attaches to the head through its cluster file and
    reads the same tables over the state rpcs; it loads neither JAX nor
    the reference package."""
    from ray_tpu_torch.core import runtime as rt_mod

    @rt.remote
    class Named:
        def ping(self):
            return os.getpid()

    a = Named.options(name="seen-from-client").remote()
    pid = rt.get(a.ping.remote(), timeout=60)
    script = tmp_path / "client_state.py"
    script.write_text(_CLIENT)
    out = subprocess.run(
        [sys.executable, str(script),
         rt_mod.get_runtime_if_exists().cluster_file],
        env=agent_env(), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    row = next(r for r in got["actors"] if r["name"] == "seen-from-client")
    assert row["state"] == "ALIVE"
    assert any(w["pid"] == pid for w in got["workers"])
    assert got["nodes"][0]["Alive"]
    assert got["summary"]["actors"] >= 1
    assert got["memory"]["object_store"]["capacity"] > 0
    assert len(got["tasks"]) <= 3 and len(got["objects"]) <= 3
    assert got["timeline_events"] > 0
    assert "ray_tpu_torch/autoscaler/" in got["autoscaler"]
    assert got["banned"] == []


def test_autoscaler_status_raises_until_the_autoscaler_is_ported(rt):
    from ray_tpu_torch import state
    from ray_tpu_torch.core import runtime as rt_mod
    with pytest.raises(NotImplementedError,
                       match="ray_tpu_torch/autoscaler/.*A22"):
        state.autoscaler_status()
    head = rt_mod.get_runtime_if_exists()
    with pytest.raises(NotImplementedError, match="A22"):
        head.autoscaler_status()

    @rt.remote
    def from_worker():
        from ray_tpu_torch import state as st
        try:
            st.autoscaler_status()
        except NotImplementedError as e:
            return type(e).__name__, str(e)
        return "answered", ""

    name, msg = rt.get(from_worker.remote(), timeout=60)
    assert name == "NotImplementedError" and "A22" in msg


def _keys(tree):
    """Every key path of nested dicts (lists: their first element)."""
    out = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                out.add(path + (k,))
                if k not in ("per_process", "states"):
                    walk(v, path + (k,))
        elif isinstance(node, list) and node and isinstance(node[0], dict):
            walk(node[0], path + ("[]",))
    walk(tree, ())
    return sorted(out)


def _state_program(pkg, accel: str) -> dict:
    """One session's state rows under one package: a finished task, a
    named actor on an accelerator lease, a put, a job; returns the key
    paths of every list, summary() and memory_summary()."""
    state = __import__(f"{pkg.__name__}.state", fromlist=["summary"])
    opt = {"TPU": "num_tpus", "GPU": "num_gpus"}[accel]
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024,
             **{opt: 1})
    try:
        @pkg.remote
        def tick():
            return 1

        @pkg.remote(**{opt: 1})
        class Holder:
            def ok(self):
                return True

        h = Holder.options(name="holder").remote()
        pkg.get([tick.remote(), h.ok.remote()], timeout=60)
        ref = pkg.put(np.zeros(1000))
        from importlib import import_module
        rt = import_module(f"{pkg.__name__}.core.runtime") \
            .get_runtime_if_exists()
        job = rt.job_submit(f"{sys.executable} -c pass")
        deadline = time.monotonic() + 60
        while rt.job_status(job)["status"] not in ("SUCCEEDED", "FAILED"):
            assert time.monotonic() < deadline
            time.sleep(0.1)
        time.sleep(0.5)
        rows = {kind: getattr(state, f"list_{kind}")()
                for kind in ("tasks", "actors", "objects", "nodes",
                             "workers", "jobs")}
        out = {kind: _keys(r[0]) for kind, r in rows.items()}
        out["summary"] = _keys(state.summary())
        out["memory_summary"] = _keys(state.memory_summary())
        del ref
    finally:
        pkg.shutdown()
    text = json.dumps(out)
    for name in ("tpu", "gpu", "TPU", "GPU"):
        text = text.replace(name, "ACCEL")
    return {k: sorted(v) for k, v in json.loads(text).items()}


def test_state_rows_match_the_reference_with_gpu_for_tpu():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()
    ref = _state_program(ray_tpu, "TPU")
    port = _state_program(ray, "GPU")
    assert port == ref
    assert ["ACCEL"] in ref["workers"]
    assert ["active_channels"] in ref["summary"]
    assert ["object_store", "num_objects"] in ref["memory_summary"]


# -- the stall doctor on channels ---------------------------------------------

@pytest.fixture
def stall_rt():
    """Cluster with a fast watchdog (1s floor, 0.2s period) so stuck
    flags land within test budgets."""
    if ray.is_initialized():
        ray.shutdown()
    cfg.override(stall_watchdog_period_s=0.2, stuck_task_floor_s=1.0)
    ray.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    yield ray
    ray.shutdown()
    cfg.reset("stall_watchdog_period_s", "stuck_task_floor_s")


def test_two_channel_wait_cycle_reported(stall_rt):
    """The constructed deadlock: two parties each read the other's
    channel before writing their own. hang_report must name both."""
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


# -- a compiled DAG through the state API -------------------------------------

def test_compiled_dag_seen_through_state(rt):
    """While a DAG lives: summary() counts its channels, stack_report()
    shows each stage's loop parked on a channel (channel_recv) in its
    actor's worker, and timeline(flight=True) holds a chan_seal and a
    matching chan_wake for every edge of the last execute. After
    teardown no channel is counted."""
    from ray_tpu_torch import state
    from ray_tpu_torch.core import flight
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    class Stage:
        def __init__(self, scale):
            self.scale = scale

        def step(self, x):
            return x * self.scale

        def pid(self):
            return os.getpid()

    s1, s2 = Stage.remote(2), Stage.remote(3)
    pids = set(rt.get([s1.pid.remote(), s2.pid.remote()], timeout=60))
    with InputNode() as inp:
        out = s2.step.bind(s1.step.bind(inp))
    # channel endpoints this process opened in earlier tests stay counted
    # (the flight recorder's counters are per process)
    before = state.summary()["active_channels"]
    cdag = out.experimental_compile(max_inflight=2)
    try:
        assert cdag.execute(1).get(timeout_s=60) == 6
        assert cdag._n_chans == 3
        assert state.summary()["active_channels"] == before + 3
        time.sleep(0.3)                  # both loops park again
        rep = state.stack_report()
        parked = {p["pid"] for p in rep["procs"]
                  for t in p.get("threads", [])
                  if t.get("wait", {}).get("kind") == "channel_recv"}
        assert pids <= parked, (pids, parked)
        assert cdag.execute(2).get(timeout_s=60) == 12
        events = state.timeline(flight=True)["traceEvents"]
        last = 1
        # this DAG's edges: the driver's ring keeps earlier tests' too
        edges = {flight.lo48(b) for bases in cdag._lands.values()
                 for b in bases}
        assert len(edges) == cdag._n_chans
        ends = {flight.lo48(b) for b, _ in cdag.input_chans}
        ends.add(flight.lo48(cdag.output_chan))
        assert ends <= edges
        for kind in ("chan_seal", "chan_wake"):
            assert {e["args"]["chan"] for e in events
                    if e.get("name") == kind and e["args"]["chan"] in edges
                    and e["args"].get("seq") == last} == edges, kind
    finally:
        cdag.teardown()
    assert state.summary()["active_channels"] == before
