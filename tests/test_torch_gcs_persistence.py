"""GCS persistence / KV / memory-monitor tests.

Reference parity: gcs/store_client (Redis FT), gcs_kv_manager.h /
internal_kv, common/memory_monitor.h + worker_killing_policy.h.

The port's copy of ``tests/test_gcs_persistence.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

The head-restart scripts run in subprocesses on the port, whose sessions
live under ``$TMPDIR/ray_tpu_torch/``.
"""
import os
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu_torch.core.gcs_store import GcsStore


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kv_store_roundtrip(tmp_path):
    s = GcsStore(str(tmp_path / "kv.sqlite"))
    s.put("ns", "a", b"1")
    s.put("ns", "a", b"2")          # upsert
    s.put("ns2", "a", b"other")
    assert s.get("ns", "a") == b"2"
    assert s.get("ns2", "a") == b"other"
    assert s.get("ns", "missing") is None
    assert s.keys("ns") == ["a"]
    assert s.delete("ns", "a") is True
    assert s.delete("ns", "a") is False
    s.close()
    # durability: reopen from disk
    s2 = GcsStore(str(tmp_path / "kv.sqlite"))
    assert s2.get("ns2", "a") == b"other"
    s2.close()


def test_public_kv_api(ray_start_regular):
    ray = ray_start_regular
    ray.kv_put("cfg/lr", b"0.001")
    assert ray.kv_get("cfg/lr") == b"0.001"
    assert "cfg/lr" in ray.kv_keys()

    @ray.remote
    def read_from_worker():
        import ray_tpu_torch
        ray_tpu_torch.kv_put("from-worker", b"yes")
        return ray_tpu_torch.kv_get("cfg/lr")

    assert ray.get(read_from_worker.remote(), timeout=60) == b"0.001"
    assert ray.kv_get("from-worker") == b"yes"
    assert ray.kv_del("cfg/lr") is True


@pytest.mark.slow  # 20s; restart-path coverage stays via test_head_restart.py's driver-survives-restart (tier-1)
def test_head_restart_restores_state():
    """Named actor + PG + job table survive a head restart (GCS FT)."""
    script1 = textwrap.dedent("""
        import ray_tpu_torch
        info = ray_tpu_torch.init(num_cpus=2)
        print("SESSION", info["session_dir"])

        @ray_tpu_torch.remote
        class Registry:
            def __init__(self, tag="x"):
                self.tag = tag
            def get_tag(self):
                return self.tag

        r = Registry.options(name="the-registry").remote("persisted!")
        assert ray_tpu_torch.get(r.get_tag.remote(), timeout=60) == "persisted!"
        from ray_tpu_torch.util.placement_group import placement_group
        pg = placement_group([{"CPU": 1}], strategy="PACK", name="the-pg")
        assert pg.wait(30)
        ray_tpu_torch.kv_put("durable-key", b"durable-value")
        ray_tpu_torch.shutdown()   # final snapshot happens here
        print("FIRST_OK")
    """)
    r = subprocess.run([sys.executable, "-c", script1], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "FIRST_OK" in r.stdout
    session_dir = [ln.split()[1] for ln in r.stdout.splitlines()
                   if ln.startswith("SESSION")][0]

    script2 = textwrap.dedent("""
        import ray_tpu_torch
        info = ray_tpu_torch.init(num_cpus=2, resume_from=%r)
        assert info["restored"]["actors"] == 1, info
        assert info["restored"]["placement_groups"] == 1, info
        a = ray_tpu_torch.get_actor("the-registry")
        assert ray_tpu_torch.get(a.get_tag.remote(), timeout=60) == "persisted!"
        # durable KV carries over
        assert ray_tpu_torch.kv_get("durable-key") == b"durable-value"
        ray_tpu_torch.shutdown()
        print("SECOND_OK")
    """) % (session_dir,)
    r = subprocess.run([sys.executable, "-c", script2], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "SECOND_OK" in r.stdout


def test_memory_monitor_policy():
    from ray_tpu_torch.core.memory_monitor import pick_victim

    class W:
        def __init__(self, state, retries=0, name="t"):
            self.state = state
            if state == "busy":
                class Spec:
                    pass
                self.current = Spec()
                self.current.retries_left = retries
                self.current.name = name
            else:
                self.current = None

    assert pick_victim([W("idle"), W("actor")]) is None
    ws = [W("busy", retries=0, name="old"),
          W("busy", retries=2, name="retriable-old"),
          W("busy", retries=1, name="retriable-new"),
          W("busy", retries=0, name="new")]
    v = pick_victim(ws)
    assert v.current.name == "retriable-new"   # newest retriable
    ws2 = [W("busy", retries=0, name="a"), W("busy", retries=0, name="b")]
    assert pick_victim(ws2).current.name == "b"  # newest busy fallback


@pytest.mark.slow
def test_memory_monitor_kills_and_task_retries(ray_start_regular):
    ray = ray_start_regular
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.memory_monitor import MemoryMonitor
    rt = rt_mod.get_runtime_if_exists()

    @ray.remote(max_retries=2, retry_exceptions=False)
    def slowish():
        import time as t
        t.sleep(2.0)
        return "done"

    ref = slowish.remote()
    deadline = time.time() + 30  # wait for dispatch (1-core box is slow)
    while time.time() < deadline:
        with rt.lock:
            if any(w.state == "busy" and w.current is not None
                   for w in rt.workers.values()):
                break
        time.sleep(0.1)
    mon = MemoryMonitor(rt, threshold=0.0, period_s=0,
                        usage_fn=lambda: 1.0)  # always over budget
    assert mon.tick() is True  # killed the worker
    # the retriable task must still complete via the crash-retry path
    assert ray.get(ref, timeout=120) == "done"
    assert mon.kills == 1


def test_v1_snapshot_named_actor_migrates_to_default_namespace(tmp_path):
    """Snapshots written before namespace qualification stored bare
    actor names; restore must qualify them into 'default/' so
    get_actor('x') (which qualifies its lookup) still finds every
    restored actor (protocol.SNAPSHOT_SCHEMA_VERSION v2 note)."""
    import cloudpickle
    import pickle

    import ray_tpu_torch
    from ray_tpu_torch.core.gcs_store import restore
    from ray_tpu_torch.core.ids import ActorID, ObjectID
    from ray_tpu_torch.core.task_spec import ActorSpec

    class Legacy:
        def ping(self):
            return "pong"

    blob = cloudpickle.dumps(Legacy)
    spec = ActorSpec(
        actor_id=ActorID.from_random(), class_id="cls_legacy",
        name="Legacy", args_blob=cloudpickle.dumps(((), {})),
        dep_oids=[], resources={}, named="survivor",   # v1: unqualified
        ready_oid=ObjectID.from_random())
    sdir = tmp_path / "old_session"
    sdir.mkdir()
    s = GcsStore(str(sdir / "gcs.sqlite"))
    s.put("snapshot", "named_actors",
          pickle.dumps([("survivor", spec, blob)]))
    s.put("snapshot", "meta", pickle.dumps({"schema_version": 1}))
    s.close()

    ray_tpu_torch.init(num_cpus=1, resume_from=str(sdir))
    try:
        h = ray_tpu_torch.get_actor("survivor")       # default-namespace lookup
        assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
    finally:
        ray_tpu_torch.shutdown()
