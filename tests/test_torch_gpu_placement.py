"""GPU placement in the port's runtime, on fake GPUs.

``init(num_cpus=2, num_gpus=2)`` declares two device indices; nothing
here touches CUDA (the CPU box has none): a worker's lease is what it
reads in ``CUDA_VISIBLE_DEVICES``. Each worker sees exactly its leased
indices, every worker without a lease sees "", an index comes back
when its worker dies (by ``kill`` or by a SIGKILL from outside), an idle
one-GPU worker is reaped, never reused, for a two-GPU spec, and the
"GPU" counts of ``available_resources()`` follow each step. A request no
node can meet behaves as the reference's "TPU" request does."""
import os
import signal
import sys
import time

import pytest

import ray_tpu_torch as ray


@pytest.fixture
def gpus2():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, num_gpus=2, object_store_memory=64 * 1024 * 1024)
    yield ray
    ray.shutdown()


def _gpu_avail(rt, want: float, timeout: float = 30.0) -> float:
    """available_resources()["GPU"] once it reads `want` (the lease is
    released a tick after the result seals), or its last reading."""
    deadline = time.monotonic() + timeout
    while True:
        got = rt.available_resources().get("GPU", 0.0)
        if got == want or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _head():
    from ray_tpu_torch.core import runtime
    return runtime.get_runtime_if_exists()


def test_actors_tasks_and_leases(gpus2):
    rt = gpus2

    @rt.remote(num_gpus=1)
    class Dev:
        def visible(self):
            return os.environ["CUDA_VISIBLE_DEVICES"]

        def pid(self):
            return os.getpid()

    @rt.remote
    def cpu_task():
        import sys as _sys
        banned = sorted(m for m in _sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
        return os.environ["CUDA_VISIBLE_DEVICES"], banned

    assert rt.cluster_resources()["GPU"] == 2.0
    assert _gpu_avail(rt, 2.0) == 2.0
    a, b = Dev.remote(), Dev.remote()
    assert sorted(rt.get([a.visible.remote(), b.visible.remote()],
                         timeout=60)) == ["0", "1"]
    assert _gpu_avail(rt, 0.0) == 0.0
    # a CPU task sees no device and loads neither jax nor the reference
    assert rt.get(cpu_task.remote(), timeout=60) == ("", [])

    # a third one-GPU actor waits for an index
    c = Dev.remote()
    pending = c.visible.remote()
    ready, _ = rt.wait([pending], timeout=2.0)
    assert ready == []
    a_idx = rt.get(a.visible.remote(), timeout=60)
    rt.kill(a)
    assert rt.get(pending, timeout=60) == a_idx     # the freed index
    assert _gpu_avail(rt, 0.0) == 0.0

    # SIGKILL from outside: the watch thread's death path frees the index
    os.kill(rt.get(b.pid.remote(), timeout=60), signal.SIGKILL)
    assert _gpu_avail(rt, 1.0) == 1.0
    rt.kill(c)
    assert _gpu_avail(rt, 2.0) == 2.0
    head = _head()
    assert sorted(head.head_node.gpu_free) == [0, 1]


def test_idle_gpu_worker_is_reaped_not_reused_for_two(gpus2):
    rt = gpus2

    @rt.remote(num_gpus=1)
    def one():
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    @rt.remote(num_gpus=2)
    def two():
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    idx, pid1 = rt.get(one.remote(), timeout=60)
    assert idx in ("0", "1")
    assert _gpu_avail(rt, 2.0) == 2.0
    # the idle one-GPU worker is reused by a one-GPU spec ...
    assert rt.get(one.remote(), timeout=60) == (idx, pid1)
    assert _gpu_avail(rt, 2.0) == 2.0
    head = _head()
    with head.lock:
        idle = [w for w in head.workers.values() if w.gpus]
    assert [w.proc.pid for w in idle] == [pid1]
    # ... but a two-GPU spec gets a new process: the idle one is reaped
    # so that its index can be leased again
    vis, pid2 = rt.get(two.remote(), timeout=60)
    assert vis == "0,1" and pid2 != pid1
    with head.lock:
        assert head.workers[idle[0].wid].state == "dead"
    assert _gpu_avail(rt, 2.0) == 2.0
    # and the next one-GPU spec reaps the idle two-GPU worker in turn
    idx3, pid3 = rt.get(one.remote(), timeout=60)
    assert idx3 in ("0", "1") and pid3 not in (pid1, pid2)


def test_a_gpu_task_blocked_in_get_keeps_its_gpu(gpus2):
    """A worker blocked in get gives back its CPU (the reference's rule)
    but not its GPU: the index stays leased to its process, so the
    count must stay held until the task is done."""
    rt = gpus2

    @rt.remote
    def child():
        time.sleep(2.0)
        return 1

    @rt.remote(num_gpus=1)
    def parent():
        return ray.get(child.remote()) + 1

    ref = parent.remote()
    seen = set()
    while not rt.wait([ref], timeout=0.05)[0]:
        seen.add(rt.available_resources()["GPU"])
    assert rt.get(ref, timeout=60) == 2
    assert seen and max(seen) <= 1.0, seen
    assert _gpu_avail(rt, 2.0) == 2.0
    assert rt.available_resources()["CPU"] == 2.0


def test_fractional_gpus_raise(gpus2):
    rt = gpus2

    @rt.remote(num_gpus=0.5)
    def half():
        return 1

    with pytest.raises(ValueError, match="whole number"):
        half.remote()
    with pytest.raises(ValueError, match="whole number"):
        rt.remote(num_gpus=1.5)(type("X", (), {})).remote()


def test_gpu_workers_get_a_shadow_sitecustomize():
    from ray_tpu_torch.core.runtime import build_worker_env
    kw = dict(store_path="/dev/shm/x", head_addr="a", authkey_hex="00",
              wid="w", node_id_hex="00")
    boot = os.path.join(os.path.dirname(sys.modules[
        "ray_tpu_torch.core.runtime"].__file__), "_worker_boot")
    for gpus, vis in (((), ""), ((1,), "1"), ((0, 3), "0,3")):
        env = build_worker_env(gpus=gpus, **kw)
        assert env["CUDA_VISIBLE_DEVICES"] == vis
        assert env["PYTHONPATH"].split(os.pathsep)[0] == boot


def _unmet(pkg, opt: str) -> list:
    """What a user meets when a task and an actor ask for more of the
    accelerator than the cluster has."""
    from importlib import import_module
    cfg = import_module(pkg.__name__ + ".core.config").cfg
    cfg.override(pg_retry_timeout_s=1.0)
    pkg.init(num_cpus=1, **{opt: 2})
    try:
        @pkg.remote(**{opt: 4})
        def big():
            return 1

        @pkg.remote(**{opt: 4})
        class Big:
            def m(self):
                return 1

        seen = []
        try:
            pkg.get(big.remote(), timeout=1.0)
        except Exception as e:      # noqa: BLE001 — the class is the result
            seen.append(type(e).__name__)
        try:
            pkg.get(Big.remote().m.remote(), timeout=30)
        except Exception as e:      # noqa: BLE001
            seen.append(type(e).__name__)
        seen.append({k: v for k, v in pkg.available_resources().items()
                     if k in ("TPU", "GPU")})
        return seen
    finally:
        pkg.shutdown()
        cfg.reset("pg_retry_timeout_s")


def test_unmeetable_request_behaves_as_the_reference_tpu_request():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()
    ref = _unmet(ray_tpu, "num_tpus")
    port = _unmet(ray, "num_gpus")
    assert ref == ["GetTimeoutError", "ActorDiedError", {"TPU": 2.0}]
    assert port == ["GetTimeoutError", "ActorDiedError", {"GPU": 2.0}]
