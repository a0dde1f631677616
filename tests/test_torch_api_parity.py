"""Core API parity: namespaces, max_calls worker retirement,
max_pending_calls backpressure (reference: ray.init(namespace=),
@ray.remote(max_calls=), actor max_pending_calls /
PendingCallsLimitExceeded).

The port's copy of ``tests/test_api_parity.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


def test_named_actor_namespace_isolation(ray):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    a = Counter.options(name="ctr", namespace="nsA").remote()
    assert ray_tpu_torch.get(a.incr.remote()) == 1
    # visible in its own namespace…
    h = ray_tpu_torch.get_actor("ctr", namespace="nsA")
    assert ray_tpu_torch.get(h.incr.remote()) == 2
    # …not in another
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("ctr", namespace="nsB")
    # same short name coexists in a different namespace
    b = Counter.options(name="ctr", namespace="nsB").remote()
    assert ray_tpu_torch.get(b.incr.remote()) == 1
    # default namespace lookup (driver default = "default") misses both
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("ctr")


def test_max_calls_retires_worker(ray):
    @ray_tpu_torch.remote(max_calls=3, max_retries=3)
    def whoami():
        import os
        return os.getpid()

    pids = ray_tpu_torch.get([whoami.remote() for _ in range(9)], timeout=120)
    # 9 executions at 3 calls/worker-life => at least 3 distinct pids
    assert len(set(pids)) >= 3, pids
    # the cluster still works afterwards (pool respawned workers)
    @ray_tpu_torch.remote
    def nop():
        return "ok"
    assert ray_tpu_torch.get(nop.remote(), timeout=60) == "ok"


@pytest.mark.slow
def test_max_pending_calls_backpressure(ray):
    @ray_tpu_torch.remote
    class Slow:
        def work(self):
            time.sleep(0.4)
            return "done"

    a = Slow.options(max_pending_calls=2).remote()
    # consumed-and-DROPPED result refs must not count as pending forever
    # (the freed oid would be indistinguishable from a running call if
    # the handle didn't hold the result refs itself)
    ray_tpu_torch.get(a.work.remote(), timeout=60)
    r1 = a.work.remote()
    r2 = a.work.remote()
    with pytest.raises(exc.PendingCallsLimitExceeded):
        a.work.remote()
    # once results land, the handle admits again
    assert ray_tpu_torch.get([r1, r2], timeout=60) == ["done", "done"]
    r3 = a.work.remote()
    assert ray_tpu_torch.get(r3, timeout=60) == "done"


def test_in_task_namespace_resolution(ray):
    """Tasks resolve named actors in the SUBMITTING driver's namespace,
    and an actor's methods resolve in its CREATING job's namespace —
    not in the worker host's default (reference: runtime-context
    namespace inheritance)."""
    import ray_tpu_torch.core.runtime as rt_mod

    @ray_tpu_torch.remote
    class Named:
        def who(self):
            return "me"

    Named.options(name="tgt", namespace="nsX").remote()

    # pretend this driver runs in nsX: tasks it submits must inherit it
    rt = rt_mod.get_runtime_if_exists()
    old = getattr(rt, "namespace", "default")
    rt.namespace = "nsX"
    try:
        @ray_tpu_torch.remote
        def find():
            h = ray_tpu_torch.get_actor("tgt")       # no explicit namespace
            return ray_tpu_torch.get(h.who.remote(), timeout=60)

        assert ray_tpu_torch.get(find.remote(), timeout=120) == "me"

        @ray_tpu_torch.remote
        class Finder:
            async def afind(self):
                h = ray_tpu_torch.get_actor("tgt")   # async path: contextvar
                return ray_tpu_torch.get(h.who.remote(), timeout=60)

        f = Finder.remote()
        assert ray_tpu_torch.get(f.afind.remote(), timeout=120) == "me"
    finally:
        rt.namespace = old


@pytest.mark.slow  # 8s tier-1 rebalance: max_pending_calls admission/backpressure semantics stay covered by test_max_pending_calls_backpressure above; this adds only the errors-count-as-settled prune rule
def test_max_pending_calls_prunes_failed_results(ray):
    """Errored calls are not in flight: a handle whose every call raised
    must admit new calls (FAILED counts as settled in the prune —
    locate_many's 'errors count as ready' rule)."""
    @ray_tpu_torch.remote
    class Boom:
        def go(self, ok=False):
            if not ok:
                raise ValueError("nope")
            return "fine"

    a = Boom.options(max_pending_calls=2).remote()
    refs = [a.go.remote(), a.go.remote()]
    for r in refs:
        with pytest.raises(ValueError):
            ray_tpu_torch.get(r, timeout=60)
    # both settled (as errors): the handle must admit again
    assert ray_tpu_torch.get(a.go.remote(True), timeout=60) == "fine"
