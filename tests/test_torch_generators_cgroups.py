"""Dynamic generator tasks + actor concurrency groups
(reference: num_returns='dynamic' generators; concurrency_group_manager.h).

The port's copy of ``tests/test_generators_cgroups.py``, with its
imports pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.
"""
import time

import pytest

import ray_tpu_torch


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


def test_dynamic_generator_task(ray):
    @ray.remote(num_returns="dynamic")
    def gen(n):
        for i in range(n):
            yield i * i

    refs = ray.get(gen.remote(5), timeout=60)
    assert len(refs) == 5
    assert ray.get(refs, timeout=60) == [0, 1, 4, 9, 16]


def test_dynamic_generator_refs_survive_outer(ray):
    """Items stay alive through the outer list's containment edges."""
    @ray.remote(num_returns="dynamic")
    def gen():
        yield {"big": list(range(10_000))}
        yield {"big": list(range(10_000, 20_000))}

    refs = ray.get(gen.remote(), timeout=60)
    time.sleep(0.5)
    assert ray.get(refs[1], timeout=60)["big"][0] == 10_000


def test_dynamic_generator_local_mode():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        @ray_tpu_torch.remote(num_returns="dynamic")
        def gen():
            yield "a"
            yield "b"

        refs = ray_tpu_torch.get(gen.remote())
        assert [ray_tpu_torch.get(r) for r in refs] == ["a", "b"]
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_concurrency_groups_isolate(ray):
    """A long call in one group must not block another group."""
    @ray.remote(max_concurrency=1)
    class Service:
        def __init__(self):
            self.events = []

        def slow(self):
            time.sleep(8.0)
            return "slow-done"

        def ping(self):
            return "pong"

    svc = Service.options(
        concurrency_groups={"background": 1, "health": 1}).remote()
    # warm the actor so ping latency below measures queueing, not spawn
    assert ray.get(svc.ping.remote(), timeout=60) == "pong"
    slow_ref = svc.slow.options(concurrency_group="background").remote()
    out = ray.get(svc.ping.options(concurrency_group="health").remote(),
                  timeout=60)
    assert out == "pong"
    # the isolation property, load-robust: ping returned while the
    # background call was still sleeping (a serialized actor could not
    # answer until slow finished) — not a wall-clock budget, which flakes
    # under full-suite load on a 1-core box
    ready, _ = ray.wait([slow_ref], timeout=0)
    assert not ready, "ping only returned after the background call ended"
    assert ray.get(slow_ref, timeout=60) == "slow-done"


def test_default_group_still_serial(ray):
    @ray.remote
    class Ordered:
        def __init__(self):
            self.log = []

        def add(self, x):
            self.log.append(x)
            return list(self.log)

    o = Ordered.remote()
    outs = [o.add.remote(i) for i in range(5)]
    assert ray.get(outs[-1], timeout=60) == [0, 1, 2, 3, 4]


def test_dynamic_items_reconstruct_after_eviction(ray):
    """Deterministic item ids + lineage: an evicted yielded item comes
    back via re-execution and the ORIGINAL ref still resolves."""
    from ray_tpu_torch.core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()

    @ray.remote(num_returns="dynamic", max_retries=2)
    def gen():
        for i in range(3):
            yield {"i": i, "pad": list(range(2000))}

    refs = ray.get(gen.remote(), timeout=60)
    assert ray.get(refs[2], timeout=60)["i"] == 2
    rt.store.delete(refs[2].id())          # simulate eviction
    got = ray.get(refs[2], timeout=120)    # reconstructed, same id
    assert got["i"] == 2


def test_async_method_rejects_concurrency_group(ray):
    @ray.remote
    class Aio:
        async def coro(self):
            return 1

    a = Aio.options(concurrency_groups={"g": 2}).remote()
    import pytest as _pytest
    with _pytest.raises(Exception, match="sync methods"):
        ray.get(a.coro.options(concurrency_group="g").remote(), timeout=60)
    # async WITHOUT a group still works
    assert ray.get(a.coro.remote(), timeout=60) == 1
