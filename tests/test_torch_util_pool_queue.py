"""ActorPool + distributed Queue tests (reference: util/actor_pool.py,
util/queue.py).

The port's copy of ``tests/test_util_pool_queue.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

``ActorPool`` comes from ``ray_tpu_torch.util`` as users import it, and
``Queue`` from ``ray_tpu_torch.util.queue``. Every case is marked
``slow``, as in the reference.
"""
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


# utility-surface pool/queue tests — seconds each, not tier-1 core
pytestmark = pytest.mark.slow


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


def _workers(ray, n=2):
    @ray.remote
    class W:
        def __init__(self):
            import os
            self.pid = os.getpid()

        def double(self, x):
            return x * 2

        def whoami(self, _):
            return self.pid

    return [W.remote() for _ in range(n)]


def test_actor_pool_map_ordered(ray):
    pool = ActorPool(_workers(ray))
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [v * 2 for v in range(8)]


def test_actor_pool_map_unordered_and_balance(ray):
    pool = ActorPool(_workers(ray, 2))
    pids = set(pool.map_unordered(lambda a, v: a.whoami.remote(v),
                                  range(8)))
    assert len(pids) == 2  # both actors did work


def test_actor_pool_submit_get_next(ray):
    pool = ActorPool(_workers(ray, 2))
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    pool.submit(lambda a, v: a.double.remote(v), 30)  # queues (2 actors)
    assert pool.get_next(timeout=60) == 20
    assert pool.get_next(timeout=60) == 40
    assert pool.get_next(timeout=60) == 60
    assert not pool.has_next()


def test_queue_fifo_and_cross_task(ray):
    q = Queue(maxsize=8)
    for i in range(4):
        q.put(i)
    assert q.qsize() == 4

    @ray.remote
    def consume(q):
        return [q.get(timeout=30) for _ in range(4)]

    assert ray.get(consume.remote(q), timeout=60) == [0, 1, 2, 3]
    assert q.empty()
    q.shutdown()


def test_queue_full_empty_semantics(ray):
    q = Queue(maxsize=1)
    q.put("a")
    with pytest.raises(Full):
        q.put("b", block=False)
    with pytest.raises(Full):
        q.put("b", timeout=0.2)
    assert q.get() == "a"
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_queue_producer_consumer(ray):
    q = Queue(maxsize=4)   # backpressure

    @ray.remote
    def producer(q, n):
        for i in range(n):
            q.put(i, timeout=30)
        q.put(None, timeout=30)
        return "done"

    @ray.remote
    def consumer(q):
        out = []
        while True:
            item = q.get(timeout=30)
            if item is None:
                return out
            out.append(item)

    p = producer.remote(q, 10)
    c = consumer.remote(q)
    assert ray.get(c, timeout=120) == list(range(10))
    assert ray.get(p, timeout=60) == "done"
    q.shutdown()
