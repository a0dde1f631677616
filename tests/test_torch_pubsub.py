"""Pubsub + Serve long-poll tests (reference: src/ray/pubsub/,
_private/long_poll.py).

The port's copy of ``tests/test_pubsub.py``, with its imports pointed at
``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

``test_serve_longpoll_pushes_scale_change`` drives the port's Serve
controller.
"""
import threading
import time

import pytest

from ray_tpu_torch.core.pubsub import Publisher, Subscriber


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


def test_publisher_cursor_delivery():
    p = Publisher()
    p.publish("c", {"a": 1})
    p.publish("c", {"a": 2})
    r = p.poll("c", cursor=0, timeout_s=0)
    assert [m["a"] for m in r["messages"]] == [1, 2]
    assert not r["gap"]
    r2 = p.poll("c", cursor=r["cursor"], timeout_s=0)
    assert r2["messages"] == []


def test_publisher_blocking_wakeup():
    p = Publisher()
    got = {}

    def waiter():
        got.update(p.poll("c", 0, timeout_s=10))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    p.publish("c", {"x": 42})
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["messages"][0]["x"] == 42


def test_publisher_gap_detection():
    p = Publisher()
    p.RING = 1000
    for i in range(1500):
        p.publish("c", {"i": i})
    r = p.poll("c", cursor=0, timeout_s=0)
    assert r["gap"] is True
    assert len(r["messages"]) == 1000


def test_actor_lifecycle_events(ray_start_regular):
    ray = ray_start_regular
    sub = Subscriber("actors")

    @ray.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    assert ray.get(a.ping.remote(), timeout=60) == 1
    msgs = sub.poll(timeout_s=10)
    assert any(m["state"] == "alive" for m in msgs), msgs
    ray.kill(a)
    deadline = time.time() + 10
    dead = False
    while time.time() < deadline and not dead:
        dead = any(m["state"] == "dead" for m in sub.poll(timeout_s=2))
    assert dead


def test_subscriber_from_worker(ray_start_regular):
    """Workers can subscribe over the RPC channel."""
    ray = ray_start_regular

    @ray.remote
    class Probe:
        def ping(self):
            return "up"

    @ray.remote
    def watch():
        from ray_tpu_torch.core.pubsub import Subscriber
        s = Subscriber("actors")
        return [m["state"] for m in s.poll(timeout_s=5)]

    p = Probe.remote()
    assert ray.get(p.ping.remote(), timeout=60) == "up"
    states = ray.get(watch.remote(), timeout=60)
    assert "alive" in states


def test_serve_longpoll_pushes_scale_change(ray_start_regular):
    """A handle learns about replica changes without TTL polling."""
    ray = ray_start_regular
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1)
    def hello():
        return "hi"

    h = serve.run(hello.bind(), name="lp-app")
    assert h.remote().result(timeout_s=60) == "hi"
    v0 = h._version

    # long-poll on the controller directly: scale up must wake the waiter
    ctrl = h._ctrl
    t0 = time.monotonic()
    fut = ctrl.listen_for_change.remote("lp-app", "hello", v0, 20.0)
    ray.get(ctrl.set_target.remote("lp-app", "hello", 2), timeout=30)
    version, replicas = ray.get(fut, timeout=30)
    assert version != v0
    assert len(replicas) == 2
    assert time.monotonic() - t0 < 15, "long-poll did not wake promptly"
    serve.shutdown()
