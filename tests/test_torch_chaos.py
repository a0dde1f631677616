"""Chaos injection (reference: test_utils.py ResourceKillerActor /
RayletKiller + the release chaos suites): workloads with retries survive
randomly-timed component kills.

The port's copy of ``tests/test_chaos.py``, with its imports pointed at
``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

The killers are the port's ``ray_tpu_torch.util.chaos``, started on the
port's head.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.chaos import NodeKiller, WorkerKiller


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


@pytest.mark.slow
def test_worker_killer_tasks_survive_with_retries(ray):
    killer = WorkerKiller(kill_interval_s=0.15, max_kills=3, warmup_s=0.2)
    killer.start()
    try:
        @ray_tpu_torch.remote(max_retries=10, retry_exceptions=True)
        def slow(i):
            time.sleep(0.25)
            return i * 2

        out = ray_tpu_torch.get([slow.remote(i) for i in range(16)], timeout=240)
        assert out == [i * 2 for i in range(16)]
    finally:
        killer.stop()
    # the killer must actually have fired for this test to mean anything
    assert killer.stats()["kills"] >= 1, killer.stats()


@pytest.mark.slow
def test_worker_killer_actor_restarts(ray):
    @ray_tpu_torch.remote(max_restarts=5, max_task_retries=10)
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            time.sleep(0.1)
            return self.n

    a = Counter.remote()
    assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == 1
    killer = WorkerKiller(kill_interval_s=0.2, max_kills=2, seed=7)
    killer.start()
    try:
        for _ in range(12):
            # counts may RESET (fresh instance after restart) but every
            # call must complete — restarts + retries absorb the kills
            assert ray_tpu_torch.get(a.bump.remote(), timeout=120) >= 1
    finally:
        killer.stop()
    assert killer.stats()["kills"] >= 1, killer.stats()


def test_node_killer_requires_head():
    with pytest.raises(RuntimeError, match="head driver"):
        NodeKiller().start()
