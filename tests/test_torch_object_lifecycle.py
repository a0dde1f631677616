"""Object lifecycle: distributed refcounting + disk spilling.

Reference parity: reference_count.h:73 (free when no references),
local_object_manager.h:42 SpillObjects :112 (spill to external storage,
restore on demand). VERDICT item 9's done criteria: bounded driver state
over many tasks; a bigger-than-store object round-trips.

The port's copy of ``tests/test_object_lifecycle.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.
"""
import gc
import time

import numpy as np
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
def ray(ray_start_regular):
    return ray_start_regular


def _rt(ray):
    from ray_tpu_torch.core import runtime as rt_mod
    return rt_mod.get_runtime_if_exists()


@pytest.mark.slow
def test_directory_bounded_over_many_tasks(ray):
    """Dropping result refs must free directory entries and store objects
    (previously both grew without bound)."""
    rt = _rt(ray)

    @ray.remote
    def blob():
        return b"x" * 50_000

    ray.get([blob.remote() for _ in range(10)], timeout=60)  # warm
    gc.collect()
    time.sleep(0.5)
    dir0 = len(rt.directory)
    obj0 = rt.store.num_objects()
    for _ in range(100):
        ray.get(blob.remote(), timeout=60)
    gc.collect()
    time.sleep(1.0)
    assert len(rt.directory) <= dir0 + 10
    assert rt.store.num_objects() <= obj0 + 10


def test_put_freed_on_ref_drop(ray):
    rt = _rt(ray)
    before = rt.store.bytes_in_use()
    ref = ray.put(np.zeros(4 * 1024 * 1024, dtype=np.uint8))
    assert rt.store.bytes_in_use() >= before + 4 * 1024 * 1024
    oid = ref.id()
    del ref
    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline and rt.store.contains(oid):
        time.sleep(0.05)
    assert not rt.store.contains(oid)
    assert oid not in rt.directory


def test_ref_in_flight_to_task_stays_alive(ray):
    """Dropping the driver's last ref right after passing it to a task must
    not free the object before the task reads it (transfer pins)."""

    @ray.remote
    def consume(x, delay):
        import time as t
        t.sleep(delay)
        return int(x.sum())

    ref = ray.put(np.ones(1000, dtype=np.int64))
    out = consume.remote(ref, 1.0)
    del ref
    gc.collect()
    assert ray.get(out, timeout=60) == 1000


@pytest.mark.slow
def test_bigger_than_store_object_roundtrips(ray):
    """An object ~2x the store capacity spills to disk and reads back."""
    rt = _rt(ray)
    cap = rt.store.capacity()
    big = np.arange(2 * cap // 8, dtype=np.int64)  # ~2x capacity in bytes
    ref = ray.put(big)
    got = ray.get(ref, timeout=120)
    np.testing.assert_array_equal(got, big)


def test_worker_spills_oversized_return(ray):
    rt = _rt(ray)
    cap = rt.store.capacity()

    @ray.remote
    def make_big(n):
        return np.ones(n, dtype=np.uint8)

    n = int(cap * 1.5)
    got = ray.get(make_big.remote(n), timeout=180)
    assert got.nbytes == n and got[0] == got[-1] == 1


def test_spilled_object_restores_for_worker_consumer(ray):
    """A spilled object must be readable from a task (restore path)."""
    rt = _rt(ray)
    # spill a small object directly (simulating pressure-time spill)
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.runtime import DirEntry, SPILLED
    from ray_tpu_torch.core.ref import ObjectRef
    oid = ObjectID.from_random()
    val = {"k": np.arange(32)}
    rt.spill.spill(oid, val)
    with rt.lock:
        rt.directory[oid] = DirEntry(SPILLED)
    ref = ObjectRef(oid)

    @ray.remote
    def read(x):
        return int(x["k"].sum())

    assert ray.get(read.remote(ref), timeout=60) == int(np.arange(32).sum())


def test_nested_ref_in_stored_object_survives_reads(ray):
    """A ref reachable only through a stored object must stay alive across
    multiple reads (containment edges, not one-shot transfer pins)."""
    rt = _rt(ray)
    inner = ray.put(np.arange(64))
    inner_oid = inner.id()
    outer = ray.put([inner, "payload"])
    del inner
    gc.collect()

    @ray.remote
    def read_inner(wrapped):
        import ray_tpu_torch
        return int(ray_tpu_torch.get(wrapped[0]).sum())

    want = int(np.arange(64).sum())
    assert ray.get(read_inner.remote(outer), timeout=60) == want
    gc.collect()
    time.sleep(0.3)
    # second read after the first borrower released: still alive
    assert ray.get(read_inner.remote(outer), timeout=60) == want
    # dropping the outer frees the inner too
    del outer
    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline and rt.store.contains(inner_oid):
        time.sleep(0.05)
    assert not rt.store.contains(inner_oid)


def test_spilled_exception_converts_to_cause(ray):
    """A task error that spilled to disk must re-raise as the original
    exception type, same as the in-store path."""
    rt = _rt(ray)
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.runtime import DirEntry, SPILLED
    from ray_tpu_torch.core.ref import ObjectRef
    from ray_tpu_torch import exceptions as exc
    oid = ObjectID.from_random()
    rt.spill.spill(oid, exc.RayTaskError("boom", ValueError("bad")),
                   is_exception=True)
    with rt.lock:
        rt.directory[oid] = DirEntry(SPILLED)
    ref = ObjectRef(oid)
    with pytest.raises(ValueError):
        ray.get(ref, timeout=30)


def test_evicted_result_reconstructs_via_lineage(ray_start_regular):
    """Regression: location tracking (multihost data plane) must not make
    an evicted SHARED-store object look like a live remote copy — lineage
    re-execution has to kick in."""
    ray = ray_start_regular
    from ray_tpu_torch.core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()

    @ray.remote(max_retries=2)
    def produce():
        return list(range(500))

    ref = produce.remote()
    assert ray.get(ref, timeout=60)[-1] == 499
    # simulate LRU eviction of the sealed result
    rt.store.delete(ref.id())
    assert ray.get(ref, timeout=120)[-1] == 499  # reconstructed
