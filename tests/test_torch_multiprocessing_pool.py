"""multiprocessing.Pool-compatible pool over cluster tasks (reference:
python/ray/util/multiprocessing/pool.py).

The port's copy of ``tests/test_multiprocessing_pool.py``, with its
imports pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

The module-level functions (``_sq``, ``_add``, ``_set_env``,
``_read_env``) reach the pool's workers by reference, so those workers
import this module: it imports only pytest and the port, never JAX or
the reference package.
"""
import pytest

from ray_tpu_torch.util.multiprocessing import Pool


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


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


@pytest.mark.slow
def test_map_and_chunking(ray):
    with Pool(processes=2) as p:
        assert p.map(_sq, range(50)) == [i * i for i in range(50)]
        assert p.map(_sq, range(7), chunksize=3) == [i * i
                                                     for i in range(7)]


@pytest.mark.slow
def test_starmap_apply_async(ray):
    with Pool(processes=2) as p:
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        r = p.apply_async(_add, (10, 5))
        assert r.get(timeout=60) == 15
        assert p.apply(_add, (2, 2)) == 4


@pytest.mark.slow
def test_imap_orders_and_unordered_completes(ray):
    with Pool(processes=2) as p:
        assert list(p.imap(_sq, range(10), chunksize=2)) == \
            [i * i for i in range(10)]
        assert sorted(p.imap_unordered(_sq, range(10), chunksize=2)) == \
            sorted(i * i for i in range(10))


def _set_env(k, v):
    import os
    os.environ[k] = v


def _read_env(_):
    import os
    return os.environ.get("_POOL_INIT")


def test_initializer_and_closed_pool(ray):
    with Pool(processes=1, initializer=_set_env,
              initargs=("_POOL_INIT", "1")) as p:
        assert p.map(_read_env, [0]) == ["1"]
    with pytest.raises(ValueError):
        p.map(_sq, [1])


@pytest.mark.slow
def test_close_join_drains_outstanding(ray):
    import time

    def slowmul(x):
        time.sleep(0.2)
        return x * 3

    p = Pool(processes=2)
    r = p.map_async(slowmul, range(6), chunksize=3)
    p.close()
    p.join()                       # must block until the chunks finish
    assert r.ready()
    assert r.get(timeout=5) == [i * 3 for i in range(6)]
