"""Data joins + actor-pool map tests (reference: operators/join.py,
actor_map_operator.py + ActorPoolStrategy).

The port's copy of ``tests/test_data_join_actors.py``, with its imports
pointed at ``ray_tpu_torch`` and its own ``ray_start_regular`` fixture
(the port's runtime). ``AddModel`` is made by a function, so it pickles
by value: an actor-pool worker never imports this module.
"""
import numpy as np
import pytest

import ray_tpu_torch as ray_tpu


@pytest.fixture
def ray_start_regular():
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray_tpu
    ray_tpu.shutdown()


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


def _data():
    from ray_tpu_torch import data
    return data


def test_inner_join(ray):
    data = _data()
    left = data.from_items([{"id": i, "a": i * 10} for i in range(8)])
    right = data.from_items([{"id": i, "b": i * 100} for i in range(4, 12)])
    out = left.join(right, on="id").sort("id").take_all()
    assert [r["id"] for r in out] == [4, 5, 6, 7]
    assert all(r["b"] == r["id"] * 100 and r["a"] == r["id"] * 10
               for r in out)


@pytest.mark.slow  # 5s; join machinery stays covered by test_inner_join + test_join_with_blocks
def test_left_and_outer_join(ray):
    data = _data()
    left = data.from_items([{"id": i, "a": i} for i in range(4)])
    right = data.from_items([{"id": i, "b": -i} for i in range(2, 6)])
    lj = left.join(right, on="id", how="left").sort("id").take_all()
    assert len(lj) == 4
    assert [r["id"] for r in lj] == [0, 1, 2, 3]
    oj = left.join(right, on="id", how="outer").sort("id").take_all()
    assert [r["id"] for r in oj] == [0, 1, 2, 3, 4, 5]


@pytest.mark.slow  # 5s; join machinery stays covered by test_inner_join + test_join_with_blocks
def test_multi_key_join(ray):
    data = _data()
    left = data.from_items(
        [{"x": i % 2, "y": i % 3, "v": i} for i in range(12)])
    right = data.from_items(
        [{"x": 0, "y": 0, "w": 7}, {"x": 1, "y": 2, "w": 9}])
    out = left.join(right, on=["x", "y"]).take_all()
    for r in out:
        assert (r["x"], r["y"]) in [(0, 0), (1, 2)]
    assert len(out) == 4  # ids 0,6 match (0,0); 5,11 match (1,2)


def test_join_with_blocks(ray):
    """Join across multiple blocks on each side."""
    data = _data()
    left = data.range(100).map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
    right = data.range(100).map(
        lambda r: {"id": r["id"], "cube": r["id"] ** 3})
    out = left.join(right, on="id", num_partitions=4).sort("id").take_all()
    assert len(out) == 100
    assert out[10]["sq"] == 100 and out[10]["cube"] == 1000


def _add_model():
    class AddModel:
        """Stateful callable for actor-pool map: 'loads' state once."""

        def __init__(self, delta=1000):
            self.delta = delta
            self.calls = 0

        def __call__(self, batch):
            self.calls += 1
            return {"id": batch["id"], "out": batch["id"] + self.delta}
    return AddModel


AddModel = _add_model()


@pytest.mark.slow
def test_actor_pool_map_batches(ray):
    data = _data()
    ds = data.range(64).map_batches(
        AddModel, compute=data.ActorPoolStrategy(size=2),
        fn_constructor_kwargs={"delta": 500})
    rows = ds.sort("id").take_all()
    assert len(rows) == 64
    assert rows[3]["out"] == 503


@pytest.mark.slow
def test_actor_pool_concurrency_kwarg(ray):
    data = _data()
    ds = data.range(32).map_batches(AddModel, concurrency=2)
    rows = ds.sort("id").take_all()
    assert rows[0]["out"] == 1000


@pytest.mark.slow
def test_actor_pool_then_block_ops_fuse(ray):
    """Block ops after the actor stage ride into the actor calls."""
    data = _data()
    ds = (data.range(20)
          .map_batches(AddModel, concurrency=2)
          .filter(lambda r: r["out"] % 2 == 0)
          .map(lambda r: {"v": r["out"] * 2}))
    rows = sorted(r["v"] for r in ds.take_all())
    assert rows == [2 * v for v in range(1000, 1020, 2)]


@pytest.mark.slow  # 3.5s dtype variant of the joins kept in tier-1
def test_join_mixed_key_dtypes(ray):
    """int32 vs int64 key columns must co-partition equal values."""
    import pandas as pd
    data = _data()
    left = data.from_pandas(pd.DataFrame(
        {"id": np.arange(20, dtype=np.int64), "a": np.arange(20)}))
    right = data.from_pandas(pd.DataFrame(
        {"id": np.arange(10, 30, dtype=np.int32),
         "b": np.arange(10, 30)}))
    out = left.join(right, on="id", num_partitions=4).sort("id").take_all()
    assert [r["id"] for r in out] == list(range(10, 20)), out
