"""Dataset tests (reference parity: python/ray/data/tests — transforms,
fusion-invisible semantics, shuffle/sort/groupby exchanges, iteration,
splits, file IO round trips).

The port's copy of ``tests/test_data.py``, with its imports pointed at
``ray_tpu_torch`` and its own ``ray_start_regular`` fixture (the port's
runtime). ``test_iter_jax_batches`` becomes ``test_iter_device_batches``:
``iter_device_batches(device="cpu")`` gives torch tensors on the host
(the card is the default device and raises without one)."""
import os

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


@pytest.fixture
def data(ray):
    from ray_tpu_torch import data as rd
    return rd


class TestBasics:
    @pytest.mark.slow
    def test_range_count_take(self, data):
        ds = data.range(100)
        assert ds.count() == 100
        assert [r["id"] for r in ds.take(5)] == [0, 1, 2, 3, 4]
        assert ds.num_blocks() > 1

    @pytest.mark.slow
    def test_from_items_schema(self, data):
        ds = data.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
        assert ds.count() == 2
        assert set(ds.schema().names) == {"a", "b"}

    @pytest.mark.slow
    def test_from_numpy_roundtrip(self, data):
        arr = np.arange(24, dtype=np.float32).reshape(6, 4)
        ds = data.from_numpy(arr)
        batches = list(ds.iter_batches(batch_size=None))
        got = np.concatenate([b["data"] for b in batches])
        np.testing.assert_array_equal(got, arr)


class TestTransforms:
    @pytest.mark.slow
    def test_map_chain_fuses_and_computes(self, data):
        ds = (data.range(50)
              .map_batches(lambda b: {"id": b["id"] * 2})
              .filter(lambda r: r["id"] % 4 == 0)
              .map(lambda r: {"v": r["id"] + 1}))
        vals = sorted(r["v"] for r in ds.take_all())
        assert vals == [i * 4 + 1 for i in range(25)]

    @pytest.mark.slow
    def test_flat_map(self, data):
        ds = data.from_items([{"x": 1}, {"x": 2}]).flat_map(
            lambda r: [{"x": r["x"]}, {"x": -r["x"]}])
        assert sorted(r["x"] for r in ds.take_all()) == [-2, -1, 1, 2]

    @pytest.mark.slow
    def test_column_ops(self, data):
        ds = data.from_items([{"a": 1, "b": 2}])
        assert ds.select_columns(["a"]).schema().names == ["a"]
        assert ds.drop_columns(["a"]).schema().names == ["b"]
        assert set(ds.rename_columns({"a": "c"}).schema().names) == \
            {"c", "b"}

    @pytest.mark.slow
    def test_limit(self, data):
        assert data.range(100).limit(7).count() == 7

    @pytest.mark.slow
    def test_union_zip(self, data):
        a = data.range(5)
        b = data.range(5)
        assert a.union(b).count() == 10
        z = a.zip(b.map_batches(lambda x: {"id2": x["id"]}))
        rows = z.take_all()
        assert all(r["id"] == r["id2"] for r in rows)


class TestExchanges:
    @pytest.mark.slow
    def test_repartition(self, data):
        ds = data.range(100).repartition(4)
        assert ds.num_blocks() == 4
        assert ds.count() == 100

    @pytest.mark.slow
    def test_random_shuffle_preserves_multiset(self, data):
        ds = data.range(60).random_shuffle(seed=7)
        vals = [r["id"] for r in ds.take_all()]
        assert sorted(vals) == list(range(60))
        assert vals != list(range(60))  # actually shuffled

    @pytest.mark.slow
    def test_sort(self, data):
        ds = data.from_items(
            [{"k": int(x)} for x in
             np.random.RandomState(0).permutation(50)])
        got = [r["k"] for r in ds.sort("k").take_all()]
        assert got == list(range(50))
        got_desc = [r["k"] for r in ds.sort("k", descending=True).take_all()]
        assert got_desc == list(range(49, -1, -1))

    @pytest.mark.slow
    def test_groupby_aggregations(self, data):
        rows = [{"g": i % 3, "v": float(i)} for i in range(30)]
        ds = data.from_items(rows)
        counts = {r["g"]: r["count()"]
                  for r in ds.groupby("g").count().take_all()}
        assert counts == {0: 10, 1: 10, 2: 10}
        sums = {r["g"]: r["sum(v)"]
                for r in ds.groupby("g").sum("v").take_all()}
        assert sums[0] == sum(float(i) for i in range(0, 30, 3))

    @pytest.mark.slow
    def test_groupby_string_keys_cross_worker(self, data):
        rows = [{"g": f"key{i % 4}", "v": 1} for i in range(40)]
        counts = {r["g"]: r["count()"] for r in
                  data.from_items(rows).groupby("g").count().take_all()}
        assert counts == {f"key{i}": 10 for i in range(4)}


class TestIterationAndSplit:
    @pytest.mark.slow
    def test_iter_batches_sizes(self, data):
        ds = data.range(100)
        sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
        assert sum(sizes) == 100
        assert sizes[:-1] == [32, 32, 32]

    @pytest.mark.slow
    def test_iter_batches_drop_last(self, data):
        sizes = [len(b["id"]) for b in
                 data.range(100).iter_batches(batch_size=32, drop_last=True)]
        assert sizes == [32, 32, 32]

    @pytest.mark.slow
    def test_streaming_split_disjoint_total(self, data):
        its = data.range(100).streaming_split(3)
        seen = []
        for it in its:
            seen.extend(r["id"] for r in it.iter_rows())
        assert sorted(seen) == list(range(100))

    @pytest.mark.slow
    def test_iter_device_batches(self, data):
        import torch
        ds = data.range(16)
        batches = list(ds.iter_device_batches(batch_size=8, device="cpu"))
        assert all(isinstance(b["id"], torch.Tensor) for b in batches)


class TestIO:
    @pytest.mark.slow
    def test_parquet_roundtrip(self, data, tmp_path):
        ds = data.range(100).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        ds.write_parquet(str(tmp_path / "pq"))
        back = data.read_parquet(str(tmp_path / "pq"))
        assert back.count() == 100
        rows = back.sort("id").take(3)
        assert [r["sq"] for r in rows] == [0, 1, 4]

    @pytest.mark.slow
    def test_csv_roundtrip(self, data, tmp_path):
        data.from_items([{"a": 1}, {"a": 2}]).write_csv(
            str(tmp_path / "csv"))
        back = data.read_csv(str(tmp_path / "csv"))
        assert sorted(r["a"] for r in back.take_all()) == [1, 2]

    @pytest.mark.slow
    def test_json_roundtrip(self, data, tmp_path):
        data.from_items([{"a": 1}, {"a": 2}]).write_json(
            str(tmp_path / "js"))
        back = data.read_json(str(tmp_path / "js"))
        assert sorted(r["a"] for r in back.take_all()) == [1, 2]

    @pytest.mark.slow
    def test_read_text(self, data, tmp_path):
        p = tmp_path / "t.txt"
        p.write_text("hello\nworld\n")
        ds = data.read_text(str(p))
        assert [r["text"] for r in ds.take_all()] == ["hello", "world"]


class TestStreamingExecutor:
    """VERDICT item 6: bounded in-flight tasks, blocks streamed to
    consumers as produced (reference: streaming_executor.py:52,
    select_operator_to_run backpressure)."""

    @pytest.mark.slow
    def test_bounded_in_flight_over_100_blocks(self, data, tmp_path):
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.dataset import Executor

        ctx = DataContext(max_tasks_in_flight=4)
        ds = data.range(1000, override_num_blocks=100).map_batches(
            lambda b: {"id": b["id"] * 2})
        ex = Executor(ctx)
        seen_rows = 0
        for ref, meta in ex.execute_streaming(ds._plan):
            seen_rows += meta.rows
            assert ex.max_in_flight_seen <= 4
        assert seen_rows == 1000
        assert ex.max_in_flight_seen == 4  # it did run ahead of the consumer

    @pytest.mark.slow
    def test_streaming_is_lazy_not_materialized(self, data, tmp_path):
        """Consuming ONE block must not have executed the whole plan:
        read tasks touch marker files; after the first pull at most
        window + 1 may have run."""
        import os
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.dataset import Executor

        marker_dir = str(tmp_path / "markers")
        os.makedirs(marker_dir, exist_ok=True)

        def make_read(i):
            def read():
                import numpy as np
                import pyarrow as pa
                open(os.path.join(marker_dir, f"r{i:03d}"), "w").close()
                return pa.table({"id": np.arange(5) + i * 5})
            return read

        from ray_tpu_torch.data.executor import Read
        from ray_tpu_torch.data.dataset import Dataset
        ds = Dataset(Read([make_read(i) for i in range(40)]),
                     DataContext(max_tasks_in_flight=3))
        gen = Executor(ds._ctx).execute_streaming(ds._plan)
        next(gen)
        executed = len(os.listdir(marker_dir))
        assert executed <= 1 + 3, f"{executed} tasks ran for one consumed block"
        # drain: everything eventually runs exactly once
        rest = list(gen)
        assert len(rest) == 39
        assert len(os.listdir(marker_dir)) == 40

    @pytest.mark.slow
    def test_streaming_split_shards_are_picklable_to_actors(self, data):
        import ray_tpu_torch as ray

        shards = data.range(60).streaming_split(2)

        @ray.remote
        class Consumer:
            def consume(self, it):
                return sorted(r["id"] for r in it.iter_rows())

        consumers = [Consumer.remote() for _ in range(2)]
        got = ray.get([c.consume.remote(s)
                       for c, s in zip(consumers, shards)], timeout=120)
        # work-stealing split: totals are exact, the per-shard cut is not
        # deterministic (a cold consumer may claim fewer blocks)
        assert sorted(got[0] + got[1]) == list(range(60))

    @pytest.mark.slow
    def test_streaming_preserves_plan_order(self, data):
        """Blocks must arrive in plan order even when completion order
        differs (zip alignment, limit, seeded shuffles depend on it)."""
        import time

        def slow_first(batch):
            # the FIRST block (ids 0..9) sleeps so later blocks finish first
            if int(batch["id"][0]) == 0:
                time.sleep(1.0)
            return batch

        ds = data.range(50, override_num_blocks=5).map_batches(slow_first)
        ids = [int(b["id"][0]) for b in ds.iter_batches(batch_size=10)]
        assert ids == [0, 10, 20, 30, 40]

    def test_streaming_split_shards_reiterable_for_epochs(self, data):
        shards = data.range(40).streaming_split(2)
        epoch1 = [sorted(r["id"] for r in s.iter_rows()) for s in shards]
        epoch2 = [sorted(r["id"] for r in s.iter_rows()) for s in shards]
        assert epoch1 == epoch2           # same blocks replayed per shard
        assert sorted(epoch1[0] + epoch1[1]) == list(range(40))

    def test_streaming_split_count_guard(self, data):
        shards = data.range(40).streaming_split(2)
        with pytest.raises(TypeError):
            shards[0].count()
        # after full iteration, count works from the cache
        n0 = sum(1 for _ in shards[0].iter_rows())
        assert shards[0].count() == n0


@pytest.mark.slow
def test_from_huggingface(ray_start_regular):
    """HF arrow tables become blocks directly (ray.data.from_huggingface)."""
    import datasets as hf

    from ray_tpu_torch import data
    hfds = hf.Dataset.from_dict(
        {"text": [f"doc {i}" for i in range(20)],
         "label": list(range(20))})
    ds = data.from_huggingface(hfds, override_num_blocks=4)
    assert ds.count() == 20
    rows = ds.filter(lambda r: r["label"] % 2 == 0).take_all()
    assert len(rows) == 10
    assert rows[0]["text"] == "doc 0"


@pytest.mark.slow
def test_streaming_backpressure_on_store_pressure(ray_start_regular):
    """Past the spill threshold the submission window shrinks
    (deterministic: pressure is injected; the probe itself is exercised
    against the real store below)."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data.executor import Executor

    ds = data.range(24, override_num_blocks=24)
    ex = Executor()
    ex._store_pressured = lambda ray: True  # constant pressure
    seen = sum(1 for _ in ex.execute_streaming(ds._plan, window=8))
    assert seen == 24
    assert ex.backpressure_events > 0
    # halved window honored
    assert ex.max_in_flight_seen <= 4, ex.max_in_flight_seen

    # un-pressured run uses the full window
    ex2 = Executor()
    seen = sum(1 for _ in ex2.execute_streaming(ds._plan, window=8))
    assert seen == 24
    assert ex2.max_in_flight_seen > 4

    # the real probe reads live store numbers without raising
    assert Executor._store_pressured(None) in (True, False)
