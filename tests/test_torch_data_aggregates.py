"""Dataset aggregate + convenience API (reference: data/aggregate.py
sum/min/max/mean/std, Dataset.unique/random_sample/train_test_split/
to_pandas).

The port's copy of ``tests/test_data_aggregates.py``, with its imports
pointed at ``ray_tpu_torch`` (the port's runtime and data library).
"""
import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import data as rdata


@pytest.fixture
def ray2():
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2)
    yield
    ray_tpu.shutdown()


@pytest.mark.slow
def test_column_aggregates(ray2):
    ds = rdata.range(100, override_num_blocks=4)  # id: 0..99
    assert ds.sum("id") == 4950
    assert ds.min("id") == 0
    assert ds.max("id") == 99
    assert ds.mean("id") == pytest.approx(49.5)
    assert ds.std("id") == pytest.approx(np.std(np.arange(100), ddof=1))
    assert ds.columns() == ["id"]


@pytest.mark.slow
def test_unique(ray2):
    ds = rdata.from_items([{"v": i % 5} for i in range(40)])
    assert ds.unique("v") == [0, 1, 2, 3, 4]


@pytest.mark.slow
def test_random_sample(ray2):
    ds = rdata.range(2000, override_num_blocks=4)
    n = ds.random_sample(0.25, seed=0).count()
    assert 300 < n < 700  # ~500 expected
    assert ds.random_sample(0.0).count() == 0
    assert ds.random_sample(1.0).count() == 2000
    with pytest.raises(ValueError):
        ds.random_sample(1.5)


@pytest.mark.slow
def test_train_test_split(ray2):
    ds = rdata.range(100, override_num_blocks=3)
    train, test = ds.train_test_split(0.2)
    assert test.count() == 20 and train.count() == 80
    # rows partition exactly: nothing lost, nothing duplicated
    got = sorted(r["id"] for r in train.take_all() + test.take_all())
    assert got == list(range(100))
    # shuffled split still partitions
    tr2, te2 = ds.train_test_split(0.5, shuffle=True, seed=7)
    got2 = sorted(r["id"] for r in tr2.take_all() + te2.take_all())
    assert got2 == list(range(100)) and te2.count() == 50


@pytest.mark.slow
def test_to_pandas(ray2):
    df = rdata.range(10).to_pandas()
    assert list(df["id"]) == list(range(10))
    assert len(rdata.range(10).to_pandas(limit=3)) == 3
