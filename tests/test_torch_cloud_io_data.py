"""Cloud-storage IO of Data: readers and writers resolve paths through
pyarrow filesystems (reference:
data/datasource/file_based_datasource.py path resolution).

The port's copy of the data cases of ``tests/test_cloud_io.py``
(``test_read_write_parquet_file_uri``, ``test_read_csv_explicit_filesystem``,
``test_read_json_text_uri``, ``test_read_binary_and_numpy``), with their
imports pointed at ``ray_tpu_torch``; the file's resolver and checkpoint
cases run on the port in ``tests/test_torch_train_checkpoint.py``."""
import os

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
def test_read_write_parquet_file_uri(ray2, tmp_path):
    ds = rdata.range(100)
    out = tmp_path / "pq"
    ds.write_parquet(f"file://{out}")
    assert len(os.listdir(out)) >= 1
    back = rdata.read_parquet(f"file://{out}")
    assert sorted(r["id"] for r in back.take_all()) == list(range(100))


def test_read_csv_explicit_filesystem(ray2, tmp_path):
    from pyarrow import fs as pafs
    sub = tmp_path / "csvroot"
    sub.mkdir()
    (sub / "x.csv").write_text("a,b\n1,2\n3,4\n")
    # SubTreeFileSystem: paths are relative to the subtree root — only
    # resolvable because the reader honors `filesystem=`
    fs_ = pafs.SubTreeFileSystem(str(sub), pafs.LocalFileSystem())
    ds = rdata.read_csv("x.csv", filesystem=fs_)
    rows = ds.take_all()
    assert [r["a"] for r in rows] == [1, 3]


@pytest.mark.slow
def test_read_json_text_uri(ray2, tmp_path):
    j = tmp_path / "x.jsonl"
    j.write_text('{"a": 1}\n{"a": 2}\n')
    rows = rdata.read_json(f"file://{j}").take_all()
    assert [r["a"] for r in rows] == [1, 2]
    t = tmp_path / "x.txt"
    t.write_text("hello\nworld\n")
    rows = rdata.read_text(f"file://{t}").take_all()
    assert [r["text"] for r in rows] == ["hello", "world"]


@pytest.mark.slow
def test_read_binary_and_numpy(ray2, tmp_path):
    (tmp_path / "a.bin").write_bytes(b"\x01\x02\x03")
    rows = rdata.read_binary_files(str(tmp_path / "a.bin")).take_all()
    assert rows[0]["bytes"] == b"\x01\x02\x03"
    assert rows[0]["path"].endswith("a.bin")

    np.save(tmp_path / "x.npy", np.arange(6).reshape(3, 2))
    ds = rdata.read_numpy(f"file://{tmp_path}/x.npy")
    assert ds.count() == 3
    got = np.stack([r["data"] for r in ds.take_all()])
    np.testing.assert_array_equal(got, np.arange(6).reshape(3, 2))
