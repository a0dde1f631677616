"""Dataset creation (reference parity: python/ray/data/read_api.py —
range/from_items/from_numpy/from_pandas/from_arrow and file readers; file
reads become one read task per file/fragment executed as runtime tasks)."""
from __future__ import annotations

import builtins
import functools
from typing import Optional

import numpy as np

from . import block as B
from .context import DataContext
from .dataset import Dataset
from .executor import InputData, Read


def _n_blocks(n: Optional[int]) -> int:
    return n or DataContext.get_current().read_default_num_blocks


# -- in-memory sources ------------------------------------------------------

def _range_task(start, stop):
    return B.from_batch({"id": np.arange(start, stop, dtype=np.int64)})


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    k = min(_n_blocks(override_num_blocks), max(1, n))
    bounds = np.linspace(0, n, k + 1).astype(int)
    tasks = [functools.partial(_range_task, bounds[i], bounds[i + 1])
             for i in builtins.range(k)]
    return Dataset(Read(tasks, name="ReadRange"))


def from_items(items: list, *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    k = min(_n_blocks(override_num_blocks), max(1, len(items)))
    bounds = np.linspace(0, len(items), k + 1).astype(int)
    tasks = [functools.partial(B.from_items, items[bounds[i]:bounds[i + 1]])
             for i in builtins.range(k)]
    return Dataset(Read(tasks, name="FromItems"))


def from_numpy(arr: np.ndarray, column: str = B.TENSOR_COLUMN,
               *, override_num_blocks: Optional[int] = None) -> Dataset:
    k = min(_n_blocks(override_num_blocks), max(1, len(arr)))
    chunks = np.array_split(arr, k)
    tasks = [functools.partial(B.from_numpy, c, column) for c in chunks]
    return Dataset(Read(tasks, name="FromNumpy"))


def from_pandas(df) -> Dataset:
    import pyarrow as pa
    tbl = pa.Table.from_pandas(df, preserve_index=False)
    return from_arrow(tbl)


def from_huggingface(hf_dataset, *, override_num_blocks: int | None = None
                     ) -> Dataset:
    """A huggingface ``datasets.Dataset`` -> ray_tpu_torch Dataset (reference:
    ray.data.from_huggingface). HF datasets are arrow-backed; blocks come
    straight from the underlying table, split for parallelism."""
    import ray_tpu_torch
    from .executor import BlockMeta, InputData
    if getattr(hf_dataset, "_indices", None) is not None:
        # select()/shuffle() views keep an index mapping over the raw
        # table; materialize it or we'd ship the WRONG rows
        hf_dataset = hf_dataset.flatten_indices()
    tbl = hf_dataset.data.table if hasattr(hf_dataset, "data") else None
    if tbl is None:
        raise TypeError(
            f"expected a datasets.Dataset, got {type(hf_dataset).__name__}")
    n = min(_n_blocks(override_num_blocks), max(1, tbl.num_rows))
    pairs = []
    import builtins
    step = max(1, (tbl.num_rows + n - 1) // n)  # 0-row datasets: no blocks
    for start in builtins.range(0, tbl.num_rows, step):  # range is shadowed

        # slice() is zero-copy; only the block being shipped is combined
        block = tbl.slice(start, min(step, tbl.num_rows - start))
        block = block.combine_chunks()
        ref = ray_tpu_torch.put(block)
        pairs.append((ref, BlockMeta(block.num_rows, block.nbytes)))
    return Dataset(InputData(pairs))


def from_arrow(table) -> Dataset:
    import ray_tpu_torch
    from .executor import BlockMeta
    ref = ray_tpu_torch.put(table)
    return Dataset(InputData(
        [(ref, BlockMeta(table.num_rows, table.nbytes))]))


# -- file sources -----------------------------------------------------------
#
# Paths resolve through pyarrow filesystems (util/fs.py), so every reader
# accepts local paths, globs, directories, and gs://, s3://, file:// URIs,
# or an explicit `filesystem=` (reference:
# data/datasource/file_based_datasource.py + path_util.py). The resolved
# filesystem object is pickled into each read task, so workers open the
# file on whatever store it lives on.

def _read_parquet_task(fs_, path):
    import pyarrow.parquet as pq
    return pq.read_table(path, filesystem=fs_)


def _read_csv_task(fs_, path):
    import pyarrow.csv as pcsv
    with fs_.open_input_stream(path) as f:
        return pcsv.read_csv(f)


def _read_json_task(fs_, path):
    import io

    import pandas as pd
    import pyarrow as pa
    from ..util.fs import read_bytes
    raw = read_bytes(fs_, path)
    lines = (path.endswith((".jsonl", ".ndjson"))
             or not raw.lstrip().startswith(b"["))
    df = pd.read_json(io.BytesIO(raw), lines=lines)
    return pa.Table.from_pandas(df, preserve_index=False)


def _read_text_task(fs_, path):
    from ..util.fs import read_bytes
    lines = read_bytes(fs_, path).decode("utf-8").splitlines()
    return B.from_batch({"text": lines})


def _file_dataset(paths, filesystem, task_fn, name) -> Dataset:
    from ..util.fs import expand_paths, to_arrow
    fs_, files = expand_paths(paths, filesystem)
    fs_ = to_arrow(fs_)
    return Dataset(Read([functools.partial(task_fn, fs_, f) for f in files],
                        name=name))


def read_parquet(paths, *, filesystem=None, **_ignored) -> Dataset:
    return _file_dataset(paths, filesystem, _read_parquet_task,
                         "ReadParquet")


def read_csv(paths, *, filesystem=None, **_ignored) -> Dataset:
    return _file_dataset(paths, filesystem, _read_csv_task, "ReadCSV")


def read_json(paths, *, filesystem=None, **_ignored) -> Dataset:
    return _file_dataset(paths, filesystem, _read_json_task, "ReadJSON")


def read_text(paths, *, filesystem=None, **_ignored) -> Dataset:
    return _file_dataset(paths, filesystem, _read_text_task, "ReadText")


def _read_binary_task(fs_, path):
    from ..util.fs import read_bytes
    return B.from_items([{"bytes": read_bytes(fs_, path), "path": path}])


def read_binary_files(paths, *, filesystem=None, **_ignored) -> Dataset:
    """One row per file: {bytes, path} (reference:
    data/read_api.py read_binary_files)."""
    return _file_dataset(paths, filesystem, _read_binary_task,
                         "ReadBinary")


def _read_numpy_task(fs_, path):
    import io

    import numpy as np
    from ..util.fs import read_bytes
    arr = np.load(io.BytesIO(read_bytes(fs_, path)))
    return B.from_numpy(np.asarray(arr), B.TENSOR_COLUMN)


def read_numpy(paths, *, filesystem=None, **_ignored) -> Dataset:
    """.npy files -> tensor-column rows (reference: read_numpy)."""
    return _file_dataset(paths, filesystem, _read_numpy_task, "ReadNumpy")
