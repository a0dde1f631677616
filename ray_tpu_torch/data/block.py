"""Blocks: the unit of distributed data — pyarrow Tables in the object store.

Reference parity: python/ray/data/block.py (Block = pyarrow.Table | pandas
DataFrame; BlockAccessor). Here blocks are always Arrow tables (zero-copy
into the shm store via pickle-5 buffers) and this module is the accessor:
conversion to/from rows, numpy batches, pandas; slicing; concatenation.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

import numpy as np
import pyarrow as pa

Block = pa.Table

TENSOR_COLUMN = "data"  # default column name for tensor/ndarray datasets


def from_items(items: list) -> Block:
    """Rows of dicts -> table; scalars go into an 'item' column (reference:
    ray.data.from_items semantics)."""
    if items and isinstance(items[0], dict):
        cols: dict[str, list] = {k: [] for k in items[0]}
        for row in items:
            for k in cols:
                cols[k].append(row.get(k))
        return pa.table({k: _to_array(v) for k, v in cols.items()})
    return pa.table({"item": _to_array(list(items))})


def _to_array(values: list) -> pa.Array:
    if values and isinstance(values[0], np.ndarray):
        flat = np.stack(values)
        return _tensor_array(flat)
    return pa.array(values)


def _tensor_array(arr: np.ndarray) -> pa.Array:
    """Fixed-shape tensor column (reference: ArrowTensorArray)."""
    if arr.ndim == 1:
        return pa.array(arr)
    inner = arr.reshape(len(arr), -1)
    return pa.FixedSizeListArray.from_arrays(
        pa.array(inner.ravel()), inner.shape[1])


def from_numpy(arr: np.ndarray, column: str = TENSOR_COLUMN) -> Block:
    return pa.table({column: _tensor_array(arr)})


def column_to_numpy(col: pa.ChunkedArray | pa.Array) -> np.ndarray:
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if pa.types.is_fixed_size_list(col.type):
        width = col.type.list_size
        flat = col.flatten().to_numpy(zero_copy_only=False)
        return flat.reshape(-1, width)
    return col.to_numpy(zero_copy_only=False)


def to_numpy_batch(block: Block) -> dict[str, np.ndarray]:
    return {name: column_to_numpy(block.column(name))
            for name in block.column_names}


def to_rows(block: Block) -> Iterator[dict]:
    yield from block.to_pylist()


def num_rows(block: Block) -> int:
    return block.num_rows


def size_bytes(block: Block) -> int:
    return block.nbytes


def slice_block(block: Block, start: int, end: int) -> Block:
    return block.slice(start, end - start)


def concat(blocks: Iterable[Block]) -> Block:
    blocks = [b for b in blocks if b is not None and b.num_rows >= 0]
    if not blocks:
        return pa.table({})
    return pa.concat_tables(blocks, promote_options="default")


def from_batch(batch: Any) -> Block:
    """A user map_batches return value -> Block. Accepts dict[str, ndarray],
    pyarrow Table, pandas DataFrame, or list of row dicts."""
    import pandas as pd
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, pd.DataFrame):
        return pa.Table.from_pandas(batch, preserve_index=False)
    if isinstance(batch, dict):
        return pa.table({
            k: (_tensor_array(v) if isinstance(v, np.ndarray) and v.ndim > 1
                else pa.array(v))
            for k, v in batch.items()})
    if isinstance(batch, list):
        return from_items(batch)
    raise TypeError(
        f"map_batches must return dict/Table/DataFrame/list, got "
        f"{type(batch).__name__}")


def format_batch(block: Block, batch_format: Optional[str]):
    """(reference: batch formats of iter_batches, dataset.py:4661)"""
    if batch_format in (None, "default", "numpy"):
        return to_numpy_batch(block)
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format == "pyarrow":
        return block
    raise ValueError(f"unknown batch_format {batch_format!r}")
