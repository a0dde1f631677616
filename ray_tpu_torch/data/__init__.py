"""ray_tpu_torch.data — lazy, streaming distributed datasets.

Reference parity: python/ray/data (Dataset dataset.py, logical plans
_internal/logical/interfaces/logical_plan.py:10, streaming executor
_internal/execution/streaming_executor.py:52, read_api.py). Same shape here:
a Dataset is a lazy logical plan over blocks (pyarrow Tables in the shared
object store); execution fuses map chains into single tasks and streams
blocks through the gang (executor.py). The card-facing surface is
`iter_device_batches` (pinned host batches copied onto the card; the
JAX package's `iter_jax_batches` has it as its counterpart), and
`streaming_split(n)` shards for Train worker gangs. The package is the
port's copy of the JAX package's `data/` over the port's runtime; it
imports torch only inside `iter_torch_batches` and `iter_device_batches`.
"""
from .context import DataContext
from .dataset import ActorPoolStrategy, DataIterator, Dataset, Schema
from .read_api import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A001 — reference API name (ray.data.range)
    read_csv,
    read_json,
    read_binary_files,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "ActorPoolStrategy",
    "DataContext", "Dataset", "DataIterator", "Schema", "from_arrow",
    "from_huggingface",
    "from_items", "from_numpy", "from_pandas", "range", "read_csv",
    "read_json", "read_parquet", "read_text", "read_binary_files", "read_numpy",
]
