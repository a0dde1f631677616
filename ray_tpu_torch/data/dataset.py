"""Dataset: the lazy user-facing handle over a logical plan.

Reference parity: python/ray/data/dataset.py (map/map_batches/filter/
flat_map, iter_batches :4661, streaming_split :1731, groupby, sort, limit,
take, count, schema, union, zip, repartition, random_shuffle, write_*,
materialize). `iter_device_batches` is the accelerator hand-off: the
counterpart of the JAX package's `iter_jax_batches`, it copies each numpy
batch from pinned host memory onto the card (the default device) without
blocking the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from . import block as B
from .context import DataContext
from .executor import (
    BlockMeta,
    BlockOp,
    Exchange,
    Executor,
    InputData,
    LogicalOp,
    Read,
    iter_blocks,
)


class Schema:
    def __init__(self, arrow_schema):
        self._schema = arrow_schema

    @property
    def names(self) -> list[str]:
        return list(self._schema.names)

    @property
    def types(self) -> list:
        return list(self._schema.types)

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}" for n, t in
                         zip(self._schema.names, self._schema.types))
        return f"Schema({cols})"


# -- block-op builders (top-level for cheap pickling) -----------------------

def _map_batches_block(fn, batch_format, batch):
    out = fn(B.format_batch(batch, batch_format))
    return B.from_batch(out)


def _call_batch_block(batch_format, fn_instance, batch):
    """Actor-pool variant of _map_batches_block: the callable is a
    constructed instance living in the pool actor."""
    out = fn_instance(B.format_batch(batch, batch_format))
    return B.from_batch(out)


@dataclasses.dataclass
class ActorPoolStrategy:
    """compute= strategy for stateful map_batches (reference:
    ray.data.ActorPoolStrategy)."""
    size: int = 2
    min_size: Optional[int] = None   # accepted for API compat
    max_size: Optional[int] = None


def _map_rows_block(fn, batch):
    return B.from_items([fn(r) for r in B.to_rows(batch)])


def _flat_map_block(fn, batch):
    out = []
    for r in B.to_rows(batch):
        out.extend(fn(r))
    return B.from_items(out)


def _filter_block(fn, batch):
    keep = np.fromiter((bool(fn(r)) for r in B.to_rows(batch)),
                       dtype=bool, count=batch.num_rows)
    return batch.take(np.nonzero(keep)[0])


def _select_block(cols, batch):
    return batch.select(cols)


def _drop_block(cols, batch):
    return batch.drop_columns(cols)


def _rename_block(mapping, batch):
    return batch.rename_columns(
        [mapping.get(n, n) for n in batch.column_names])


def _add_column_block(name, fn, batch):
    col = fn(B.format_batch(batch, "pandas"))
    return batch.append_column(name, B.from_batch({name: np.asarray(col)})
                               .column(name))


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def _write_block(fs_, path_template, fmt, index, batch):
    # shard writes stream through the filesystem's output stream, so
    # gs://-style destinations never stage a local copy (reference:
    # file_datasink.py write path through pyarrow fs)
    import pyarrow.csv as pcsv
    import pyarrow.parquet as pq
    path = path_template.format(i=index)
    with fs_.open_output_stream(path) as f:
        if fmt == "parquet":
            pq.write_table(batch, f)
        elif fmt == "csv":
            pcsv.write_csv(batch, f)
        elif fmt == "json":
            f.write(batch.to_pandas().to_json(
                orient="records", lines=True).encode("utf-8"))
    return path


class Dataset:
    """Lazy distributed dataset (reference: dataset.py Dataset)."""

    def __init__(self, plan: LogicalOp, ctx: Optional[DataContext] = None):
        from ..core.usage import record_library_usage
        record_library_usage("data")
        self._plan = plan
        self._ctx = ctx or DataContext.get_current()
        self._cached: Optional[list[tuple[Any, BlockMeta]]] = None

    # -- transforms (lazy) ------------------------------------------------

    def _block_op(self, fn, name) -> "Dataset":
        return Dataset(BlockOp(self._plan, fn, name), self._ctx)

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    compute=None, concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    **_ignored) -> "Dataset":
        """Stateless path: fn fuses into per-block tasks. Stateful path
        (``compute=ActorPoolStrategy(size=n)`` / ``concurrency=n`` with a
        callable CLASS): the class is constructed once per pool actor —
        model weights load once, batches stream through (reference:
        ActorPoolMapOperator). ``concurrency=(min, max)`` (or an
        ActorPoolStrategy with min_size/max_size) makes the pool
        AUTOSCALING between the two from queue depth (reference:
        autoscaler/default_autoscaler.py)."""
        if compute is None and concurrency is None:
            return self._block_op(
                functools.partial(_map_batches_block, fn, batch_format),
                "MapBatches")
        import cloudpickle

        from .executor import ActorPoolOp
        if isinstance(concurrency, (tuple, list)):
            size, max_size = int(concurrency[0]), int(concurrency[1])
            if size < 1 or max_size < size:
                raise ValueError(
                    f"concurrency=(min, max) needs 1 <= min <= max, "
                    f"got {concurrency!r}")
        else:
            size = concurrency or getattr(compute, "size", None) or 2
            max_size = size
            if compute is not None and getattr(compute, "min_size", None):
                size = compute.min_size
                max_size = compute.max_size or size
        wrap = functools.partial(_call_batch_block, batch_format)
        blob = cloudpickle.dumps((fn, tuple(fn_constructor_args),
                                  fn_constructor_kwargs or {}, wrap))
        return Dataset(ActorPoolOp(self._plan, blob, int(size),
                                   "MapBatches(actors)",
                                   max_size=int(max_size)), self._ctx)

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._block_op(functools.partial(_map_rows_block, fn), "Map")

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._block_op(functools.partial(_flat_map_block, fn),
                              "FlatMap")

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._block_op(functools.partial(_filter_block, fn), "Filter")

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self._block_op(functools.partial(_select_block, cols),
                              "Select")

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self._block_op(functools.partial(_drop_block, cols), "Drop")

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        return self._block_op(functools.partial(_rename_block, mapping),
                              "Rename")

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._block_op(functools.partial(_add_column_block, name, fn),
                              "AddColumn")

    def limit(self, n: int) -> "Dataset":
        return Dataset(Exchange([self._plan], "limit", n=n), self._ctx)

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(Exchange([self._plan], "repartition", n=num_blocks),
                       self._ctx)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(Exchange([self._plan], "shuffle", n=None,
                                seed=seed or 0), self._ctx)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(Exchange([self._plan], "sort", key=key,
                                descending=descending), self._ctx)

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(Exchange([self._plan, *(o._plan for o in others)],
                                "union"), self._ctx)

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(Exchange([self._plan, other._plan], "zip"), self._ctx)

    def join(self, other: "Dataset", on, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join on key column(s) (reference:
        Dataset.join / _internal/execution/operators/join.py)."""
        return Dataset(Exchange([self._plan, other._plan], "join", on=on,
                                how=how, num_partitions=num_partitions),
                       self._ctx)

    def groupby(self, key: str) -> "GroupedData":
        from .grouped import GroupedData
        return GroupedData(self, key)

    # -- execution --------------------------------------------------------

    def _execute(self) -> list[tuple[Any, BlockMeta]]:
        if self._cached is None:
            self._cached = Executor(self._ctx).execute(self._plan)
        return self._cached

    def _stream_pairs(self):
        """(block_ref, meta) pairs for consumption: the cached list when
        materialized, otherwise the streaming executor's bounded-window
        generator (read/map/consume overlap; at most
        ctx.max_tasks_in_flight blocks in flight)."""
        if self._cached is not None:
            return self._cached
        return Executor(self._ctx).execute_streaming(self._plan)

    def _streaming_pipeline_factory(self):
        """A () -> StreamingPipeline factory when the channel-based
        streaming executor (data/streaming) should drive consumption,
        else None (task executor). "auto" engages whenever the plan is
        streamable and a cluster with a shared shm store is up —
        results are bit-identical either way, only the dispatch bill
        differs."""
        mode = getattr(self._ctx, "streaming_executor", "off")
        if mode == "off" or self._cached is not None:
            return None
        from ..core import runtime as rt_mod
        rt = rt_mod.get_runtime_if_exists()
        if getattr(rt, "store", None) is None:
            if mode == "force":
                raise RuntimeError(
                    "streaming_executor='force' needs an initialized "
                    "cluster with a shared shm object store")
            return None
        from .streaming.executor import (StreamingPipeline, compile_plan,
                                         worker_budget)
        drafts = compile_plan(self._plan, self._ctx)
        if drafts is None:
            if mode == "force":
                raise RuntimeError(
                    "streaming_executor='force': this plan has nothing "
                    "to stream (bare materialized blocks)")
            return None
        if mode != "force" and len(drafts) > worker_budget():
            # more stages than the worker pool can run concurrently
            # (a many-way zip tree on a tiny cluster): the pipeline
            # could never schedule every run_loop — use tasks instead
            return None
        ctx = self._ctx
        return lambda **kw: StreamingPipeline(drafts, ctx, **kw)

    def _stream_feed(self):
        """What iteration consumers drink from: the channel pipeline
        when streaming engages, else (ref, meta) pairs."""
        make = self._streaming_pipeline_factory()
        if make is not None:
            from .streaming.executor import PipelineFeed
            return PipelineFeed(make)
        return self._stream_pairs()

    def materialize(self) -> "Dataset":
        pairs = self._execute()
        out = Dataset(InputData(pairs), self._ctx)
        out._cached = pairs
        return out

    def count(self) -> int:
        return sum(m.rows for _, m in self._execute())

    def size_bytes(self) -> int:
        return sum(m.bytes for _, m in self._execute())

    def num_blocks(self) -> int:
        return len(self._execute())

    def schema(self) -> Optional[Schema]:
        pairs = self._execute()
        if not pairs:
            return None
        import ray_tpu_torch
        return Schema(ray_tpu_torch.get(pairs[0][0]).schema)

    def columns(self) -> list[str]:
        s = self.schema()
        return s.names if s is not None else []

    # -- column aggregates (reference: Dataset.sum/min/max/mean/std over
    # AggregateFn, data/aggregate.py — per-block partials combined
    # driver-side) ---------------------------------------------------------

    def _col_partials(self, on: str) -> list[dict]:
        import ray_tpu_torch

        def partial(blk):
            col = B.column_to_numpy(blk.column(on)).astype(np.float64)
            if len(col) == 0:
                return {"n": 0}
            m = float(col.mean())
            return {"n": len(col), "sum": float(col.sum()),
                    "min": float(col.min()), "max": float(col.max()),
                    "mean": m, "m2": float(((col - m) ** 2).sum())}

        part = ray_tpu_torch.remote(partial)
        return ray_tpu_torch.get([part.remote(ref)
                            for ref, _ in self._execute()])

    def sum(self, on: str) -> float:
        ps = [p for p in self._col_partials(on) if p["n"]]
        return sum(p["sum"] for p in ps)

    def min(self, on: str) -> float:
        ps = [p for p in self._col_partials(on) if p["n"]]
        if not ps:
            raise ValueError("min() on an empty dataset")
        return min(p["min"] for p in ps)

    def max(self, on: str) -> float:
        ps = [p for p in self._col_partials(on) if p["n"]]
        if not ps:
            raise ValueError("max() on an empty dataset")
        return max(p["max"] for p in ps)

    def mean(self, on: str) -> float:
        ps = [p for p in self._col_partials(on) if p["n"]]
        n = sum(p["n"] for p in ps)
        if n == 0:
            raise ValueError("mean() on an empty dataset")
        return sum(p["sum"] for p in ps) / n

    def std(self, on: str, ddof: int = 1) -> float:
        """Pairwise Welford merge of per-block (n, mean, M2) partials —
        numerically stable for large-magnitude columns (the naive
        sumsq - sum^2/n cancels catastrophically)."""
        import math
        ps = [p for p in self._col_partials(on) if p["n"]]
        n_tot = sum(p["n"] for p in ps)
        if n_tot <= ddof:
            raise ValueError("std() needs more rows than ddof")
        n, mean, m2 = 0.0, 0.0, 0.0
        for p in ps:
            delta = p["mean"] - mean
            tot = n + p["n"]
            mean += delta * p["n"] / tot
            m2 += p["m2"] + delta ** 2 * n * p["n"] / tot
            n = tot
        return math.sqrt(m2 / (n - ddof))

    def unique(self, column: str) -> list:
        import ray_tpu_torch

        def uniq(blk):
            return set(B.column_to_numpy(blk.column(column)).tolist())

        u = ray_tpu_torch.remote(uniq)
        out: set = set()
        for part in ray_tpu_torch.get([u.remote(ref)
                                 for ref, _ in self._execute()]):
            out |= part
        return sorted(out)

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        def sample_block(blk):
            rows = B.num_rows(blk)
            if seed is None:
                rng = np.random.RandomState()   # fresh OS entropy
            else:
                # fold block CONTENT into the seed (the block fn gets no
                # index): equal-sized blocks must not draw identical masks
                import zlib
                head = B.to_rows(B.slice_block(blk, 0, min(3, rows)))
                h = zlib.crc32(repr((rows, head)).encode())
                rng = np.random.RandomState(
                    (seed * 1_000_003 + h) % (2 ** 31))
            keep = np.nonzero(rng.random_sample(rows) < fraction)[0]
            return blk.take(keep)

        return self._block_op(sample_block, "RandomSample")

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> tuple["Dataset", "Dataset"]:
        """(train, test) row split (reference: Dataset.train_test_split)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        import ray_tpu_torch
        from .executor import _slice_task
        ds = self.random_shuffle(seed=seed) if shuffle else self
        pairs = ds._execute()
        total = sum(m.rows for _, m in pairs)
        n_test = int(round(total * test_size))
        sl = ray_tpu_torch.remote(_slice_task).options(num_returns=2)
        train_pairs, test_pairs = [], []
        seen = 0
        for ref, meta in pairs:
            cut = _clamp(n_test - seen, 0, meta.rows)  # rows going to test
            seen += meta.rows
            if cut == 0:
                train_pairs.append((ref, meta))
            elif cut == meta.rows:
                test_pairs.append((ref, meta))
            else:
                # _slice_task returns (block, real BlockMeta) — byte
                # sizes stay accurate for the boundary halves
                hb, hm = sl.remote(ref, 0, cut)
                tb, tm = sl.remote(ref, cut, meta.rows)
                test_pairs.append((hb, ray_tpu_torch.get(hm)))
                train_pairs.append((tb, ray_tpu_torch.get(tm)))
        return (Dataset(InputData(train_pairs), self._ctx),
                Dataset(InputData(test_pairs), self._ctx))

    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd
        rows = self.take(limit) if limit is not None else self.take_all()
        return pd.DataFrame(rows)

    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        for blk in DataIterator(self._stream_feed()).iter_blocks():
            for row in B.to_rows(blk):
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> list[dict]:
        return [r for blk in iter_blocks(self._execute())
                for r in B.to_rows(blk)]

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    # -- iteration --------------------------------------------------------

    def iter_rows(self) -> Iterator[dict]:
        for blk in DataIterator(self._stream_feed()).iter_blocks():
            yield from B.to_rows(blk)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator:
        return DataIterator(self._stream_feed()).iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True,
                            device="cuda") -> Iterator:
        return DataIterator(self._stream_feed()).iter_device_batches(
            batch_size=batch_size, drop_last=drop_last, device=device)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False) -> Iterator:
        return DataIterator(self._stream_feed()).iter_torch_batches(
            batch_size=batch_size, drop_last=drop_last)

    def streaming_split(self, n: int) -> list["DataIterator"]:
        """n iterators sharing ONE streaming execution, one per Train
        worker (reference: dataset.py:1731 + the output-splitter operator).
        Work-stealing split either way: with
        ``ctx.split_transport="actor"`` (default) a coordinator actor
        hands out finished blocks one dispatch at a time; with "chan"
        the streaming pipeline's sink edge fans out over n sealed-ring
        consumer slots — zero dispatches per block, blocks flow to
        whichever shard is consuming (consume shards concurrently for
        balanced cuts). Shards are picklable to workers either way and
        no one waits for the whole dataset to materialize."""
        if self._cached is not None:
            return [DataIterator(self._cached[i::n]) for i in range(n)]
        if getattr(self._ctx, "split_transport", "actor") == "chan":
            make = self._streaming_pipeline_factory()
            if make is not None:
                from .streaming.executor import ChannelShardFeed
                pipe = make(consumers=n, split=True).start()
                return [DataIterator(ChannelShardFeed(
                    pipe.sink_edge, i, pipeline=pipe)) for i in range(n)]
        import ray_tpu_torch as ray
        Coord = ray.remote(_SplitCoordinator)
        coord = Coord.remote(self._plan, self._ctx, n)
        return [DataIterator(_ActorFeed(coord)) for _ in range(n)]

    def split(self, n: int) -> list["Dataset"]:
        pairs = self._execute()
        return [Dataset(InputData(pairs[i::n]), self._ctx) for i in range(n)]

    # -- writes -----------------------------------------------------------

    def _write(self, path: str, fmt: str, ext: str,
               filesystem=None) -> list[str]:
        import posixpath

        import ray_tpu_torch
        from ..util.fs import makedirs, resolve, to_arrow
        fs_, root = resolve(path, filesystem)
        fs_ = to_arrow(fs_)
        makedirs(fs_, root)
        tmpl = posixpath.join(root.replace("\\", "/"),
                              f"part-{{i:05d}}.{ext}")
        write = ray_tpu_torch.remote(_write_block)
        refs = [write.remote(fs_, tmpl, fmt, i, ref)
                for i, (ref, _) in enumerate(self._execute())]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str, *, filesystem=None) -> list[str]:
        return self._write(path, "parquet", "parquet", filesystem)

    def write_csv(self, path: str, *, filesystem=None) -> list[str]:
        return self._write(path, "csv", "csv", filesystem)

    def write_json(self, path: str, *, filesystem=None) -> list[str]:
        return self._write(path, "json", "json", filesystem)

    def stats(self) -> str:
        pairs = self._execute()
        return (f"Dataset: {len(pairs)} blocks, {self.count()} rows, "
                f"{self.size_bytes()} bytes")

    def __repr__(self):
        return f"Dataset(plan={self._plan!r})"


class _SplitCoordinator:
    """Actor owning one streaming execution for streaming_split consumers
    (reference analog: the output-splitter coordination of
    _internal/execution/operators/output_splitter.py). Single-threaded
    actor => next() calls serialize; consumers fetch block payloads from
    the store in parallel afterwards.

    Self-terminates after every consumer has seen exhaustion, so repeated
    streaming_split calls don't accumulate idle actors."""

    def __init__(self, plan, ctx, n_consumers: int):
        self._it = Executor(ctx).execute_streaming(plan)
        self._nones_left = n_consumers

    def next(self):
        try:
            return next(self._it)
        except StopIteration:
            self._nones_left -= 1
            if self._nones_left <= 0:
                import os
                import threading
                # reply first, then exit (daemon timer outlives this call)
                threading.Timer(0.5, lambda: os._exit(0)).start()
            return None


class _ActorFeed:
    """Picklable pair-iterable backed by a _SplitCoordinator handle.

    Claimed pairs are CACHED so a shard is re-iterable (multi-epoch train
    loops replay the same blocks); only the first pass pulls from the
    coordinator."""

    def __init__(self, coord):
        self._coord = coord
        self._cache: list = []
        self._complete = False

    def __iter__(self):
        yield from self._cache
        if self._complete:
            return
        import ray_tpu_torch
        while True:
            pair = ray_tpu_torch.get(self._coord.next.remote())
            if pair is None:
                self._complete = True
                return
            self._cache.append(pair)
            yield pair


class DataIterator:
    """Streams batches from block pairs — a materialized list, a live
    task-executor generator, or a channel-pipeline feed exposing
    ``iter_blocks()`` (reference: data/iterator.py DataIterator;
    iter_torch_batches -> iter_device_batches)."""

    def __init__(self, pairs):
        self._pairs = pairs

    def _as_list(self) -> list[tuple[Any, BlockMeta]]:
        if isinstance(self._pairs, _ActorFeed) and not self._pairs._complete:
            # draining the shared coordinator here would claim every
            # remaining block for THIS shard and starve its siblings
            raise TypeError(
                "count() on an unconsumed streaming_split shard would "
                "steal the other shards' blocks; iterate it (or "
                "materialize() the dataset) first")
        if not isinstance(self._pairs, list):
            self._pairs = list(self._pairs)
        return self._pairs

    def count(self) -> int:
        if hasattr(self._pairs, "count_rows"):
            return self._pairs.count_rows()
        if hasattr(self._pairs, "iter_blocks"):
            return sum(b.num_rows for b in self._pairs.iter_blocks())
        return sum(m.rows for _, m in self._as_list())

    def iter_blocks(self) -> Iterator[B.Block]:
        if hasattr(self._pairs, "iter_blocks"):
            return self._pairs.iter_blocks()
        return iter_blocks(self._pairs)

    def iter_rows(self) -> Iterator[dict]:
        for blk in self.iter_blocks():
            yield from B.to_rows(blk)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator:
        if local_shuffle_buffer_size:
            yield from self._iter_shuffled(
                batch_size or 256, batch_format, drop_last,
                local_shuffle_buffer_size, local_shuffle_seed)
            return
        carry: Optional[B.Block] = None
        for blk in self.iter_blocks():
            if carry is not None and carry.num_rows:
                blk = B.concat([carry, blk])
                carry = None
            if batch_size is None:
                yield B.format_batch(blk, batch_format)
                continue
            start = 0
            while blk.num_rows - start >= batch_size:
                yield B.format_batch(
                    B.slice_block(blk, start, start + batch_size),
                    batch_format)
                start += batch_size
            if start < blk.num_rows:
                carry = B.slice_block(blk, start, blk.num_rows)
        if carry is not None and carry.num_rows and not drop_last:
            yield B.format_batch(carry, batch_format)

    def _iter_shuffled(self, batch_size: int, batch_format: str,
                      drop_last: bool, buf_size: int,
                      seed: Optional[int]) -> Iterator:
        """Streaming local shuffle (reference: iter_batches'
        local_shuffle_buffer_size): hold ~buf_size rows, emit each batch
        as a random draw from the buffer while the stream refills it —
        per-epoch randomization at buffer-memory cost, without a full
        distributed random_shuffle()."""
        rng = np.random.default_rng(seed)
        buf: Optional[B.Block] = None
        for blk in self.iter_blocks():
            buf = blk if buf is None else B.concat([buf, blk])
            while buf.num_rows >= buf_size + batch_size:
                pick = rng.choice(buf.num_rows, size=batch_size,
                                  replace=False)
                mask = np.ones(buf.num_rows, bool)
                mask[pick] = False
                yield B.format_batch(buf.take(pick), batch_format)
                buf = buf.take(np.nonzero(mask)[0])
        if buf is None or not buf.num_rows:
            return
        order = rng.permutation(buf.num_rows)
        start = 0
        while buf.num_rows - start >= batch_size:
            yield B.format_batch(
                buf.take(order[start:start + batch_size]), batch_format)
            start += batch_size
        if start < buf.num_rows and not drop_last:
            yield B.format_batch(buf.take(order[start:]), batch_format)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False) -> Iterator:
        """numpy batches -> torch tensors (reference:
        dataset.py:4732 iter_torch_batches; torch-cpu in this image)."""
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True,
                            device="cuda") -> Iterator:
        """numpy batches -> torch tensors on ``device`` (the card by
        default, as the TPU is the JAX package's default device). Each
        batch's host tensor is pinned and copied with ``non_blocking=True``
        on the current stream, so the next batch is assembled on the host
        while the copy runs. ``device="cpu"`` gives the tensors of
        ``iter_torch_batches``. Without a card anything but
        ``device="cpu"`` raises: there is no fall-back to the host. The
        JAX package's ``sharding=`` (a batch spread over a mesh) has no
        counterpart until the port shards data across cards."""
        import torch
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: iter_device_batches copies onto "
                "the card by default; pass device='cpu' for host tensors")
        for batch in self.iter_torch_batches(batch_size=batch_size,
                                             drop_last=drop_last):
            if dev.type == "cpu":
                yield batch
            else:
                yield {k: v.pin_memory().to(dev, non_blocking=True)
                       for k, v in batch.items()}
