"""Logical plan + executor: fused block tasks over the runtime.

Reference parity: the logical/physical plan split of
python/ray/data/_internal/logical/ (LogicalPlan interfaces logical_plan.py:10)
and the streaming executor (streaming_executor.py:52). Scoped to one design
idea for round 1: every op is either

* a **block op** — pure fn(Block) -> Block. Chains of block ops FUSE into a
  single remote task per block (the reference's OperatorFusionRule,
  _internal/logical/rules/operator_fusion.py), so map/filter/flat_map
  pipelines cost one task per block; or
* an **exchange** — an all-to-all boundary (shuffle, repartition, sort,
  groupby) implemented as map-partition + reduce tasks.

Execution yields (block_ref, meta) pairs; block payloads stay in the shm
object store and stream to consumers via per-block ray.get.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np

from . import block as B
from .context import DataContext


@dataclasses.dataclass
class BlockMeta:
    rows: int
    bytes: int


class LogicalOp:
    """Node in the lazy plan DAG."""

    def __init__(self, name: str, inputs: list["LogicalOp"]):
        self.name = name
        self.inputs = inputs

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.inputs))})"


class InputData(LogicalOp):
    def __init__(self, refs_and_meta: list[tuple]):
        super().__init__("InputData", [])
        self.refs_and_meta = refs_and_meta


class Read(LogicalOp):
    """One task per read callable (reference: planner/plan_read_op.py)."""

    def __init__(self, read_tasks: list[Callable[[], B.Block]], name="Read"):
        super().__init__(name, [])
        self.read_tasks = read_tasks


class BlockOp(LogicalOp):
    """Fusable fn(Block)->Block (map_batches/map/filter/flat_map/project)."""

    def __init__(self, input_op: LogicalOp, fn: Callable[[B.Block], B.Block],
                 name: str):
        super().__init__(name, [input_op])
        self.fn = fn


class Exchange(LogicalOp):
    """All-to-all boundary. kind in {repartition, shuffle, sort, groupby,
    limit, union, zip, join}; args carried per kind."""

    def __init__(self, inputs: list[LogicalOp], kind: str, **kwargs):
        super().__init__(f"Exchange[{kind}]", inputs)
        self.kind = kind
        self.kwargs = kwargs


class ActorPoolOp(LogicalOp):
    """map_batches over a pool of stateful actors (reference:
    ActorPoolMapOperator, _internal/execution/operators/actor_map_operator.py
    + ActorPoolStrategy). The fn is a CLASS: constructed once per actor
    (model load happens once), called per batch. Breaks block-op fusion
    above it; downstream block fns ride along into the actor call.
    The pool autoscales between min_size and max_size from queue depth
    (reference: autoscaler/default_autoscaler.py try_trigger_scaling)."""

    def __init__(self, input_op: LogicalOp, fn_blob: bytes, size: int,
                 name: str, max_size: Optional[int] = None):
        super().__init__(name, [input_op])
        self.fn_blob = fn_blob      # cloudpickle((cls, args, kwargs, wrap))
        self.size = size            # initial/min pool size
        self.max_size = max_size or size


# ---------------------------------------------------------------------------
# Remote task bodies (top-level so cloudpickle ships them cheaply)
# ---------------------------------------------------------------------------

def _run_fused(fns, block):
    for fn in fns:
        block = fn(block)
    return block, BlockMeta(B.num_rows(block), B.size_bytes(block))


def _run_read(read_fn, fns):
    block = read_fn()
    return _run_fused(fns, block)


def _split_for_exchange(block, n_out, shuffle, seed):
    """Map side of an exchange: partition rows into n_out slices."""
    rows = B.num_rows(block)
    if shuffle:
        rng = np.random.RandomState(seed)
        idx = rng.permutation(rows)
        block = block.take(idx)
    # contiguous split keeps arrow slicing zero-copy
    bounds = np.linspace(0, rows, n_out + 1).astype(int)
    return tuple(B.slice_block(block, bounds[i], bounds[i + 1])
                 for i in range(n_out))


def _combine_partition(shuffle, seed, *parts):
    out = B.concat(list(parts))
    if shuffle:
        rng = np.random.RandomState(seed)
        out = out.take(rng.permutation(B.num_rows(out)))
    return out, BlockMeta(B.num_rows(out), B.size_bytes(out))


def _sort_and_partition(block, key, descending, boundaries):
    """Sort-map: locally sort, then split at the sampled boundaries."""
    order = "descending" if descending else "ascending"
    block = block.sort_by([(key, order)])
    col = B.column_to_numpy(block.column(key))
    if descending:
        cuts = len(col) - np.searchsorted(col[::-1], boundaries, side="left")
    else:
        cuts = np.searchsorted(col, boundaries, side="right")
    bounds = [0] + list(cuts) + [len(col)]
    return tuple(B.slice_block(block, bounds[i], bounds[i + 1])
                 for i in range(len(bounds) - 1))


def _merge_sorted(key, descending, *parts):
    out = B.concat(list(parts))
    order = "descending" if descending else "ascending"
    out = out.sort_by([(key, order)])
    return out, BlockMeta(B.num_rows(out), B.size_bytes(out))


def _sample_block(block, key, n):
    col = B.column_to_numpy(block.column(key))
    if len(col) == 0:
        return np.array([])
    idx = np.random.RandomState(0).randint(0, len(col), min(n, len(col)))
    return col[idx]


def _stable_hash(x) -> int:
    # Python's str hash is per-process randomized (PYTHONHASHSEED); block
    # tasks run in different workers, so partitioning must use a stable
    # hash. Numpy scalars normalize to Python values first: repr is dtype-
    # tagged (np.int64(5) vs np.int32(5)), and a join across sides with
    # different key widths must co-partition equal values.
    import zlib
    if isinstance(x, tuple):
        x = tuple(v.item() if hasattr(v, "item") else v for v in x)
    elif hasattr(x, "item"):
        x = x.item()
    return zlib.crc32(repr(x).encode())


def _hash_partition(block, key, n_out):
    if B.num_rows(block) == 0:
        empty = block
        return tuple(empty for _ in range(n_out))
    col = B.column_to_numpy(block.column(key))
    hashes = np.array([_stable_hash(x) % n_out for x in col])
    return tuple(block.take(np.nonzero(hashes == i)[0])
                 for i in range(n_out))


def _slice_task(block, start, end):
    out = B.slice_block(block, start, end)
    return out, BlockMeta(B.num_rows(out), B.size_bytes(out))


def zip_blocks(lb, rb):
    """Column-concat of two row-aligned blocks (right side wins on
    column-name collision) — THE zip merge, shared by this executor and
    the streaming zip stage so the two paths can never drift."""
    import pyarrow as pa
    cols = {**{n: lb.column(n) for n in lb.column_names},
            **{n: rb.column(n) for n in rb.column_names}}
    return pa.table(cols)


def _hash_partition_multi(block, keys, n_out):
    """Hash-partition on one or more key columns (joins, multi-key ops)."""
    if B.num_rows(block) == 0:
        return tuple(block for _ in range(n_out))
    cols = [B.column_to_numpy(block.column(k)) for k in keys]
    hashes = np.array([_stable_hash(tuple(c[i] for c in cols)) % n_out
                       for i in range(B.num_rows(block))])
    return tuple(block.take(np.nonzero(hashes == i)[0])
                 for i in range(n_out))


def _join_partition(keys, how, n_left, *parts):
    """Reduce side of a hash join: pandas merge of one co-partition."""
    import pandas as pd

    def side_df(blocks):
        df = B.concat(list(blocks)).to_pandas() if blocks else pd.DataFrame()
        if df.shape[1] == 0:
            # an empty SIDE (zero blocks / zero columns) still needs the
            # key columns for merge — and so outer joins emit the other
            # side's rows
            df = pd.DataFrame({k: pd.Series([], dtype="object")
                               for k in keys})
        return df

    ldf = side_df(parts[:n_left])
    rdf = side_df(parts[n_left:])
    out = ldf.merge(rdf, on=list(keys), how=how,
                    suffixes=("", "_right"))
    if how != "inner":
        # unmatched rows put NaN into int columns ONLY in partitions that
        # have misses — convert to pandas nullable dtypes so every
        # partition emits the same arrow schema (concat/sort need that)
        out = out.convert_dtypes()
    tbl = B.from_batch(out)
    return tbl, BlockMeta(B.num_rows(tbl), B.size_bytes(tbl))


class _ActorMapWorker:
    """Actor body for ActorPoolOp: builds the user's callable once, maps
    blocks through it (plus any fused downstream block fns) per call."""

    def __init__(self, fn_blob: bytes):
        import cloudpickle
        cls, args, kwargs, wrap = cloudpickle.loads(fn_blob)
        self._fn = cls(*args, **kwargs) if isinstance(cls, type) else cls
        self._wrap = wrap

    def map(self, fused_fns, block):
        block = self._wrap(self._fn, block)
        for fn in fused_fns:
            block = fn(block)
        return block, BlockMeta(B.num_rows(block), B.size_bytes(block))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

_DEFAULT = object()


def _ray():
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    return ray_tpu_torch


class Executor:
    """Executes a logical plan bottom-up, fusing BlockOp chains.

    Two modes:
      * `execute` — materialize every output pair (used by count/schema/
        materialize and inside exchanges, which are all-to-all barriers);
      * `execute_streaming` — a generator with BOUNDED in-flight tasks
        (ctx.max_tasks_in_flight): tasks are submitted as the consumer
        pulls, completed blocks yield as they finish, so read/map/consume
        overlap and at most `window` blocks wait in the object store
        (reference: _internal/execution/streaming_executor.py:52 +
        the memory-aware admission of streaming_executor_state.py:646).
    """

    def __init__(self, ctx: Optional[DataContext] = None):
        self.ctx = ctx or DataContext.get_current()
        # high-water mark of concurrently in-flight tasks (observable by
        # tests and stats)
        self.max_in_flight_seen = 0
        # ticks where store pressure shrank the submission window
        self.backpressure_events = 0
        # actor-pool scale up/down decisions (observable by tests/stats)
        self.autoscale_events: list[dict] = []

    @staticmethod
    def _store_pressured(ray) -> bool:
        from ..core import runtime as rt_mod
        from ..core.config import cfg
        rt = rt_mod.get_runtime_if_exists()
        store = getattr(rt, "store", None)
        if store is None:
            return False
        try:
            return (store.bytes_in_use()
                    > cfg.object_spilling_threshold * store.capacity())
        except Exception:
            return False

    def _peel(self, op: LogicalOp):
        """Split a plan top into (fused block fns, source node)."""
        chain: list[BlockOp] = []
        node = op
        while isinstance(node, BlockOp):
            chain.append(node)
            node = node.inputs[0]
        return [c.fn for c in reversed(chain)], node

    def execute(self, op: LogicalOp) -> list[tuple[Any, BlockMeta]]:
        """Returns [(block_ref, meta)] — metas are concrete. Barrier mode:
        everything is submitted at once (the results are materialized into
        a list anyway, so the streaming window would only serialize it)."""
        return list(self.execute_streaming(op, window=None))

    def execute_streaming(self, op: LogicalOp, window: int | object = _DEFAULT):
        """Yield (block_ref, meta) in PLAN ORDER as tasks finish, with at
        most `window` (default ctx.max_tasks_in_flight; None = unbounded)
        tasks in flight. Plan-order delivery keeps order-sensitive
        consumers (zip alignment, limit/take, seeded shuffles) exact while
        still overlapping read/map/consume."""
        ray = _ray()
        fused, node = self._peel(op)
        if isinstance(node, Read):
            remote_read = ray.remote(_run_read).options(num_returns=2)
            thunks = (
                (lambda rt=rt: remote_read.remote(rt, fused))
                for rt in node.read_tasks)
            yield from self._stream(thunks, window)
            return
        if isinstance(node, ActorPoolOp):
            yield from self._execute_actor_pool(node, fused, window)
            return
        if isinstance(node, InputData):
            base = node.refs_and_meta
        elif isinstance(node, Exchange):
            base = self._execute_exchange(node)   # all-to-all barrier
        else:
            raise TypeError(f"cannot execute {node!r}")
        if not fused:
            yield from base
            return
        remote_fused = ray.remote(_run_fused).options(num_returns=2)
        thunks = (
            (lambda ref=ref: remote_fused.remote(fused, ref))
            for ref, _ in base)
        yield from self._stream(thunks, window)

    def _execute_actor_pool(self, node: ActorPoolOp, fused, window):
        """Stream upstream blocks through a pool of stateful map actors,
        least-loaded dispatch, preserving plan order; the pool autoscales
        between node.size and node.max_size from queue depth inside the
        streaming loop (reference: autoscaler/default_autoscaler.py:26,
        try_trigger_scaling :50 over autoscaling_actor_pool.py metrics)."""
        ray = _ray()
        worker_cls = ray.remote(_ActorMapWorker)
        lo, hi = node.size, max(node.max_size, node.size)
        up_at = max(1, self.ctx.actor_pool_scale_up_queued)
        pool = [worker_cls.remote(node.fn_blob) for _ in range(lo)]
        RETIRED = float("inf")
        outstanding: list[float] = [0] * lo   # per-actor queued calls
        owner: dict[int, int] = {}            # submit seq -> actor index
        seq = {"n": 0}

        def active() -> list[int]:
            return [j for j, o in enumerate(outstanding) if o != RETIRED]

        def make_thunk(ref):
            def thunk():
                i = min(active(), key=outstanding.__getitem__)
                if outstanding[i] >= up_at and len(active()) < hi:
                    # every live actor is backed up: grow the pool
                    pool.append(worker_cls.remote(node.fn_blob))
                    outstanding.append(0)
                    i = len(pool) - 1
                    self.autoscale_events.append(
                        {"op": node.name, "event": "up",
                         "size": len(active())})
                k = seq["n"]
                seq["n"] += 1
                owner[k] = i
                outstanding[i] += 1
                return pool[i].map.options(num_returns=2).remote(fused, ref)
            return thunk

        try:
            upstream = self.execute_streaming(node.inputs[0], window=window)
            thunks = (make_thunk(ref) for ref, _ in upstream)
            for k, pair in enumerate(self._stream(thunks, window)):
                outstanding[owner.pop(k)] -= 1
                live = active()
                idle = [j for j in live if outstanding[j] == 0]
                if len(live) > lo and len(idle) > len(live) // 2:
                    # over half the pool idle: retire one actor down
                    # toward min (never below)
                    j = idle[-1]
                    outstanding[j] = RETIRED
                    self.autoscale_events.append(
                        {"op": node.name, "event": "down",
                         "size": len(active())})
                    try:
                        ray.kill(pool[j])
                    except Exception:
                        pass  # actor already dead
                yield pair
        finally:
            for j in active():
                try:
                    ray.kill(pool[j])
                except Exception:
                    pass  # actor already dead

    def _stream(self, thunks, window=_DEFAULT):
        """Bounded-window submission loop (the scheduling loop of the
        reference's StreamingExecutor, _scheduling_loop_step) with
        object-store backpressure: past the spill threshold, submission
        halves down to 1 in flight so consumption can drain the store
        before producers flood it (reference: the memory-aware admission
        of streaming_executor_state.py:646 select_operator_to_run)."""
        from collections import deque

        from .streaming import telemetry as tm

        ray = _ray()
        if window is _DEFAULT:
            window = max(1, self.ctx.max_tasks_in_flight)
        pending: deque = deque()         # (block_ref, meta_ref), plan order
        it = iter(thunks)
        exhausted = False
        while True:
            limit = window
            if window is not None and self._store_pressured(ray):
                limit = max(1, window // 2)
                self.backpressure_events += 1
            while not exhausted and (limit is None
                                     or len(pending) < limit):
                try:
                    thunk = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(thunk())
                # the dispatch-economy counter the streaming executor's
                # A/B reads: the task path pays one control dispatch
                # per block by construction
                tm.note_dispatches(1.0, "task")
            self.max_in_flight_seen = max(self.max_in_flight_seen,
                                          len(pending))
            if not pending:
                return
            # head-of-line: deliver strictly in plan order (later tasks
            # keep running in the window meanwhile)
            block_ref, meta_ref = pending.popleft()
            meta = ray.get(meta_ref)
            tm.note_blocks(1.0, "task")
            yield block_ref, meta

    def _resolve(self, pairs) -> list[tuple[Any, BlockMeta]]:
        ray = _ray()
        return [(block_ref, ray.get(meta_ref))
                for block_ref, meta_ref in pairs]

    # -- exchanges --------------------------------------------------------

    def _execute_exchange(self, node: Exchange):
        ray = _ray()
        kind = node.kwargs
        k = node.kind
        if k == "union":
            out = []
            for parent in node.inputs:
                out.extend(self.execute(parent))
            return out
        upstream = self.execute(node.inputs[0])
        if k == "limit":
            return self._limit(upstream, kind["n"])
        if k == "repartition" or k == "shuffle":
            shuffle = (k == "shuffle")
            n_out = kind.get("n") or max(1, len(upstream))
            seed = kind.get("seed") or 0
            split = ray.remote(_split_for_exchange).options(
                num_returns=n_out)
            parts = [split.remote(ref, n_out, shuffle, seed + i)
                     for i, (ref, _) in enumerate(upstream)]
            parts = [p if isinstance(p, list) else [p] for p in parts]
            combine = ray.remote(_combine_partition).options(num_returns=2)
            out = [combine.remote(shuffle, seed + 1000 + j,
                                  *[parts[i][j] for i in range(len(parts))])
                   for j in range(n_out)]
            return self._resolve(out)
        if k == "sort":
            return self._sort(upstream, kind["key"], kind["descending"])
        if k == "groupby":
            return self._groupby(upstream, kind["key"], kind["agg_fn"])
        if k == "zip":
            return self._zip(upstream, self.execute(node.inputs[1]))
        if k == "join":
            return self._join(upstream, self.execute(node.inputs[1]),
                              kind["on"], kind["how"],
                              kind.get("num_partitions"))
        raise ValueError(f"unknown exchange {k!r}")

    def _join(self, left, right, on, how, num_partitions=None):
        """Distributed hash join (reference: operators/join.py +
        hash_shuffle.py): both sides hash-partition on the key columns,
        co-partitions merge with pandas."""
        ray = _ray()
        keys = [on] if isinstance(on, str) else list(on)
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join how={how!r}")
        n_out = num_partitions or max(1, max(len(left), len(right)))
        part = ray.remote(_hash_partition_multi).options(num_returns=n_out)
        lparts = [part.remote(ref, keys, n_out) for ref, _ in left]
        rparts = [part.remote(ref, keys, n_out) for ref, _ in right]
        lparts = [p if isinstance(p, list) else [p] for p in lparts]
        rparts = [p if isinstance(p, list) else [p] for p in rparts]
        joiner = ray.remote(_join_partition).options(num_returns=2)
        out = []
        for j in range(n_out):
            lcol = [lparts[i][j] for i in range(len(lparts))]
            rcol = [rparts[i][j] for i in range(len(rparts))]
            out.append(joiner.remote(keys, how, len(lcol), *lcol, *rcol))
        return self._resolve(out)

    def _limit(self, upstream, n: int):
        ray = _ray()
        out, have = [], 0
        for ref, meta in upstream:
            if have >= n:
                break
            take = min(meta.rows, n - have)
            if take == meta.rows:
                out.append((ref, meta))
            else:
                sl = ray.remote(_slice_task).options(num_returns=2)
                b, m = sl.remote(ref, 0, take)
                out.append((b, ray.get(m)))
            have += take
        return out

    def _sort(self, upstream, key: str, descending: bool):
        ray = _ray()
        if not upstream:
            return upstream
        n_out = len(upstream)
        sampler = ray.remote(_sample_block)
        samples = np.concatenate(ray.get(
            [sampler.remote(ref, key, 20) for ref, _ in upstream]))
        if len(samples) == 0:
            return upstream
        qs = np.linspace(0, 100, n_out + 1)[1:-1]
        boundaries = np.percentile(samples, qs) if len(qs) else np.array([])
        if descending:
            boundaries = boundaries[::-1]
        part = ray.remote(_sort_and_partition).options(num_returns=n_out)
        parts = [part.remote(ref, key, descending, boundaries)
                 for ref, _ in upstream]
        parts = [p if isinstance(p, list) else [p] for p in parts]
        merge = ray.remote(_merge_sorted).options(num_returns=2)
        out = [merge.remote(key, descending,
                            *[parts[i][j] for i in range(len(parts))])
               for j in range(n_out)]
        return self._resolve(out)

    def _groupby(self, upstream, key: str, agg_fn):
        ray = _ray()
        n_out = max(1, len(upstream))
        part = ray.remote(_hash_partition).options(num_returns=n_out)
        parts = [part.remote(ref, key, n_out) for ref, _ in upstream]
        parts = [p if isinstance(p, list) else [p] for p in parts]

        def _agg_partition(kname, fn, *blocks):
            import pandas as pd
            df = B.concat(list(blocks)).to_pandas()
            if len(df) == 0:
                out = df
            else:
                # agg_fn returns a final frame including the key column
                out = fn(df.groupby(kname, sort=True))
            tbl = B.from_batch(out)
            return tbl, BlockMeta(B.num_rows(tbl), B.size_bytes(tbl))

        agg = ray.remote(_agg_partition).options(num_returns=2)
        out = [agg.remote(key, agg_fn,
                          *[parts[i][j] for i in range(len(parts))])
               for j in range(n_out)]
        return self._resolve(out)

    def _zip(self, left, right):
        """Align row ranges then column-concat (reference: zip operator)."""
        ray = _ray()
        lrows = sum(m.rows for _, m in left)
        rrows = sum(m.rows for _, m in right)
        if lrows != rrows:
            raise ValueError(f"zip requires equal row counts ({lrows} vs "
                             f"{rrows})")

        def _fetch_concat(*blocks):
            return B.concat(list(blocks))

        def _zip_all(lb, rb):
            tbl = zip_blocks(lb, rb)
            return tbl, BlockMeta(B.num_rows(tbl), B.size_bytes(tbl))

        cat = ray.remote(_fetch_concat)
        z = ray.remote(_zip_all).options(num_returns=2)
        lref = cat.remote(*[r for r, _ in left])
        rref = cat.remote(*[r for r, _ in right])
        b, m = z.remote(lref, rref)
        return [(b, ray.get(m))]


def iter_blocks(pairs) -> Iterator[B.Block]:
    """Stream concrete blocks in order (tasks run ahead concurrently)."""
    ray = _ray()
    for ref, _ in pairs:
        yield ray.get(ref)
